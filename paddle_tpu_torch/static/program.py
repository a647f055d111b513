"""Programs as data (port of ``paddle_tpu/static/program.py``).

Parity: reference Program IR (``framework.proto`` ProgramDesc/BlockDesc/
OpDesc, ``python/paddle/fluid/framework.py`` Program/Block/Operator). The
reference's program is a traced jaxpr; the port's is an FX graph of ATen
ops that ``make_fx`` traces on fake tensors. ``Program`` exposes it through
the reference's introspection surface (``program.blocks``, ``block.ops``,
``op.type``/``input_names``/``output_names``, ``block.vars``); the blocks
after the first are the subgraphs of ``torch.cond`` and
``torch.while_loop``. Op types are ATen's (``aten.addmm.default``), not
JAX primitives.

A ``Program`` from ``from_callable`` keeps its capture (the function over
feeds then parameters, the example feeds, the parameters), and the
reference's transforms re-trace it: ``clone``, ``prune`` (then dead-code
elimination), ``rebind_feeds``, ``append_backward`` (loss and parameter
gradients through ``torch.autograd.grad``, traced into the same graph) and
``gradients``; ``run`` executes the graph.

``TrainableProgram`` is the ``.pdtrain`` companion of ``jit.save`` reloaded
with the parameters as program inputs: forward, ``append_backward(loss_fn)``,
``gradients``, plain-SGD ``train_step`` (``p - lr * g``) and ``state_dict``.
"""
from __future__ import annotations

import contextlib
import operator
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.place import resolve_device


class OpDesc:
    """One operator application (reference framework.proto OpDesc)."""

    def __init__(self, node):
        self.type = str(node.target)
        self.input_names = [a.name for a in node.all_input_nodes]
        self.output_names = [node.name]
        self.attrs = {k: v for k, v in node.kwargs.items()
                      if isinstance(v, (int, float, str, bool, tuple))}

    def __repr__(self):
        return (f"{{Op: {self.type}({', '.join(self.input_names)}) -> "
                f"({', '.join(self.output_names)})}}")


class VarDesc:
    def __init__(self, name, val):
        self.name = name
        self.shape = list(getattr(val, "shape", ()))
        self.dtype = getattr(val, "dtype", None)

    def __repr__(self):
        return f"{{Var {self.name}: {self.dtype} {self.shape}}}"


def _is_op(node) -> bool:
    """An operator node: a call, not the tuple indexing after one."""
    return node.op == "call_function" and node.target is not operator.getitem


class Block:
    """Reference BlockDesc: the op list and var table of one graph."""

    def __init__(self, graph, idx=0):
        self.idx = idx
        self.ops: List[OpDesc] = [OpDesc(n) for n in graph.nodes
                                  if _is_op(n)]
        self.vars: Dict[str, VarDesc] = {
            n.name: VarDesc(n.name, n.meta.get("val"))
            for n in graph.nodes
            if n.op == "placeholder" or _is_op(n)}

    def all_op_types(self):
        return [op.type for op in self.ops]


def _subgraphs(gm):
    """The graph modules a graph's ``get_attr`` nodes name (the branches
    of ``cond``, the condition and body of ``while_loop``), depth first."""
    out = []
    for n in gm.graph.nodes:
        if n.op == "get_attr":
            sub = getattr(gm, n.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                out.append(sub)
                out.extend(_subgraphs(sub))
    return out


def _as_feed(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _examples(input_specs, device):
    """A tensor per spec: an ``InputSpec`` as zeros with free dims at 1; a
    tensor or an array as it is."""
    from .input import InputSpec

    out = []
    for s in input_specs:
        if isinstance(s, InputSpec):
            shape = tuple(1 if d is None or d == -1 else int(d)
                          for d in s.shape)
            out.append(torch.zeros(shape, dtype=s.dtype, device=device))
        else:
            out.append(_as_feed(s, device))
    return out


class _PlainParams(torch.overrides.TorchFunctionMode):
    """Hands a ``Parameter`` subclass (the port's ``Parameter``) to each op
    as a plain tensor on the same storage: fake-tensor tracing takes a
    real plain tensor as a constant, and refuses a subclass."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        def plain(x):
            if isinstance(x, torch.nn.Parameter) \
                    and type(x) is not torch.nn.Parameter:
                return x.as_subclass(torch.Tensor)
            return x

        args, kwargs = pytree.tree_map(plain, (args, kwargs or {}))
        return func(*args, **kwargs)


def _trace(fn, feeds, params):
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..jit import _traced

    # tensors the function closes over (a layer not named as the program's)
    # are constants of the graph
    trace = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)
    with torch.no_grad(), _PlainParams():
        return _traced(lambda: trace(*feeds, *params))


def _outs(out):
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _param_grads(loss, ps, names):
    """d loss / d ps; a parameter the loss does not reach raises, naming
    it (the reference's ``jax.grad`` would give it zeros, which would also
    hide a parameter cut off from the graph)."""
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    missing = [n for n, g in zip(names, grads) if g is None]
    if missing:
        raise ValueError(f"the loss does not depend on parameter(s) "
                         f"{missing}: no gradient reaches them")
    return list(grads)


class Program:
    """Reference Program over a traced FX graph of ATen ops. ``capture`` is
    (pure, example feeds, parameters) with ``pure(*feeds, *params)``."""

    def __init__(self, gm, capture=None):
        self._gm = gm
        self._capture = capture
        self.blocks = [Block(gm.graph, 0)] + [
            Block(sub.graph, i + 1) for i, sub in enumerate(_subgraphs(gm))]

    @property
    def graph_module(self):
        return self._gm

    def global_block(self) -> Block:
        return self.blocks[0]

    def num_ops(self):
        return sum(len(b.ops) for b in self.blocks)

    def __repr__(self):
        types = self.global_block().all_op_types()
        return (f"{{Program: {len(self.blocks)} block(s), {self.num_ops()} "
                f"ops; main: {', '.join(types[:12])}"
                + ("…" if len(types) > 12 else "") + "}")

    # -- transforms (capture-level re-traces) ------------------------------
    def _require_capture(self):
        if self._capture is None:
            raise ValueError("this Program is a bare graph view; transforms "
                             "need a capture-level Program (build it with "
                             "Program.from_callable)")
        return self._capture

    @property
    def num_outputs(self):
        out = next(n for n in self._gm.graph.nodes if n.op == "output")
        res = out.args[0]
        return len(res) if isinstance(res, (list, tuple)) else 1

    def _retrace(self, pure, feeds=None):
        _, shapes, params = self._require_capture()
        feeds = shapes if feeds is None else feeds
        return Program(_trace(pure, feeds, params),
                       capture=(pure, feeds, params))

    def clone(self, for_test: bool = True) -> "Program":
        """Re-trace the capture into an independent Program (reference
        Program.clone; for_test has no effect: the capture is traced without
        grad)."""
        return self._retrace(self._require_capture()[0])

    def prune(self, targets) -> "Program":
        """Keep only the outputs in ``targets`` (indices); dead ops are
        eliminated (reference Program._prune)."""
        pure = self._require_capture()[0]
        idx = [targets] if isinstance(targets, int) else list(targets)

        def pruned(*arrays):
            outs = _outs(pure(*arrays))
            return tuple(outs[i] for i in idx)

        prog = self._retrace(pruned)
        prog._gm.graph.eliminate_dead_code()
        prog._gm.recompile()
        return Program(prog._gm, prog._capture)

    def rebind_feeds(self, input_specs) -> "Program":
        """Re-trace at new feed shapes/dtypes (same ops, new feed
        binding)."""
        pure, shapes, _ = self._require_capture()
        device = shapes[0].device if shapes else resolve_device(None)
        return self._retrace(pure, _examples(input_specs, device))

    def append_backward(self, loss_index: int = 0) -> "Program":
        """New Program computing (loss, *param_grads): the reference's
        ``append_backward(loss)`` (backward.py:1413), with the backward
        traced into the graph."""
        pure, shapes, _ = self._require_capture()
        n_feed = len(shapes)

        def with_grads(*arrays):
            feeds = arrays[:n_feed]
            with torch.enable_grad():
                ps = [p.detach().requires_grad_() for p in arrays[n_feed:]]
                loss = _outs(pure(*feeds, *ps))[loss_index]
                grads = _param_grads(loss, ps, [f"param {i}"
                                                for i in range(len(ps))])
            return (loss.detach(), *grads)

        return self._retrace(with_grads)

    def gradients(self, target_index: int = 0, input_indices=None
                  ) -> "Program":
        """Gradients of output ``target_index`` with respect to the given
        FEED indices (all feeds by default): reference ``gradients(targets,
        inputs)`` (backward.py:2010)."""
        pure, shapes, _ = self._require_capture()
        n_feed = len(shapes)
        wrt = list(range(n_feed)) if input_indices is None else (
            [input_indices] if isinstance(input_indices, int)
            else list(input_indices))

        def grad_fn(*arrays):
            feeds, ps = list(arrays[:n_feed]), list(arrays[n_feed:])
            with torch.enable_grad():
                for i in wrt:
                    feeds[i] = feeds[i].detach().requires_grad_()
                out = _outs(pure(*feeds, *ps))[target_index]
                return tuple(torch.autograd.grad(
                    out.sum(), [feeds[i] for i in wrt]))

        return self._retrace(grad_fn)

    def run(self, *feeds):
        """Execute the graph on the feeds (parameters bound as captured)."""
        _, shapes, params = self._require_capture()
        device = shapes[0].device if shapes else resolve_device(None)
        with torch.no_grad():
            outs = self._gm(*[_as_feed(f, device) for f in feeds], *params)
        return list(_outs(outs))

    # -- construction ------------------------------------------------------
    @staticmethod
    def load(path_prefix: str) -> "TrainableProgram":
        """Load a saved inference artifact as a trainable program."""
        return TrainableProgram.load(path_prefix)

    @staticmethod
    def from_callable(fn, input_specs: Sequence[Any], layer=None,
                      device=None) -> "Program":
        """Trace ``fn(*tensors)`` (a layer or a function over tensors) at
        the given InputSpecs/example tensors (``None`` dims at 1) and
        return its Program; ``layer``'s parameters are program inputs after
        the feeds."""
        from torch.nn.utils.stateless import _reparametrize_module

        if layer is None and isinstance(fn, torch.nn.Module):
            layer = fn
        named = list(layer.named_parameters()) if layer is not None else []
        names = [n for n, _ in named]
        params = [p.detach() for _, p in named]
        if device is None:
            device = params[0].device if params else resolve_device(None)
        feeds = _examples(input_specs, device)
        n_feed = len(feeds)

        def pure(*arrays):
            feed, ps = arrays[:n_feed], arrays[n_feed:]
            ctx = _reparametrize_module(layer, dict(zip(names, ps))) \
                if names else contextlib.nullcontext()
            with ctx:
                return _outs(fn(*feed))

        return Program(_trace(pure, feeds, params),
                       capture=(pure, feeds, params))


class TrainableProgram:
    """A ``jit.save``d artifact reloaded with the parameters as program
    inputs (the ``.pdtrain`` companion), so the reference's load → append
    loss and gradients → train workflow (``backward.py:1413`` on a loaded
    ProgramDesc) runs without the Python model. Gradients flow through the
    exported graph by PyTorch's autograd (the flash operators' included);
    buffers are baked eval-mode constants."""

    def __init__(self, module, param_names, params, state, device):
        self._module = module
        self.param_names = param_names
        self._params = params  # aligned with param_names, on device
        self._state = state
        self.device = device
        self._loss_fn = None

    @staticmethod
    def load(path_prefix: str, device=None) -> "TrainableProgram":
        import json

        from ..framework.io import load as fload
        from ..jit import read_program

        device = resolve_device(device)
        ep, meta = read_program(path_prefix + ".pdtrain", device)
        with open(path_prefix + ".pdtrain.json") as f:
            param_names = json.load(f)["param_names"]
        state = fload(path_prefix + ".pdiparams", device=device)["state"]
        params = [state[n].detach() for n in param_names]
        return TrainableProgram(ep.module(), param_names, params, state,
                                device)

    def _run(self, params, feeds):
        return list(_outs(self._module(
            params, [_as_feed(f, self.device) for f in feeds])))

    def __call__(self, *feeds):
        with torch.no_grad():
            return self._run(self._params, feeds)

    def append_backward(self, loss_fn):
        """Attach ``loss_fn(outputs, *labels) -> scalar`` for
        ``gradients`` and ``train_step``."""
        self._loss_fn = loss_fn
        return self

    def _loss_and_grads(self, feeds, labels):
        if self._loss_fn is None:
            raise ValueError("call append_backward(loss_fn) first")
        ps = [p.detach().requires_grad_() for p in self._params]
        with torch.enable_grad():
            outs = self._run(ps, feeds)
            loss = self._loss_fn(outs, *[_as_feed(l, self.device)
                                         for l in labels])
            grads = _param_grads(loss, ps, self.param_names)
        return loss.detach(), grads

    def gradients(self, feeds, labels):
        """(loss, {param_name: grad}) at the current parameters."""
        loss, grads = self._loss_and_grads(feeds, labels)
        return loss, dict(zip(self.param_names, grads))

    def train_step(self, feeds, labels, lr=0.01):
        """One SGD step (``p - lr * g``) on the loaded program; the held
        parameters are replaced."""
        loss, grads = self._loss_and_grads(feeds, labels)
        with torch.no_grad():
            self._params = [p - lr * g for p, g in zip(self._params, grads)]
        return loss

    def state_dict(self):
        """The full state with the trained parameter values folded in."""
        out = dict(self._state)
        out.update(zip(self.param_names, self._params))
        return out
