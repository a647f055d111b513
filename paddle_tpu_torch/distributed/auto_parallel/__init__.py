"""Semi-automatic parallelization: annotation completion, plan search and
the engine (port of ``paddle_tpu/distributed/auto_parallel/__init__.py``).

The plan side is the reference's, name for name: a plan pins each
parameter's placement (``{name: PartitionSpec or None}``),
``derive_candidate_plans`` proposes ``megatron`` (a structure-aware column
-> row pairing per parent module, the tables over the vocabulary),
``replicated`` and ``embedding-only`` with the user's annotations
(``p.pspec``, or ``shard_tensor`` on a parameter) laid over each, and
``complete_annotations`` applies the Megatron plan.

The reference lets GSPMD insert the collectives a plan needs. The port
runs one process a rank, so :func:`realise` cuts the parameters and wires
the collectives itself, module by module:

* a ``ColumnParallelLinear`` / ``RowParallelLinear`` pair of one parent
  (built at one rank: the port's models are made of them) placed
  ``P(None, mp)`` (and a ``P(mp)`` bias) then ``P(mp, None)`` becomes the
  tensor-parallel pair over the mp group, the column layer cut by its
  ``mp_layout`` (a fused q|k|v part by part, so each rank keeps whole
  heads); either one alone gathers its output or splits its input;
* a ``VocabParallelEmbedding`` table placed ``P(mp, None)`` becomes
  vocabulary-parallel, and GPT's tied head then runs the vocab-parallel
  fused cross-entropy;
* a plain ``nn.Linear`` placed ``P(None, mp)`` gathers its output, one
  placed ``P(mp, None)`` splits its input and all-reduces;
* any other placement is kept as this rank's slice at rest and gathered
  for each call through the model (``_GatherParam``: an all-gather in the
  forward, and the mean of the gradient over the group, reduce-scattered,
  in the backward).

So every placement over the plan's axis computes the same function.
Placements over another mesh axis are not realised (they raise): a
parameter sharded over a batch axis is ZeRO-3, ``group_sharded_parallel``.

The cost is the step the plan runs, not a compiler's estimate:
:func:`select_plan` realises each candidate, runs one forward and backward
with the gradient sync (no update; the RNG stream and the parameters are
restored), and :func:`plan_cost` scores what it saw: the FLOPs from
``torch.utils.flop_counter.FlopCounterMode`` plus the hand-written flash
kernels' own tally (``ops.kernels.flash_attention.flops``), the bytes and
counts of the collectives the step launched (``collective.record``), the
bytes every aten op of the step reads and writes (the eager counterpart of
XLA's "bytes accessed"; a hand-written kernel's own reads are not seen),
and the peak from the caching allocator on the card (on the CPU, this
rank's parameter, gradient and optimizer-state bytes). The time proxy uses
the NVIDIA H100 80GB HBM3's peaks (989 TFLOP/s bf16 dense, 3.35 TB/s HBM,
450 GB/s a direction on NVLink); only their ratios rank plans, as in the
reference. ``select_plan`` keeps the reference's score
``(over_budget, time, comm_bytes)``.

:class:`Engine` builds ``HybridParallelEngine`` over the realised model
(``fleet.init`` is called from the mesh's degrees when the job has no
topology yet), with the model's calls inside the gather scope.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from ..mesh import global_mesh
from ..sharding_api import PartitionSpec, PartitionSpec as P, reshard

__all__ = [
    "Engine", "ShardingPlan", "analyze_collectives", "complete_annotations",
    "derive_candidate_plans", "estimate_cost", "plan_cost", "reshard",
    "select_plan", "realise", "PartitionSpec",
]


def _axis_size(mesh, name):
    return int(mesh.shape.get(name, 1))


# -- sharding plans ----------------------------------------------------------
class ShardingPlan:
    """A complete parameter placement: ``{param_name: PartitionSpec|None}``
    (the reference's per-op dist-attr assignment, pinned on the
    parameters)."""

    def __init__(self, name: str, param_specs: dict):
        self.name = name
        self.param_specs = dict(param_specs)
        self.score = None  # filled by select_plan
        self.report = None

    def apply(self, model):
        for pname, p in model.named_parameters():
            if getattr(p, "pspec", None) is not None and pname not in self.param_specs:
                continue  # keep user annotations not covered by the plan
            p.pspec = self.param_specs.get(pname)
        return model

    def __repr__(self):
        n = sum(1 for s in self.param_specs.values() if s is not None)
        return f"ShardingPlan({self.name!r}, {n} sharded params, score={self.score})"


# Name hints for the Megatron pairing; the column hints include the full
# HF/Llama forms (gate_proj/up_proj), which must win before the generic
# 'proj' row hint matches them.
_COL_HINTS = ("qkv", "q_proj", "k_proj", "v_proj", "query", "key", "value",
              "up", "up_proj", "gate", "gate_proj", "fc1", "w1", "wi",
              "in_proj")
_ROW_HINTS = ("down", "down_proj", "o_proj", "out_proj", "fc2", "w2", "wo",
              "proj", "dense")


def _classify(name: str):
    last = name.split(".")[-2] if name.endswith((".weight", ".bias")) else name
    last = last.lower()
    if any(h == last or last.endswith("_" + h) or last.endswith("." + h) for h in _COL_HINTS):
        return "col"
    if any(h == last or last.endswith("_" + h) or last.endswith("." + h) for h in _ROW_HINTS):
        return "row"
    return None


def _is_table(shape, mp):
    # vocab/position table: tall (>= 4x) AND table-sized — the row floor
    # keeps small tall Linears (e.g. 64x16) out of the branch
    return (len(shape) == 2 and shape[0] >= 4 * shape[1] and shape[0] >= 256
            and shape[0] % mp == 0)


def _megatron_specs(model, mp: int, mp_axis: str) -> dict:
    """Structure-aware Megatron placement. Per PARENT module, 2-D weights
    pair up column -> row in order (interleaved 1-D parameters or sibling
    modules cannot desynchronize the pairing); name hints win over
    position."""
    specs = {}
    shapes = {}
    by_parent: dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        shapes[name] = shape
        if _is_table(shape, mp):
            specs[name] = P(mp_axis, None)
            continue
        if len(shape) != 2:
            specs[name] = None
            continue
        parent = name.rsplit(".", 2)[0] if name.count(".") >= 2 else ""
        by_parent.setdefault(parent, []).append((name, shape))
    for parent, entries in by_parent.items():
        # hint-classified weights shard unconditionally; unclassified ones
        # pair column -> row only when the parent holds an even number of
        # them (a lone weight sharded one way would force a gather with no
        # partner: replicate it)
        unclassified = [n for n, _ in entries if _classify(n) is None]
        pair_ok = len(unclassified) >= 2 and len(unclassified) % 2 == 0
        flip = 0
        for name, shape in entries:
            kind = _classify(name)
            if kind is None:
                if not pair_ok:
                    specs[name] = None
                    continue
                kind = "col" if flip % 2 == 0 else "row"
                flip += 1
            if kind == "col" and shape[1] % mp == 0:
                specs[name] = P(None, mp_axis)
                # Megatron pairs the column weight with a sharded bias
                bias = name[: -len("weight")] + "bias" if name.endswith(".weight") else None
                if bias in shapes and len(shapes[bias]) == 1 and shapes[bias][0] % mp == 0:
                    specs[bias] = P(mp_axis)
            elif shape[0] % mp == 0:
                specs[name] = P(mp_axis, None)
            else:
                specs[name] = None
    return specs


def _user_specs(model) -> dict:
    return {n: p.pspec for n, p in model.named_parameters()
            if getattr(p, "pspec", None) is not None}


def derive_candidate_plans(model, mesh=None, mp_axis="mp", dp_axis="dp"):
    """Candidate placements for an unannotated model, in preference order;
    ``select_plan`` scores them on the step each one runs. The user's
    annotations overlay every candidate (constraints on the search)."""
    mesh = mesh or global_mesh()
    mp = _axis_size(mesh, mp_axis)
    names = [n for n, _ in model.named_parameters()]
    user = _user_specs(model)

    def with_user(specs):
        specs = dict(specs)
        specs.update(user)
        return specs

    plans = [ShardingPlan("replicated", with_user({n: None for n in names}))]
    if mp > 1:
        plans.insert(0, ShardingPlan(
            "megatron", with_user(_megatron_specs(model, mp, mp_axis))))
        # embedding-only: shard just the big tables (bandwidth-bound models)
        emb = {n: P(mp_axis, None) if _is_table(tuple(p.shape), mp) else None
               for n, p in model.named_parameters()}
        if any(s is not None for s in emb.values()):
            plans.append(ShardingPlan("embedding-only", with_user(emb)))
    return plans


def complete_annotations(model, mesh=None, mp_axis="mp", dp_axis="dp"):
    """Give every unannotated parameter a placement: the Megatron plan with
    the user's annotations winning (the reference's completion pass).
    ``Engine.auto_parallelize`` scores the candidates instead."""
    mesh = mesh or global_mesh()
    mp = _axis_size(mesh, mp_axis)
    if mp <= 1:
        return model
    user = _user_specs(model)
    specs = _megatron_specs(model, mp, mp_axis)
    specs.update(user)  # user annotations always win
    ShardingPlan("megatron", specs).apply(model)
    return model


# -- realising a placement ---------------------------------------------------
def _norm(spec, ndim):
    """A placement as a full-length tuple; None and all-None mean
    replicated (returned as None)."""
    if spec is None:
        return None
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return None if all(e is None for e in spec) else spec


def _group_of(mesh, axis):
    """The group over mesh axis ``axis``: fleet's mp group when the
    topology matches the mesh, else the mesh's own group over the axis."""
    from ..engine import fused_group
    from ..fleet.base.fleet_base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    if axis == "mp" and hcg is not None \
            and hcg.mesh.shape.get("mp", 1) == _axis_size(mesh, "mp"):
        return hcg.get_model_parallel_group()
    return fused_group(mesh, [axis])


class _Realised:
    """What :func:`realise` changed, to undo it (``undo``) and to run the
    model with the gathered parameters in place (``gathered``)."""

    def __init__(self, group):
        self.group = group
        self.layers = []   # (module, saved attributes)
        self.params = []   # (parameter, full data)
        self.gather = []   # (module, name, parameter, dim)
        self.swapped = []  # (module, forward) of plain Linears
        self._depth = 0

    def cut(self, p, layout=None, dim=None):
        from ..fleet.meta_parallel.mp_layers import shard_of

        g = self.group
        full = p.data
        with torch.no_grad():
            if layout is not None:
                part = shard_of(full, layout, g.rank, g.nranks)
            else:
                size = full.shape[dim] // g.nranks
                part = full.narrow(dim, g.rank * size, size)
            p.data = part.contiguous().clone()
        self.params.append((p, full, getattr(p, "mp_distributed", None),
                            getattr(p, "mp_group", None)))
        p.mp_distributed = True
        p.mp_group = g

    def keep(self, mod, **attrs):
        self.layers.append((mod, {k: getattr(mod, k) for k in attrs}))
        for k, v in attrs.items():
            setattr(mod, k, v)

    def undo(self):
        """Put every parameter back whole and every layer as it was."""
        for mod, saved in reversed(self.layers):
            for k, v in saved.items():
                setattr(mod, k, v)
        for p, full, dist_flag, group in reversed(self.params):
            p.data = full
            if dist_flag is None:
                for k in ("mp_distributed", "mp_group"):
                    p.__dict__.pop(k, None)
            else:
                p.mp_distributed, p.mp_group = dist_flag, group
        for mod, fwd in self.swapped:
            if fwd is None:
                mod.__dict__.pop("forward", None)
            else:
                mod.forward = fwd
        self.layers, self.params, self.gather, self.swapped = [], [], [], []

    @contextlib.contextmanager
    def gathered(self):
        """The gather-path parameters whole for the block (nested scopes
        gather once)."""
        if not self.gather or self._depth:
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
            return
        from ..fleet.meta_parallel.sharding import _GatherParam

        undo = []
        for mod, name, p, dim in self.gather:
            mod._parameters[name] = _GatherParam.apply(p, self.group, dim)
            undo.append((mod, name, p))
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            for mod, name, p in undo:
                mod._parameters[name] = p


def _col_gather_forward(mod, g, bias_cut):
    from ...nn import functional as F
    from ..collective import _c_concat, _c_identity

    def forward(x):
        out = F.linear(_c_identity(x, g), mod.weight,
                       mod.bias if bias_cut else None)
        out = _c_concat(out, g)
        if mod.bias is not None and not bias_cut:
            out = out + mod.bias
        return out
    return forward


def _row_split_forward(mod, g):
    from ...nn import functional as F
    from ..collective import _c_split, _mp_allreduce

    def forward(x):
        out = _mp_allreduce(F.linear(_c_split(x, g), mod.weight, None), g)
        return out + mod.bias if mod.bias is not None else out
    return forward


def realise(model, mesh=None, mp_axis="mp"):
    """Cut ``model``'s parameters by their ``pspec`` and wire the
    collectives (see the module docstring). Returns the record, whose
    ``undo()`` puts the model back whole and whose ``gathered()`` scope the
    model's calls run in. A model with no placement over ``mp_axis`` (or
    an axis of one rank) is left as it is."""
    from ...nn import Linear
    from ..fleet.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                 RowParallelLinear,
                                                 VocabParallelEmbedding)

    mesh = mesh or global_mesh()
    specs = {}
    for name, p in model.named_parameters():
        s = _norm(getattr(p, "pspec", None), p.dim())
        if s is None:
            continue
        other = {a for e in s if e is not None
                 for a in (e if isinstance(e, tuple) else (e,))} - {mp_axis}
        if other:
            raise NotImplementedError(
                f"auto_parallel: {name} is placed {s} over the axes "
                f"{sorted(other)}; the port realises placements over "
                f"{mp_axis!r} (a parameter sharded over a batch axis is "
                "ZeRO-3: group_sharded_parallel)")
        specs[id(p)] = s
    n = _axis_size(mesh, mp_axis)
    rec = _Realised(_group_of(mesh, mp_axis) if n > 1 and specs else None)
    if rec.group is None:
        return rec
    col, row = (None, mp_axis), (mp_axis, None)

    def spec(p):
        return specs.get(id(p)) if p is not None else None

    def col_ok(mod):
        return spec(mod.weight) == col and (
            mod.bias is None or spec(mod.bias) == (mp_axis,))

    def row_ok(mod):
        return spec(mod.weight) == row and (
            mod.bias is None or spec(mod.bias) is None)

    done = set()
    # the tensor-parallel pairs the model was built with: a column layer
    # that keeps its output local and the next row layer of its parent
    # that takes a parallel input
    for parent in model.modules():
        kids = [m for m in parent.children()
                if isinstance(m, (ColumnParallelLinear, RowParallelLinear))
                and m.world_size == 1]
        for a, b in zip(kids, kids[1:]):
            if isinstance(a, ColumnParallelLinear) and not a.gather_output \
                    and isinstance(b, RowParallelLinear) \
                    and b.input_is_parallel and col_ok(a) and row_ok(b):
                for mod in (a, b):
                    rec.keep(mod, group=rec.group, world_size=n)
                    rec.cut(mod.weight, mod.weight.mp_layout)
                    if mod is a and mod.bias is not None:
                        rec.cut(mod.bias, mod.bias.mp_layout)
                    done.update(id(q) for q in mod.parameters(
                        recurse=False))
    for mod in model.modules():
        own = [q for q in mod.parameters(recurse=False) if id(q) not in done]
        if not own:
            continue
        if isinstance(mod, ColumnParallelLinear) and mod.world_size == 1 \
                and mod.weight.mp_layout == "cols" and col_ok(mod):
            rec.keep(mod, group=rec.group, world_size=n, gather_output=True)
        elif isinstance(mod, RowParallelLinear) and mod.world_size == 1 \
                and row_ok(mod):
            rec.keep(mod, group=rec.group, world_size=n,
                     input_is_parallel=False)
        elif isinstance(mod, VocabParallelEmbedding) \
                and mod.world_size == 1 and spec(mod.weight) == row:
            per = mod.num_embeddings // n
            rec.keep(mod, group=rec.group, world_size=n, per_rank=per,
                     vocab_start=rec.group.rank * per)
        elif type(mod) is Linear and spec(mod.weight) == col and (
                mod.bias is None or spec(mod.bias) in (None, (mp_axis,))):
            bias_cut = mod.bias is not None and spec(mod.bias) is not None
            rec.swapped.append((mod, mod.__dict__.get("forward")))
            mod.forward = _col_gather_forward(mod, rec.group, bias_cut)
            rec.cut(mod.weight, dim=1)
            if bias_cut:
                rec.cut(mod.bias, dim=0)
            done.update(id(q) for q in own)
            continue
        elif type(mod) is Linear and row_ok(mod):
            rec.swapped.append((mod, mod.__dict__.get("forward")))
            mod.forward = _row_split_forward(mod, rec.group)
            rec.cut(mod.weight, dim=0)
            done.update(id(q) for q in own)
            continue
        else:
            # any other placement: a slice at rest, gathered for the call
            for name, q in list(mod._parameters.items()):
                s = spec(q)
                if q is None or s is None or id(q) in done:
                    continue
                dims = [d for d, e in enumerate(s) if e is not None]
                if len(dims) != 1 or q.shape[dims[0]] % n:
                    raise ValueError(f"auto_parallel: placement {s} of a "
                                     f"{tuple(q.shape)} parameter does not "
                                     f"split over {n} ranks")
                rec.cut(q, dim=dims[0])
                rec.gather.append((mod, name, q, dims[0]))
                done.add(id(q))
            continue
        for q in own:
            layout = getattr(q, "mp_layout", None)
            if spec(q) is not None:
                rec.cut(q, layout)
            done.add(id(q))
    return rec


# -- cost model / plan selection ---------------------------------------------
_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "collective-permute", "all-to-all")


def analyze_collectives(record):
    """Counts and bytes of the collectives a step launched: ``record`` is
    the list ``collective.record()`` filled, ``[(kind, bytes), ...]``. The
    reference's shape, ``{"counts": {...}, "bytes": ...}`` (a kind that
    never ran is left out)."""
    counts: dict = {}
    total = 0.0
    for kind, nbytes in record:
        counts[kind] = counts.get(kind, 0) + 1
        total += float(nbytes)
    return {"counts": counts, "bytes": total}


# The NVIDIA H100 80GB HBM3's peaks (700 W): only their RATIOS rank plans.
_PEAK_FLOPS = 989e12   # bf16 dense tensor core
_HBM_BW = 3.35e12      # HBM3
_LINK_BW = 450e9       # NVLink, one direction


class StepRun:
    """What one measured step of a placement did: ``flops``,
    ``bytes_accessed``, the collectives' ``record`` and ``peak_bytes``."""

    def __init__(self, flops, bytes_accessed, record, peak_bytes, loss=None):
        self.flops = float(flops)
        self.bytes_accessed = float(bytes_accessed)
        self.record = list(record)
        self.peak_bytes = int(peak_bytes)
        self.loss = loss


def _local_bytes(params, optimizer=None) -> int:
    """This rank's parameter, gradient and optimizer-state bytes."""
    pb = sum(p.numel() * p.element_size() for p in params)
    st = 0
    if optimizer is not None:
        accs = getattr(optimizer, "_accumulators", {}) or {}
        st = sum(t.numel() * t.element_size() for d in accs.values()
                 for t in d.values() if isinstance(t, torch.Tensor))
    return 2 * pb + st


def _traffic_mode():
    """A dispatch mode summing the bytes each aten op reads and writes (its
    tensor inputs and outputs; views move nothing): the eager counterpart
    of XLA's "bytes accessed"."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False) \
                    and func is not torch.ops.aten.detach.default:
                self.bytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs or {}, out))
                    if isinstance(t, torch.Tensor))
            return out

    return Traffic()


def measure_step(fn, params, optimizer=None, device=None) -> StepRun:
    """Run ``fn()`` once (one step's forward and backward) and measure it:
    FLOPs (aten ops plus the flash kernels' tally), the bytes its aten ops
    read and write, the collectives it launched, and its peak (the caching
    allocator's on the card; this rank's parameter, gradient and
    optimizer-state bytes on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ...ops.kernels import flash_attention as fa
    from .. import collective as C

    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    k0 = sum(fa.flops.values())
    traffic = _traffic_mode()
    with FlopCounterMode(display=False) as fc, traffic, C.record() as log:
        loss = fn()
    flops = fc.get_total_flops() + sum(fa.flops.values()) - k0
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = _local_bytes(params, optimizer)
    return StepRun(flops, traffic.bytes, log, peak, loss)


def plan_cost(run: StepRun) -> dict:
    """Roofline score of one measured step of this rank: compute time +
    memory time + link time, and the peak for budget checks."""
    comm = analyze_collectives(run.record)
    t = run.flops / _PEAK_FLOPS + run.bytes_accessed / _HBM_BW \
        + comm["bytes"] / _LINK_BW
    return {
        "time_proxy": t, "flops": run.flops,
        "bytes_accessed": run.bytes_accessed,
        "comm_bytes": comm["bytes"], "comm_counts": comm["counts"],
        "peak_memory_bytes": run.peak_bytes,
    }


def select_plan(model, plans, build_step, memory_budget: Optional[int] = None):
    """Score each candidate plan on the step it runs and apply the best.

    ``build_step()`` runs one measured step of the model's current
    placement and returns its :class:`StepRun` (``Engine.auto_parallelize``
    realises the placement, measures and puts the model back). Plans over
    the memory budget are rejected; ties break on comm bytes."""
    original = {n: getattr(p, "pspec", None) for n, p in model.named_parameters()}
    best = None
    for plan in plans:
        plan.apply(model)
        try:
            rep = plan_cost(build_step())
        except Exception as e:  # unshardable plan (bad divisibility, …)
            plan.report = {"error": str(e)[:200]}
            continue
        plan.report = rep
        over = memory_budget is not None and rep["peak_memory_bytes"] > memory_budget
        plan.score = (1 if over else 0, rep["time_proxy"], rep["comm_bytes"])
        if best is None or plan.score < best.score:
            best = plan
    if best is None:
        # leave the model exactly as the caller annotated it, not with the
        # last failed candidate's placements
        for n, p in model.named_parameters():
            p.pspec = original[n]
        raise RuntimeError("no candidate sharding plan ran successfully")
    best.apply(model)
    return best


def estimate_cost(fn: Callable, *example_args, mesh=None):
    """``{'flops', 'bytes_accessed', 'peak_memory_bytes'}`` of one call of
    ``fn(*example_args)``, measured as :func:`measure_step` measures (the
    bytes are the tensor arguments' and the outputs')."""
    args = [a for a in example_args if isinstance(a, torch.Tensor)]
    dev = args[0].device if args else None
    box = {}

    def run():
        box["out"] = fn(*example_args)
        return box["out"]

    r = measure_step(run, [], device=dev)
    outs = box["out"] if isinstance(box["out"], (list, tuple)) else [box["out"]]
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(args) + [o for o in outs
                                        if isinstance(o, torch.Tensor)])
    return {"flops": r.flops, "bytes_accessed": float(nbytes),
            "peak_memory_bytes": r.peak_bytes if dev is not None
            and dev.type == "cuda" else nbytes}


class Engine:
    """Auto-parallel engine (reference ``auto_parallel/engine.py:64``): a
    model, a loss and an optimizer over a mesh; it completes the
    placements, realises them and trains through ``HybridParallelEngine``.
    ``loss(outputs, labels)`` takes ``model(*batch[:-1])`` and the batch's
    last entry; without a loss the step is ``model(*batch)``."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 cluster=None, strategy=None, mesh=None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.mesh = mesh or global_mesh()
        self._engine = None
        self._realised = None
        self.plan = None
        self.plans = []  # the candidates auto_parallelize scored

    def _topology(self):
        """The mesh the step runs on: fleet's hybrid mesh when the job has
        no topology yet and the mesh has a model, sharding or sequence
        axis (``fleet.init`` from its degrees), else the given one."""
        from ..fleet import DistributedStrategy
        from ..fleet.base import fleet_base

        sizes = {a: s for a, s in self.mesh.shape.items() if s > 1}
        hybrid = {a: s for a, s in sizes.items() if a not in ("dp", "pp",
                                                              "ep")}
        if not hybrid or fleet_base.get_hybrid_communicate_group() is not None:
            return self.mesh
        st = DistributedStrategy()
        st.hybrid_configs = dict(st.hybrid_configs, **{
            f"{a}_degree": s for a, s in sizes.items()})
        fleet_base.init(is_collective=True, strategy=st)
        return fleet_base.get_hybrid_communicate_group().mesh

    def _wrapped(self):
        loss_fn = self.loss

        def wrapped(model, *batch):
            rec = self._realised  # read at each call: a plan may be redone
            scope = rec.gathered() if rec is not None \
                else contextlib.nullcontext()
            with scope:
                return loss_fn(model(*batch[:-1]), batch[-1]) if loss_fn \
                    else model(*batch)
        return wrapped

    def _build(self, donate=True):
        from ..engine import HybridParallelEngine

        return HybridParallelEngine(self.model, self.optimizer,
                                    self._wrapped(), mesh=self.mesh,
                                    donate=donate)

    def prepare(self, *a, **k):
        self.mesh = self._topology()
        complete_annotations(self.model, self.mesh)
        if self._realised is not None:
            self._realised.undo()
        self._realised = realise(self.model, self.mesh)
        self._engine = self._build()
        return self

    def _measured(self, batch):
        """One measured step (forward, backward, gradient sync; no update)
        of the current placement; the RNG stream is restored."""
        from ...core.random import get_rng_state, set_rng_state

        rng = get_rng_state()
        eng = self._engine
        try:
            return measure_step(lambda: eng.trial_step(*batch), eng.params,
                                self.optimizer, device=eng._device)
        finally:
            set_rng_state(rng)

    def auto_parallelize(self, *example_batch, memory_budget=None):
        """Derive the candidate plans, run and score each one's step (the
        roofline proxy over the card's peaks, the peak memory against
        ``memory_budget``), apply and realise the winner. Returns the
        winning ShardingPlan."""
        self.mesh = self._topology()
        if self._realised is not None:
            self._realised.undo()
            self._realised = None
        plans = derive_candidate_plans(self.model, self.mesh)

        def build_step():
            self._realised = realise(self.model, self.mesh)
            try:
                self._engine = self._build(donate=False)
                return self._measured(example_batch)
            finally:
                self._engine = None
                self._realised.undo()
                self._realised = None

        self.plans = plans
        best = select_plan(self.model, plans, build_step, memory_budget)
        self._realised = realise(self.model, self.mesh)
        self._engine = self._build()
        self.plan = best
        return best

    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None, **k):
        if self._engine is None:
            self.prepare()
        history = []
        for _ in range(epochs):
            for step, batch in enumerate(train_data):
                if steps_per_epoch and step >= steps_per_epoch:
                    break
                batch = batch if isinstance(batch, (list, tuple)) else (batch,)
                loss = self._engine.train_step(*batch)
                history.append(float(loss.item()))
        return history

    def cost(self, *example_batch):
        """The measured cost of one training step under the current plan
        (``plan_cost``'s report). Read-only: the RNG stream, the parameters
        and the optimizer state are left as they were."""
        if self._engine is None:
            self.prepare()
        return plan_cost(self._measured(example_batch))
