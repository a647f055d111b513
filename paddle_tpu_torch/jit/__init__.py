"""``paddle.jit`` (port of ``paddle_tpu/jit/__init__.py``): dygraph→static
capture (``to_static``), the deployment artifact (``save``/``load``) and the
train step (``compile_train_step`` / ``CompiledTrainStep``).

``to_static`` wraps a function or a layer's forward in a ``StaticFunction``:
its source is rewritten by ``dy2static`` (tensor ``if``/``while``/``for``
become ``torch.cond``/``torch.while_loop`` when traced), and a call runs the
rewritten function eagerly, so autograd is PyTorch's own and a concrete
predicate takes the Python branch. The reference compiles the call with
``jax.jit``; the port does not compile it. ``program(...)`` gives the
static ``Program`` view (an FX graph from ``make_fx``) and
``concrete_program(...)`` the ``torch.export`` program.

``save(layer, path, input_spec)`` writes the artifact:

- ``{path}.pdmodel``: ``torch.export.save`` bytes of the eval-mode, no-grad
  forward, with the layer's parameters and persistent buffers lifted to the
  program's first argument (so the file holds no weights; their names and
  the device it was traced on are in its ``paddle_tpu_torch.json`` extra
  file). A ``None``/-1 dimension of a spec is a ``torch.export.Dim`` of its
  own (``torch.export.Dim.DYNAMIC``, which export narrows itself where a
  kernel bounds it, as the card's grid bounds a convolution net's batch
  at 65535); a forward that is not shape-polymorphic falls back to a
  static export at size 1, as the reference does;
- ``{path}.pdiparams``: the weights, once, by ``framework.io.save`` in the
  reference's format: ``{"state": state_dict, "specs": [(shape, dtype
  name, name)]}``, which either package's ``framework.io.load`` reads;
- ``{path}.pdtrain`` and ``{path}.pdtrain.json``: the same forward with the
  parameters lifted and the buffers baked in (``{"param_names": [...]}``),
  which ``static.TrainableProgram`` differentiates.

``load(path)`` gives a ``TranslatedLayer`` over the program and the weights
on the card (or ``device``); a program traced on another device is moved
(``torch.export.passes.move_to_device_pass``). The reference's artifact is a
``jax.export`` StableHLO program: the port refuses it with an error that
says so, and the reference cannot read the port's.

The train step: the reference traces forward, backward and the optimizer update into one
XLA executable. PyTorch runs eagerly, so "compiled" is the reference's name
only here: one call clears the gradients, runs ``loss_fn(model, *batch)``,
its ``backward()`` and the optimizer update, and returns the loss tensor
without a host sync, so consecutive steps queue on the card's stream.
Capturing the step in a CUDA graph is later work.

The update is the reference's compiled one, which differs from its eager
``Optimizer.step()``: the reference's ``CompiledTrainStep`` calls
``_functional_update`` without the parameters, so it applies no
``grad_clip``, decays every parameter whatever ``apply_decay_param_fun``
says, and ignores the per-parameter lr scale. The port keeps both
behaviours, since each is held against the reference: ``step()`` for the
eager loop, ``Optimizer._step(functional=True)`` here.

While a call runs, :func:`in_compiled_step` is true: the reference traces
the step, and a layer that takes another branch under a trace reads it
(``quantization.FakeQuantMovingAverageAbsMax`` quantizes with the batch's
abs-max and leaves its moving average alone, as the reference's traced
branch does).

With ``FLAGS_check_nan_inf`` set, a call raises ``TypeError``, as the
reference's traced step does (``core/dispatch.py``).

Under ``FLAGS_hbm_admission`` ``warn`` or ``enforce`` the step is admitted
as the reference's lazy flush is (and the port's, ``core/lazy.py``; see
``fault/memory.py``): the first two calls
of a signature (the batch's shapes and dtypes) measure its footprint
(``cost_model.MeasuredStep``; on the card this resets the allocator's peak
statistics; the first builds the state the second finds in place, see
``cost_model.MEASURED_CALLS``), and every later call is admitted with the
second's numbers: it runs ``fault.memory.preflight`` before it
clears the gradients or launches anything, so an ``enforce`` rejection
leaves the parameters, gradients, optimizer state, step counts and RNG
stream as they were and the same call can simply be made again. With the
flag ``off`` the cost is one flag probe and ``fault.memory`` is never
reached.

A call crosses out of the lazy engine, as the reference's compiled
callables do (``_conc``): the pending graph is flushed, LazyArray inputs
are materialized, and the step runs eagerly; its capture on the lazy
engine's graph cache is later work.

Each call is one ``train_step`` span. Under ``Profiler(profile_memory=True)``
or ``FLAGS_profile_memory`` the step ends with a memory census
(``profiler.memory_census``) whose ``live_bytes``, ``live_arrays``,
``peak_live_bytes`` and ``delta_bytes`` become the span's attrs, as the
reference's lazy flush sets them; on the card the census reads the caching
allocator's counters and adds no host sync.
"""
from __future__ import annotations

import contextlib
import contextvars
import io
import json
import os
import types
import warnings

import torch

from .. import profiler
from ..core import lazy as _lazy
from ..core.place import resolve_device
from ..framework.flags import flag
from ..static.input import InputSpec

__all__ = ["CompiledTrainStep", "compile_train_step", "in_compiled_step",
           "StaticFunction",
           "to_static", "declarative", "not_to_static", "ignore_module",
           "enable_to_static", "save", "load", "TranslatedLayer",
           "InputSpec"]


def _conc(a):
    """A compiled step's arguments must be concrete: a LazyArray is
    materialized (the pending graph flushes) before it crosses in."""
    return _lazy.concrete(a)


_COMPILED_STEP = contextvars.ContextVar("paddle_tpu_torch_compiled_step",
                                        default=False)


def in_compiled_step() -> bool:
    """True inside a ``CompiledTrainStep`` call (the reference's traced
    step)."""
    return _COMPILED_STEP.get()


class CompiledTrainStep:
    def __init__(self, model, loss_fn, optimizer):
        params = list(model.parameters())
        if not params:
            raise ValueError("compile_train_step: the model has no parameters")
        # raises when the model sits on a card this process cannot reach
        self._device = resolve_device(params[0].device)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._step_count = 0
        # step signature -> (calls measured, the last footprint): admission
        self._mem = {}

    def _as_tensor(self, b):
        return b if isinstance(b, torch.Tensor) \
            else torch.as_tensor(b, device=self._device)

    def __call__(self, *batch):
        if flag("FLAGS_check_nan_inf", False):
            # the reference's step is traced, and its nan/inf scan cannot
            # read a traced value: every call raises jax's
            # TracerBoolConversionError (a TypeError) while the flag is set
            raise TypeError(
                "compile_train_step: FLAGS_check_nan_inf cannot scan a "
                "compiled train step, whose values are traced in the "
                "reference; clear the flag or run the eager loop")
        with profiler.span("train_step", step=self._step_count) as sp:
            _lazy.flush()
            batch = [self._as_tensor(_conc(b)) for b in batch]
            with _lazy.eager():
                if flag("FLAGS_hbm_admission", "off") != "off":
                    loss = self._admitted(sp, batch)
                else:
                    loss = self._run(batch)
                loss = loss.detach()
            if profiler._memory_active():
                mem = profiler.memory_census(self._device)
                sp.set(live_bytes=mem["live_bytes"],
                       live_arrays=mem["live_arrays"],
                       peak_live_bytes=mem["peak_live_bytes"],
                       delta_bytes=mem["last_delta_bytes"])
            return loss

    def _run(self, batch):
        token = _COMPILED_STEP.set(True)
        try:
            self.optimizer.clear_grad(set_to_zero=False)
            loss = self.loss_fn(self.model, *batch)
            loss.backward()
            self.optimizer._step(functional=True)
        finally:
            _COMPILED_STEP.reset(token)
        self._step_count += 1
        return loss

    def _admitted(self, sp, batch):
        """The step under HBM admission: measured on its signature's first
        ``MEASURED_CALLS`` calls, admitted by ``preflight`` before every
        later one."""
        from ..cost_model import MEASURED_CALLS, MeasuredStep
        from ..fault import memory as _hbm

        sig = ("train_step",) + tuple(
            (tuple(b.shape), str(b.dtype)) for b in batch)
        calls, mem = self._mem.get(sig, (0, None))
        if calls >= MEASURED_CALLS:
            _hbm.preflight(mem, "train_step", span=sp, device=self._device)
            return self._run(batch)
        with MeasuredStep(self._device) as run:
            loss = self._run(batch)
        mem = _hbm.analyze_compiled(
            run, key=f"train_step:{hash(sig) & 0xFFFFFFFFFFFFFFFF:016x}")
        self._mem[sig] = (calls + 1, mem)
        if mem is not None:
            sp.set(hbm_exec_peak_bytes=mem["peak_bytes"])
        return loss


def compile_train_step(model, loss_fn, optimizer) -> CompiledTrainStep:
    return CompiledTrainStep(model, loss_fn, optimizer)


# ---------------------------------------------------------------------------
# to_static: the converted function, run eagerly, with its export views
# ---------------------------------------------------------------------------
_TO_STATIC = {"on": True}


def _is_layer(obj) -> bool:
    return isinstance(obj, torch.nn.Module)


class StaticFunction:
    """A function (or a layer's forward) whose tensor control flow was
    converted by ``dy2static``. A call runs the converted function eagerly
    (the original one after ``enable_to_static(False)``)."""

    def __init__(self, function, layer=None, input_spec=None):
        self._orig = function
        self._fn = self._convert_control_flow(function)
        self._layer = layer
        self._input_spec = input_spec

    @staticmethod
    def _convert_control_flow(function):
        """The function with tensor-dependent ``if``/``while`` rewritten
        (``dy2static``); the function itself when its source cannot be
        rewritten."""
        from . import dy2static

        raw = getattr(function, "__func__", function)
        transformed = dy2static.transform_function(raw)
        if transformed is None:
            return function
        if hasattr(function, "__self__"):
            return types.MethodType(transformed, function.__self__)
        return transformed

    def __call__(self, *args, **kwargs):
        fn = self._fn if _TO_STATIC["on"] else self._orig
        return fn(*args, **kwargs)

    def _specs(self, example_inputs):
        specs = list(example_inputs) or list(self._input_spec or [])
        if not specs:
            raise ValueError("pass example inputs or set input_spec")
        return specs

    def program(self, *example_inputs):
        """The static ``Program`` of the converted function (an FX graph of
        ATen ops over the inputs, then the layer's parameters) at the
        example inputs or ``InputSpec``s (``None`` dims at 1)."""
        from ..static.program import Program

        return Program.from_callable(self._fn, self._specs(example_inputs),
                                     layer=self._layer)

    def concrete_program(self, *args):
        """The ``torch.export`` program of the converted function at
        ``args`` (tensors, or ``InputSpec``s whose ``None`` dims export
        symbolic), the layer's parameters and buffers as its state."""
        specs = self._specs(args)
        module = _Bound(self._fn, self._layer)
        device = _device_of(self._layer, None)
        tensors = [a for a in specs if isinstance(a, torch.Tensor)]
        if len(tensors) == len(specs):
            return _traced(lambda: torch.export.export(module, tuple(specs)))
        specs = [InputSpec.from_tensor(a) if isinstance(a, torch.Tensor)
                 else a for a in specs]
        return _export(module, (), specs, device)[0]


class _Bound(torch.nn.Module):
    """``fn(*inputs)`` as a module, the layer its submodule (so its tensors
    are the exported program's state)."""

    def __init__(self, fn, layer):
        super().__init__()
        self.__dict__["_fn"] = fn
        self.layer = layer

    def forward(self, *inputs):
        return self._fn(*inputs)


class TracedValueError(TypeError):
    """A Python ``if``/``while`` (or ``bool()``) read the value of a traced
    tensor, which has none."""


def _traced(run):
    """``run()``; a Python ``if``/``while`` that read a traced tensor's
    value raises ``TracedValueError`` (a ``TypeError``) saying so."""
    from torch._subclasses.fake_tensor import DataDependentOutputException
    from torch.fx.experimental.symbolic_shapes import \
        GuardOnDataDependentSymNode

    try:
        return run()
    except (GuardOnDataDependentSymNode, DataDependentOutputException) as e:
        raise TracedValueError(
            "to_static: a Python `if`/`while` (or `bool()`) read the value "
            "of a traced Tensor, which has none; keep the control flow "
            "convertible (no `return`/`break` inside a tensor branch) or "
            f"use paddle.static.nn.cond/while_loop ({type(e).__name__})"
        ) from e


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator/wrapper (reference ``paddle.jit.to_static`` /
    ``declarative``): a layer gets a ``StaticFunction`` forward; a function
    or a bound method becomes one."""

    def decorate(fn):
        if _is_layer(fn):
            fn.forward = StaticFunction(fn.forward, layer=fn,
                                        input_spec=input_spec)
            return fn
        if _is_layer(getattr(fn, "__self__", None)):
            return StaticFunction(fn, layer=fn.__self__,
                                  input_spec=input_spec)
        return StaticFunction(fn, layer=None, input_spec=input_spec)

    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    """Keep ``fn`` out of the AST conversion (it runs, and traces, as
    written)."""
    fn._not_to_static = True
    return fn


def ignore_module(modules):
    """Accepted for the reference's API; the conversion never descends into
    called modules, so there is nothing to ignore."""


def enable_to_static(flag=True):
    """Whether ``StaticFunction`` calls run the converted function (True)
    or the original one."""
    _TO_STATIC["on"] = bool(flag)


# ---------------------------------------------------------------------------
# save / load: torch.export programs with the weights beside them
# ---------------------------------------------------------------------------
_FORMAT = "paddle_tpu_torch.export/1"
_META = "paddle_tpu_torch.json"
_ZIP = b"PK\x03\x04"  # torch.export.save writes a zip archive


class _Lifted(torch.nn.Module):
    """``fn(*inputs)`` with the named tensors of ``layer`` (parameters,
    buffers) taken from ``weights``: the module ``save`` exports, so the
    program holds no weights. ``layer`` is not a submodule: what is not
    lifted (non-persistent buffers) is baked into the program."""

    def __init__(self, fn, layer, names):
        super().__init__()
        self.__dict__["_fn"] = fn
        self.__dict__["_layer"] = layer
        self._names = list(names)

    def forward(self, weights, inputs):
        if self._layer is None or not self._names:
            return self._fn(*inputs)
        from torch.nn.utils.stateless import _reparametrize_module

        with _reparametrize_module(self._layer,
                                   dict(zip(self._names, weights))):
            return self._fn(*inputs)


def _device_of(layer, device):
    if device is not None:
        return resolve_device(device)
    if layer is not None:
        for t in list(layer.parameters()) + list(layer.buffers()):
            return t.device
    return resolve_device(None)


def _is_dynamic(d) -> bool:
    return d is None or d == -1


def _example(spec, device, dynamic):
    """Zeros of the spec's shape: a free dim at 2 when it exports symbolic
    (1 would be specialised), else at 1."""
    shape = tuple((2 if dynamic else 1) if _is_dynamic(d) else int(d)
                  for d in spec.shape)
    return torch.zeros(shape, dtype=spec.dtype, device=device)


def _export(module, weights, specs, device, no_grad=False):
    """(ExportedProgram, dynamic) of ``module(weights, inputs)`` (or
    ``module(*inputs)`` when ``weights`` is ``()``); free dims symbolic
    (within the range export finds), or static at size 1 when the trace
    is not shape-polymorphic."""
    lifted = isinstance(module, _Lifted)

    def attempt(dynamic):
        ex = [_example(s, device, dynamic) for s in specs]
        dims = None
        if dynamic:
            dims = [{di: torch.export.Dim.DYNAMIC
                     for di, d in enumerate(s.shape) if _is_dynamic(d)}
                    or None for s in specs]
            # _Bound.forward(*inputs) takes them as one varargs tuple
            dims = ([None] * len(weights), dims) if lifted else (tuple(dims),)
        args = (list(weights), ex) if lifted else tuple(ex)
        ctx = torch.no_grad() if no_grad else contextlib.nullcontext()
        with ctx:
            ep = _traced(lambda: torch.export.export(module, args,
                                                     dynamic_shapes=dims))
        ep.example_inputs = None  # save would write them: the weights
        return ep

    if any(_is_dynamic(d) for s in specs for d in s.shape):
        try:
            return attempt(True), True
        except TypeError:
            raise  # a Python branch read a traced value: no size helps
        except Exception:
            pass  # not shape-polymorphic: a static export at size 1
    return attempt(False), False


def _write_program(ep, path, meta):
    from ..framework.io import atomic_open

    with atomic_open(path, "wb") as f:
        torch.export.save(ep, f, extra_files={
            _META: json.dumps({"format": _FORMAT, **meta})})


def read_program(path, device=None):
    """(ExportedProgram, meta) from a ``.pdmodel``/``.pdtrain`` file,
    moved to ``device`` when it was traced on another. Raises on the
    reference's StableHLO artifact and on any file that is not the port's
    program."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head != _ZIP:
        raise ValueError(
            f"{path} is not a torch.export program: it looks like the "
            "reference's jax.export (StableHLO) artifact, which "
            "paddle_tpu.jit.load reads; paddle_tpu_torch reads what "
            "paddle_tpu_torch.jit.save wrote")
    extra = {_META: ""}
    with open(path, "rb") as f:
        ep = torch.export.load(io.BytesIO(f.read()), extra_files=extra)
    meta = json.loads(extra[_META] or "{}")
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}: a torch.export program without the "
                         f"port's {_META} (not written by jit.save)")
    if device is not None and torch.device(meta["device"]) != device:
        from torch.export.passes import move_to_device_pass

        ep = move_to_device_pass(ep, str(device))
    return ep, meta


def _resolve(layer):
    """(raw function, layer or None) that ``save`` exports."""
    fn = layer.forward if _is_layer(layer) else layer
    if isinstance(fn, StaticFunction):
        return fn._fn, fn._layer
    return fn, (layer if _is_layer(layer) else None)


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save: the artifact described in the module docstring.
    ``configs["device"]`` sets where a function without a layer is traced
    (default the card)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fn = layer.forward if _is_layer(layer) else layer
    raw_fn, inner = _resolve(layer)
    if input_spec is None and isinstance(fn, StaticFunction):
        input_spec = fn._input_spec
    if input_spec is None:
        raise ValueError("paddle_tpu_torch.jit.save requires input_spec")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    device = _device_of(inner, configs.get("device"))
    state, params, names = {}, [], []
    if inner is not None:
        inner.eval()
        state = inner.state_dict()
        params = [n for n, _ in inner.named_parameters()]
        named = dict(inner.named_parameters())
        named.update(inner.named_buffers())
        names = [n for n in named if n in state]
    weights = [state[n] for n in names]
    ep, dynamic = _export(_Lifted(raw_fn, inner, names), weights, specs,
                          device, no_grad=True)
    _write_program(ep, path + ".pdmodel", {
        "names": names, "device": str(device), "dynamic": dynamic})
    from ..framework.io import save as fsave
    from ..core.dtype import dtype_name

    fsave({"state": state, "specs": [(list(s.shape), dtype_name(s.dtype),
                                      s.name) for s in specs]},
          path + ".pdiparams")
    _save_trainable(raw_fn, inner, params, state, specs, device, path)


def _save_trainable(raw_fn, inner, params, state, specs, device, path):
    """The ``.pdtrain`` companion: the forward with the parameters lifted
    and the buffers baked in, traced with grad on (reference: the program
    exported with params as arguments and its VJP). A forward that
    ``torch.export`` cannot trace with grad on (a Python branch on a traced
    value, an unsupported construct) leaves the inference artifact complete
    and no ``.pdtrain``, with a warning naming the forward; any other error
    propagates."""
    for suffix in (".pdtrain", ".pdtrain.json"):
        if os.path.exists(path + suffix):
            os.remove(path + suffix)
    if inner is None or not params:
        return
    from ..framework.io import atomic_open

    from torch._dynamo.exc import Unsupported, UserError

    try:
        ep, dynamic = _export(_Lifted(raw_fn, inner, params),
                              [state[n] for n in params], specs, device)
    except (TracedValueError, Unsupported, UserError) as e:
        name = getattr(raw_fn, "__qualname__", repr(raw_fn))
        warnings.warn(f"jit.save: {name} cannot be exported with its "
                      f"parameters as inputs ({type(e).__name__}: {e}); "
                      f"{path}.pdtrain is not written", stacklevel=3)
        return
    _write_program(ep, path + ".pdtrain", {
        "names": params, "device": str(device), "dynamic": dynamic})
    with atomic_open(path + ".pdtrain.json", "w") as f:
        json.dump({"param_names": params}, f)


def _feed(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(x, device=device)


class TranslatedLayer:
    """A reloaded program with its weights (reference dygraph/io.py
    TranslatedLayer): ``layer(*inputs)`` runs the exported forward on the
    device the weights were loaded to."""

    def __init__(self, program, weights, state, specs, device):
        self.program = program
        self._module = program.module()
        self._weights = weights
        self._state = state
        self._specs = specs
        self.device = device
        self.training = False

    def __call__(self, *args):
        with torch.no_grad():
            return self._module(self._weights,
                                [_feed(a, self.device) for a in args])

    forward = __call__

    def eval(self):
        self.training = False
        return self

    def state_dict(self):
        return self._state


def load_artifact(path, device=None):
    """(program, weights in program order, state, specs, device) of a
    ``save``d artifact, the weights on ``device`` (default the card)."""
    from ..framework.io import load as fload

    device = resolve_device(device)
    ep, meta = read_program(path + ".pdmodel", device)
    params = fload(path + ".pdiparams", device=device)
    state = params["state"]
    missing = [n for n in meta["names"] if n not in state]
    if missing:
        raise ValueError(f"{path}.pdiparams lacks the program's weights "
                         f"{missing[:4]}")
    weights = [state[n].detach() for n in meta["names"]]
    return ep, weights, state, params.get("specs") or [], device


def load(path, device=None, **configs):
    """paddle.jit.load: a ``TranslatedLayer`` on ``device`` (default the
    card)."""
    return TranslatedLayer(*load_artifact(path, device))
