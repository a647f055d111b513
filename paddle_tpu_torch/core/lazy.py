"""The lazy eager engine (port of ``paddle_tpu/core/lazy.py``): eager ops
are recorded into a pending graph and run together at a materialization
point, on the card as one CUDA graph per graph signature.

The reference queues its eager ops and runs them as one cached XLA
executable keyed on the graph's signature. Here the executable is a
``torch.cuda.CUDAGraph``: the first sight of a signature replays the
recorded ops eagerly (the warm-up, which also builds the nvcc kernels and
cuBLAS handles outside any capture), the second captures the replay into a
graph on a private memory pool, and every later sight copies the step's
fresh inputs into the graph's static inputs and calls ``replay()``: one
launch for the thousands of an iteration. On the CPU a flush replays the
recorded ops in order, the counterpart of the reference's un-jitted replay.

Design:

* **Recording.** :func:`set_lazy_mode` (or :class:`lazy_guard`) pushes a
  ``TorchDispatchMode`` on the calling thread. It records every ATen op and
  custom operator into the thread's pending :class:`_Graph` and returns
  :class:`LazyArray` outputs: ``torch.Tensor`` wrapper subclasses carrying
  the node, the output index and, once flushed, the concrete tensor. The
  mode is the gate, not the subclass: an op whose inputs are all concrete
  (a parameter with a pending in-place update, read by the next forward)
  is recorded too, so it never runs at once on stale values. In-place ops
  are recorded and return their written argument; the replay runs them on
  the real tensors in order, so views and in-place updates keep eager
  semantics. The autograd engine's threads inherit the mode, so the
  backward is recorded into the same graph.
* **Output metadata** comes from a cached fake-tensor probe
  (``FakeTensorMode``, the counterpart of ``jax.eval_shape``): a shape or
  dtype error surfaces at the op's call site and leaves the pending graph
  as it was. The wiring descriptors, the leaf table, ``direct_uses`` and
  the signature parts are built at record time.
* **Materialization points** flush, then run eagerly: ops whose output
  shape or value depends on the data (``nonzero``, ``masked_select``,
  ``.item()``'s ``aten._local_scalar_dense``), copies between the card and
  the host, and, through a ``TorchFunctionMode``, host reads of any tensor
  (``numpy``, ``tolist``, ``repr``, ``data_ptr``, DLPack, pickling,
  ``.data =``), so a leaf with a pending in-place write is read after it.
  On a machine with a card, ops on CPU tensors alone are not deferred.
* **The signature** (:func:`flush`) keys ``_flush_cache`` on the ops
  (overload and non-tensor arguments), the wiring, each leaf's shape,
  strides, dtype and device, which leaves are bound by address (and their
  addresses on the card), and the liveness mask. Parameters and the tensors
  registered with :func:`note_persistent` (the optimizers' moments) are
  bound by address: a captured graph reads and writes them where they are.
  Every other leaf (a batch, a scalar made each step) is copied into the
  graph's static input before a replay, and copied back if the graph
  writes it. Outputs stay in the graph's pool; one that is still alive
  when its graph replays again is copied out first.
* **Async** (``FLAGS_lazy_async``, on): a flush returns once the replay is
  enqueued. :func:`timed_block` and :func:`sync` wait under a ``block``
  span and feed ``lazy_block_ns``. The ``FLAGS_check_nan_inf`` scan becomes
  one fused finite check over the flush's live floating outputs and the
  leaves it wrote, read at the next flush, materialization or ``sync()``,
  with the producing ``lazy_flush`` span's attribution.
  ``FLAGS_lazy_async=0`` waits at every flush and scans at once.
* **Fallbacks.** A capture or a replay that fails re-runs the step's ops
  eagerly on the same device with the same kernels, counted in
  ``lazy_replay_fallbacks`` and never silent; a CUDA out-of-memory error
  evicts cold graphs (their pools) and retries once, then raises.
  Nothing falls back to the CPU or to a kernel's plain version.

Differences by design, beside the reference: the engine is off by default
(``set_lazy_mode(True)`` turns it on); ``FLAGS_lazy_donate`` has no XLA
donation to drive, because the optimizers update their leaves in place:
a rebound leaf that is dead after the flush is counted as donated
(``lazy_donated_buffers``) and, on the card, is not copied back out of the
graph's static input; ``FLAGS_lazy_bg_compile`` makes the capture skip
``torch.cuda.graph``'s device-wide synchronize (the capture runs on a side
stream ordered after the pending work), so the capturing flush does not
stall the host.
"""
from __future__ import annotations

import collections
import operator
import sys
import threading
import time
import weakref
from typing import List, Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.overrides import TorchFunctionMode

__all__ = [
    "LazyArray", "record", "flush", "sync", "lazy_enabled", "set_lazy_mode",
    "lazy_guard", "is_lazy", "maybe_lazy_binary", "lazy_full",
    "note_rebound", "timed_block", "evict_cold",
]

_state = threading.local()
_DEFAULT_ENABLED = False  # the reference's is True (ROADMAP §C)

# Stability-sentinel drain tap (fault/sentinel.py): called at the boundaries
# where the deferred NaN/Inf checks drain. None while no sentinel listens.
_stability_tap = None

# A graph that reaches this many nodes flushes without a materialization
# point, at the same offsets in identical iterations. The reference's bound
# is 2048 (its XLA compile time grows with the graph); a CUDA graph's
# capture does not, and a graph cut inside an iteration hands the next one
# its activations as leaves to copy: 16384 holds one train step of GPT-3
# 1.3B (about 4600 ATen ops, 186 a layer) or of ERNIE-3.0 base with Lamb
# (about 7800: Lamb runs parameter by parameter).
_MAX_PENDING = 16384

_ON_CARD = torch.cuda.is_available()
_aten = torch.ops.aten


class _ThreadState:
    """One recording thread's lazy state. The dispatch mode holds it, so
    the autograd engine's threads (which inherit the mode) record into the
    same graph as the thread that called ``backward()``."""

    __slots__ = ("graph", "flushing", "deferred", "inflight", "donate_ids",
                 "mode", "fmode", "__weakref__")

    def __init__(self):
        self.graph: Optional[_Graph] = None
        self.flushing = False
        self.deferred: list = []
        self.inflight = None  # the last flush's CUDA event
        self.donate_ids: set = set()
        self.mode = _LazyMode(self)
        self.fmode = _HostReadMode(self)


def _ts() -> _ThreadState:
    ts = getattr(_state, "ts", None)
    if ts is None:
        ts = _state.ts = _ThreadState()
    return ts


def lazy_enabled() -> bool:
    return getattr(_state, "enabled", _DEFAULT_ENABLED)


def _push(ts):
    torch.overrides._push_mode(ts.fmode)
    torch.utils._python_dispatch._push_mode(ts.mode)


def _pop(ts):
    """Take this thread's lazy modes off the mode stacks; modes pushed
    above them since (the nan/inf scan's) are put back as they were."""
    from torch.utils._python_dispatch import (
        _get_current_dispatch_mode_stack, _pop_mode, _push_mode)

    for stack, pop, push, mine in (
            (_get_current_dispatch_mode_stack, _pop_mode, _push_mode,
             ts.mode),
            (torch.overrides._get_current_function_mode_stack,
             torch.overrides._pop_mode, torch.overrides._push_mode,
             ts.fmode)):
        if not any(m is mine for m in stack()):
            raise RuntimeError("set_lazy_mode(False): the lazy engine is "
                               "not on this thread's mode stack")
        above = []
        while stack()[-1] is not mine:
            above.append(pop())
        pop()
        for m in reversed(above):
            push(m)


def set_lazy_mode(enabled: bool) -> None:
    """Turn lazy recording on or off for this thread (flushes first)."""
    flush()
    enabled = bool(enabled)
    was = lazy_enabled()
    if enabled == was:
        return
    ts = _ts()
    if enabled:
        _push(ts)
    else:
        _pop(ts)
    _state.enabled = enabled


class lazy_guard:
    """``with lazy_guard(True): ...`` records; ``lazy_guard(False)`` runs
    op by op."""

    def __init__(self, enabled: bool = True):
        self._want = bool(enabled)

    def __enter__(self):
        self._prev = lazy_enabled()
        set_lazy_mode(self._want)
        return self

    def __exit__(self, *exc):
        set_lazy_mode(self._prev)
        return False


class suspended:
    """Run eagerly inside a lazy region (``with suspended(): ...``): no
    recording, no host-read flushes. For code that must act now on concrete
    tensors (creating an optimizer's moments, a pure host computation)."""

    def __enter__(self):
        self._fn = torch._C.DisableTorchFunction()
        self._fn.__enter__()
        self._dm = _disable_current_modes()
        self._dm.__enter__()
        return self

    def __exit__(self, *exc):
        self._dm.__exit__(*exc)
        self._fn.__exit__(*exc)
        return False


def eager():
    """:class:`suspended` while lazy mode is on for this thread, else a
    context that does nothing (other modes, a fake or a meta one, stay)."""
    import contextlib

    return suspended() if lazy_enabled() else contextlib.nullcontext()


def is_lazy(x) -> bool:
    return isinstance(x, LazyArray)


# -- persistent (bound-by-address) tensors ------------------------------------
_persistent: dict = {}  # id -> weakref of the tensor


def note_persistent(*ts) -> None:
    """Bind ``ts`` by address in every graph that reads them (an
    optimizer's moments): a captured graph updates them where they are
    instead of through a copy."""
    for t in ts:
        t = concrete(t)
        i = id(t)
        _persistent[i] = weakref.ref(t, lambda _, i=i: _persistent.pop(i, None))


def _bound(t) -> bool:
    if isinstance(t, torch.nn.Parameter):
        return True
    r = _persistent.get(id(t))
    if r is not None and r() is t:
        return True
    b = t._base
    return b is not None and _bound(b)


# -- LazyArray -----------------------------------------------------------------
class _Node:
    __slots__ = ("key", "fn", "args", "kwargs", "inputs", "n_out", "out_refs",
                 "gix", "graph", "outs_of", "writes", "state")

    def __init__(self, key, fn, args, kwargs, inputs, n_out, outs_of, writes,
                 state=None):
        self.key = key
        self.fn = fn
        self.args = args  # templates: a _Slot k where tensor input k goes
        self.kwargs = kwargs
        self.inputs = inputs  # per descriptor: the leaf, or a weakref
        self.n_out = n_out
        self.outs_of = outs_of  # how the op's result maps to outputs
        self.writes = writes  # input positions the op writes in place
        self.state = state  # the TF32 switches a product ran under
        self.out_refs = None
        self.gix = 0
        self.graph = None


class LazyArray(torch.Tensor):
    """A pending node output: a wrapper tensor with the output's metadata
    and no storage. Metadata is free; a host read (``numpy``, ``item``,
    ``print``...) flushes the pending graph. With lazy mode off, an op on a
    LazyArray runs on its concrete tensor."""

    aval = None  # (shape, strides, storage offset, dtype, device)

    @staticmethod
    def __new__(cls, node, idx, meta):
        shape, stride, off, dtype, device = meta
        r = torch.Tensor._make_wrapper_subclass(
            cls, shape, strides=stride, storage_offset=off, dtype=dtype,
            device=device, requires_grad=False)
        r._node = node
        r._idx = idx
        r.aval = meta
        r._concrete = None
        return r

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        # reached with no lazy mode on this thread: run on the concrete
        # tensors (the written arguments of an in-place op come back as
        # the LazyArrays the caller passed)
        kwargs = kwargs or {}
        cargs = _map_tensors(args, _value_of)
        ckw = _map_tensors(kwargs, _value_of)
        out = func(*cargs, **ckw)
        w = _op_info(func).wr
        if w is None:
            return out
        return _rewrap_writes(func, w, args, kwargs, out)

    # -- materialization ----------------------------------------------------
    def _value(self):
        if self._concrete is None:
            n = self._node
            g = n.graph if n is not None else None
            _flush_ts(g.ts if g is not None else _ts())
        if self._concrete is None:
            raise RuntimeError("LazyArray was never materialized")
        _drain_deferred(_ts())
        return self._concrete

    def __repr__(self, *, tensor_contents=None):
        return repr(timed_block(self._value()))

    def __format__(self, spec):
        return format(timed_block(self._value()), spec)

    def __array__(self, dtype=None, copy=None):
        a = timed_block(self._value()).numpy()  # lint: ok(host-sync) — a host read: the flush and the wait are its point
        return a.astype(dtype) if dtype is not None else a

    def numpy(self, *, force=False):
        return timed_block(self._value()).numpy(force=force)

    def tolist(self):
        return timed_block(self._value()).tolist()

    def data_ptr(self):
        return concrete(self).data_ptr()

    def untyped_storage(self):
        return concrete(self).untyped_storage()

    def __dlpack__(self, *args, **kwargs):
        return concrete(self).__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._value().__dlpack_device__()

    def __reduce_ex__(self, proto):
        return concrete(self).__reduce_ex__(proto)

    def __deepcopy__(self, memo):
        import copy

        with suspended():
            out = copy.deepcopy(concrete(self), memo)
        memo[id(self)] = out
        return out


def _value_of(x):
    return x._value() if isinstance(x, LazyArray) else x


def concrete(x):
    """The concrete tensor of a LazyArray (identity for anything else),
    flushing if it is pending. A value held in a captured graph's pool is
    copied out first, so the caller may keep it across later replays."""
    if not isinstance(x, LazyArray):
        return x
    v = x._value()
    if id(v) in _pool_slots:
        with suspended():
            v = v.clone()
        x._concrete = v
    return v


# ids of tensors that are outputs of a captured graph (its pool): a
# LazyArray holding one is copied out before the graph replays again
_pool_slots: set = set()


def _map_tensors(x, fn):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (list, tuple)):
        out = [_map_tensors(v, fn) for v in x]
        return out if isinstance(x, list) else tuple(out)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    return x


# -- schema helpers -------------------------------------------------------------
def _write_returns(func):
    """For an op that writes arguments in place: a tuple, per return, of
    the name of the argument that return aliases (None for a fresh output),
    or () for an op that returns nothing. None for an op that writes
    nothing."""
    sch = func._schema
    written = {(next(iter(a.alias_info.before_set))
                if a.alias_info.before_set else a.name): a.name
               for a in sch.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    if not written:
        res = None
    else:
        res = []
        for r in sch.returns:
            ai = r.alias_info
            if ai is not None and ai.is_write:
                res.append(written.get(next(iter(ai.before_set)), None)
                           if ai.before_set else None)
            else:
                res.append(None)
        res = tuple(res)
    return res


def _arg_named(func, name, args, kwargs):
    for i, a in enumerate(func._schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else kwargs.get(name)
    return None


def _rewrap_writes(func, w, args, kwargs, out):
    if not w:
        return out
    outs = out if len(w) > 1 else (out,)
    res = [(_arg_named(func, name, args, kwargs) if name is not None else o)
           for name, o in zip(w, outs)]
    return tuple(res) if len(w) > 1 else res[0]


_MATERIALIZE_TAGS = (torch.Tag.data_dependent_output, torch.Tag.inplace_view)
# metadata writes that no tag marks
_MATERIALIZE_OPS = {"aten::resize_", "aten::resize_as_", "aten::set_"}


# -- the pending graph -----------------------------------------------------------
class _Graph:
    """One pending-graph epoch, with the structures a flush needs built at
    record time: wiring descriptors, the deduplicated leaf table, the
    per-leaf use counts, the signature parts."""

    __slots__ = ("nodes", "leaves", "leaf_pos", "leaf_avals", "direct_uses",
                 "descs", "keyparts", "written", "ts", "generators",
                 "leaf_metas", "khash")

    def __init__(self, ts=None):
        self.nodes: List[_Node] = []
        self.leaves: list = []  # concrete inputs, in first-use order
        self.leaf_pos: dict = {}  # id(leaf) -> index in leaves
        self.leaf_avals: list = []  # per-leaf signature parts
        self.direct_uses: dict = {}  # id(leaf) -> occurrences in inputs
        self.descs: list = []  # per-node wiring descriptors
        self.keyparts: list = []  # per-node (key, descs)
        self.written: set = set()  # leaf positions some node writes
        self.ts = ts
        self.generators: dict = {}  # id -> torch.Generator the ops draw from
        self.leaf_metas: list = []  # per-leaf probe metadata
        self.khash = 0  # running hash of the keyparts


def _graph(ts) -> _Graph:
    g = ts.graph
    if g is None:
        g = ts.graph = _Graph(ts)
    return g


def _leaf_sig(x):
    """A leaf's signature part: its layout, and for a leaf bound by address
    on the card, the address (a captured graph reads it there)."""
    bound = _bound(x)
    dev = x.device
    return (tuple(x.shape), tuple(x.stride()), x.storage_offset(), x.dtype,
            str(dev), bound,
            x.data_ptr() if bound and dev.type == "cuda" else None)


def _typed(v):
    """Scalars tagged with their type (1, 1.0 and True hash equal but are
    different programs)."""
    if isinstance(v, (bool, int, float, complex)):
        return (type(v).__name__, v)
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_typed(x) for x in v)
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted((k, _typed(x)) for k, x in v.items()))
    return v


class _Slot(int):
    """Where tensor input ``k`` goes in an op's argument template: an int
    subclass, so a template holds no object the cyclic collector tracks."""

    __slots__ = ()

    def __repr__(self):
        return f"<{int(self)}>"


_SLOTS = [_Slot(k) for k in range(1024)]


def _slot(k):
    return _SLOTS[k] if k < 1024 else _Slot(k)


def _flatten(args, kwargs):
    """(tensors, template args, template kwargs, {arg position or kwarg
    name: flat indices}). Tensors sit directly in the arguments or in
    lists/tuples of them (the foreach ops, cat)."""
    tensors = []
    index = {}
    targs = []
    for pos, v in enumerate(args):
        if isinstance(v, torch.Tensor):
            k = len(tensors)
            index[pos] = (k,)
            tensors.append(v)
            targs.append(_slot(k))
        elif type(v) in (list, tuple) and v:
            targs.append(_flatten_seq(pos, v, tensors, index))
        else:
            targs.append(v)
    tkw = {}
    if kwargs:
        for pos, v in kwargs.items():
            if isinstance(v, torch.Tensor):
                k = len(tensors)
                index[pos] = (k,)
                tensors.append(v)
                tkw[pos] = _slot(k)
            elif type(v) in (list, tuple) and v:
                tkw[pos] = _flatten_seq(pos, v, tensors, index)
            else:
                tkw[pos] = v
    return tensors, tuple(targs), tkw, index


def _flatten_seq(pos, v, tensors, index):
    if not any(isinstance(e, torch.Tensor) for e in v):
        return v
    ks = []
    out = []
    for e in v:
        if isinstance(e, torch.Tensor):
            k = len(tensors)
            ks.append(k)
            tensors.append(e)
            out.append(_slot(k))
        else:
            out.append(e)
    index[pos] = tuple(ks)
    return tuple(out) if type(v) is tuple else out


def _fill(t, vals):
    if type(t) is _Slot:
        return vals[t]
    if type(t) in (list, tuple) and t and any(type(e) is _Slot for e in t):
        out = [vals[e] if type(e) is _Slot else e for e in t]
        return out if type(t) is list else tuple(out)
    return t


_SCALARS = (bool, int, float, complex)


def _key_of(v):
    """A template value as a signature part."""
    t = type(v)
    if t is _Slot:
        return "T"
    if t in _SCALARS:
        return (t.__name__, v)
    if t is list or t is tuple:
        return (t.__name__,) + tuple([_key_of(e) for e in v])
    if t is torch.Generator:
        return ("gen", id(v))
    return _typed(v)


# -- output metadata probe (cached) ------------------------------------------------
_probe_cache: dict = {}
_PROBE_CACHE_MAX = 16384
_fake_mode = None


def _fake():
    global _fake_mode
    if _fake_mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _fake_mode = FakeTensorMode(allow_non_fake_inputs=False)
    return _fake_mode


def _meta(t):
    return (tuple(t.shape), tuple(t.stride()), t.storage_offset(), t.dtype,
            t.device)


def _fake_of(meta):
    shape, stride, off, dtype, device = meta
    need = off + 1 + sum((s - 1) * st for s, st in zip(shape, stride)
                         if s > 0) if all(s > 0 for s in shape) else off
    base = torch.empty((max(need, 1),), dtype=dtype, device=device)
    return base.as_strided(shape, stride, off)


def _probe(func, key, metas, targs, tkw):
    """The op's outputs as metadata: ``(structure, [meta...])``, where the
    structure says how the result maps to outputs ("t": one tensor, ("seq",
    kind, n): a tuple or list of n, ("val", v): a non-tensor value)."""
    ck = (key, metas)
    try:
        hit = _probe_cache.get(ck)
    except TypeError:
        ck, hit = None, None
    if hit is not None:
        return hit
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)

    with _disable_current_modes(), torch._C.DisableTorchFunction():
        with _fake():
            fakes = [_fake_of(m) for m in metas]
            try:
                out = func(*[_fill(a, fakes) for a in targs],
                           **{k: _fill(v, fakes) for k, v in tkw.items()})
            except (DynamicOutputShapeException,
                    DataDependentOutputException) as e:
                raise _Unrecordable(str(func)) from e
    res = _structure(out)
    if ck is not None:
        if len(_probe_cache) > _PROBE_CACHE_MAX:
            _probe_cache.clear()
        _probe_cache[ck] = res
    return res


def _structure(out):
    if isinstance(out, torch.Tensor):
        return ("t",), [_meta(out)]
    if isinstance(out, (tuple, list)):
        parts, metas = [], []
        for o in out:
            if isinstance(o, torch.Tensor):
                parts.append(("t", len(metas)))
                metas.append(_meta(o))
            elif o is None:
                parts.append(("val", None))
            else:
                return ("val", out), []
        return ("seq", type(out).__name__, tuple(parts)), metas
    return ("val", out), []


def _build_result(struct, outs):
    if struct[0] == "t":
        return outs[0]
    if struct[0] == "seq":
        vals = [outs[p[1]] if p[0] == "t" else p[1] for p in struct[2]]
        return vals if struct[1] == "list" else tuple(vals)
    return struct[1]


def _flat_result(struct, out):
    if struct[0] == "t":
        return (out,)
    if struct[0] == "seq":
        return tuple(o for o, p in zip(out, struct[2]) if p[0] == "t")
    return ()


# -- recording ---------------------------------------------------------------------
_recorded = [0]  # ops recorded by this process

# products whose kernels the global TF32 switches choose: the switches in
# effect when such an op is recorded are part of its node and its key, and
# are set again around it at the replay (the fused cross-entropy turns
# cuBLAS TF32 on around its own products only)
_MATMUL_OPS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
               "aten::addbmm", "aten::addmv", "aten::mv", "aten::dot",
               "aten::_addmm_activation", "aten::convolution",
               "aten::_convolution", "aten::convolution_backward"}


def _matmul_state():
    return (torch._C._get_cublas_allow_tf32(),
            torch._C._get_cudnn_allow_tf32())


def _set_matmul_state(st):
    torch._C._set_cublas_allow_tf32(st[0])
    torch._C._set_cudnn_allow_tf32(st[1])


def recorded_ops() -> int:
    """Ops recorded into pending graphs since the process started."""
    return _recorded[0]


class _OpInfo:
    """What recording needs to know of an operator, read from its schema
    once."""

    __slots__ = ("wr", "writes", "matmul", "materialize", "copy",
                 "generator", "passthrough", "name")

    def __init__(self, func):
        sch = func._schema
        self.name = str(func)  # the key's op part: a str hashes once
        self.wr = _write_returns(func)
        self.writes = tuple(
            (i, a.name) for i, a in enumerate(sch.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
        self.matmul = sch.name in _MATMUL_OPS
        self.materialize = any(t in getattr(func, "tags", ())
                               for t in _MATERIALIZE_TAGS) or \
            sch.name in _MATERIALIZE_OPS
        self.copy = func is _aten._to_copy.default
        self.generator = any("Generator" in str(a.type)
                             for a in sch.arguments)
        self.passthrough = func is _aten.lift_fresh.default


_op_infos: dict = {}


def _op_info(func) -> _OpInfo:
    info = _op_infos.get(func)
    if info is None:
        info = _op_infos[func] = _OpInfo(func)
    return info


# interned (key, descs) signature parts: identical iterations give the
# same objects, so a cache hit compares by identity
_interned: dict = {}
_INTERN_MAX = 1 << 20


def _record_op(ts, func, info, tensors, targs, tkw, index, args, kwargs):
    """Append one ATen op to ``ts``'s pending graph; returns what the op
    returns, with LazyArrays for its outputs."""
    g = _graph(ts)
    leaf_pos = g.leaf_pos
    nleaves = len(g.leaves)
    descs = []
    inputs = []
    metas = []
    new_leaves = None  # staged until the probe succeeds
    du_bump = {}
    for x in tensors:
        if type(x) is LazyArray:
            if x._concrete is None:
                n = x._node
                if n.graph is not g:
                    raise RuntimeError(
                        "lazy graph invariant violated: input from a "
                        "flushed-but-unmaterialized node")
                descs.append(("n", n.gix, x._idx))
                inputs.append(weakref.ref(x))
                metas.append(x.aval)
                continue
            x = x._concrete
        ix = id(x)
        j = leaf_pos.get(ix)
        if j is None:
            if new_leaves is None:
                new_leaves = {}
            j = new_leaves.get(ix)
            if j is None:
                j = new_leaves[ix] = (nleaves + len(new_leaves), x)
            j = j[0]
            metas.append(_meta(x))
        else:
            metas.append(g.leaf_metas[j])
        du_bump[ix] = du_bump.get(ix, 0) + 1
        descs.append(("l", j))
        inputs.append(x)
    state = _matmul_state() if info.matmul else None
    key = (info.name, tuple([_key_of(a) for a in targs]),
           tuple([(k, _key_of(v)) for k, v in tkw.items()]) if tkw else (),
           state)
    metas = tuple(metas)
    struct, out_metas = _probe(func, key, metas, targs, tkw)
    if new_leaves:
        for ix, (jj, x) in new_leaves.items():
            leaf_pos[ix] = jj
            g.leaves.append(x)
            g.leaf_avals.append(_leaf_sig(x))
            g.leaf_metas.append(_meta(x))
    du = g.direct_uses
    for ident, c in du_bump.items():
        du[ident] = du.get(ident, 0) + c
    if info.generator:
        for v in list(targs) + list(tkw.values()):
            if isinstance(v, torch.Generator):
                g.generators[id(v)] = v
    writes = ()
    if info.writes:
        writes = tuple(p for i, name in info.writes
                       for p in index.get(i if i < len(args) else name, ()))
        for p in writes:
            if descs[p][0] == "l":
                g.written.add(descs[p][1])
    node = _Node(key, func, targs, tkw, inputs, len(out_metas), struct,
                 writes, state)
    node.gix = len(g.nodes)
    node.graph = g
    # every output gets a LazyArray; an in-place op's written returns are
    # then swapped for the arguments the caller passed (those die unused)
    outs = [LazyArray(node, i, m) for i, m in enumerate(out_metas)]
    wr = info.wr
    if wr == ():
        res = None
    else:
        res = _build_result(struct, outs)
        if wr is not None:
            res = _rewrap_writes(func, wr, args, kwargs, res)
    node.out_refs = [weakref.ref(o) for o in outs]
    g.nodes.append(node)
    _recorded[0] += 1
    descs = tuple(descs)
    g.descs.append(descs)
    kp = (key, descs)
    hit = _interned.get(kp)
    if hit is None:
        if len(_interned) > _INTERN_MAX:
            _interned.clear()
        hit = _interned[kp] = kp
    g.keyparts.append(hit)
    # interned parts are one object per distinct part (the entry's
    # identity check on a hit catches a reused id after a clear)
    g.khash = hash((g.khash, id(hit)))
    if len(g.nodes) >= _MAX_PENDING:
        _flush_ts(ts)
    return res


_COPIES = {"aten::_to_copy", "aten::copy_", "aten::_copy_from",
           "aten::_copy_from_and_resize", "aten::to"}


def _crosses_devices(func, tensors, kwargs) -> bool:
    """A copy between the card and the host, or an op mixing them (a 0-dim
    CPU tensor beside card tensors is a scalar argument, not a copy,
    except to a copy op): it runs at once, after a flush."""
    copy = func._schema.name in _COPIES
    devs = {t.device.type for t in tensors
            if copy or t.dim() or t.device.type != "cpu"}
    d = kwargs.get("device")
    if d is not None:
        devs.add(torch.device(d).type)
    return len(devs) > 1


class _LazyMode(TorchDispatchMode):
    """The recording gate (see the module docstring)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    @classmethod
    def _should_skip_dynamo(cls):
        # nothing here runs under dynamo: keep the handler unwrapped (the
        # wrapper costs several frame-hook calls an op)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ts = self.ts
        info = _op_infos.get(func) or _op_info(func)
        if info.passthrough or ts.flushing:
            return func(*args, **kwargs)
        if info.materialize:
            return _eager_after_flush(ts, func, args, kwargs)
        tensors, targs, tkw, index = _flatten(args, kwargs)
        if info.copy and _fresh_host_copy(ts, tensors):
            return func(*args, **kwargs)
        if _ON_CARD:
            if not any(type(t) is LazyArray or t.device.type != "cpu"
                       for t in tensors) and (
                    kwargs.get("device") is None
                    or torch.device(kwargs["device"]).type == "cpu"):
                return func(*args, **kwargs)  # host-only work runs now
            if _crosses_devices(func, tensors, kwargs):
                return _eager_after_flush(ts, func, args, kwargs)
        try:
            return _record_op(ts, func, info, tensors, targs, tkw, index,
                              args, kwargs)
        except _Unrecordable:
            return _eager_after_flush(ts, func, args, kwargs)


def _fresh_host_copy(ts, tensors) -> bool:
    """A copy of host data no pending op touches (``torch.tensor`` of a
    numpy array): it runs now, as eager code copies, and the pending graph
    reads the copy as a leaf."""
    src = tensors[0] if tensors else None
    g = ts.graph
    return (src is not None and type(src) is not LazyArray
            and src.device.type == "cpu"
            and (g is None or id(src) not in g.leaf_pos))


class _Unrecordable(Exception):
    pass


def _eager_after_flush(ts, func, args, kwargs):
    """A materialization point: flush, then run the op on concrete
    tensors."""
    _flush_ts(ts)
    _drain_deferred(ts)
    cargs = _map_tensors(args, _value_of)
    ckw = _map_tensors(kwargs, _value_of)
    out = func(*cargs, **ckw)
    w = _op_info(func).wr
    return out if w is None else _rewrap_writes(func, w, args, kwargs, out)


_HOST_READS = None


def _host_reads():
    """The torch functions that read a tensor's memory on the host (and
    ``.data =``'s setter)."""
    global _HOST_READS
    if _HOST_READS is None:
        T = torch.Tensor
        _HOST_READS = {T.numpy, T.tolist, T.__repr__, T.__format__,
                       T.__array__, T.data_ptr, T.untyped_storage, T.storage,
                       T._typed_storage, T.__dlpack__, T.__deepcopy__,
                       torch._C.TensorBase.__dict__["data"].__set__}
    return _HOST_READS


_DATA_SET = torch._C.TensorBase.__dict__["data"].__set__


class _HostReadMode(TorchFunctionMode):
    """Host reads of any tensor flush first (a leaf with a pending
    in-place write is read after it); ``.data =`` takes a concrete value."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (_HOST_READS or _host_reads()):
            _flush_ts(self.ts)
            _drain_deferred(self.ts)
            if func == _DATA_SET:
                args = (args[0], concrete(args[1]))
            with suspended():
                return func(*args, **kwargs)
        return func(*args, **kwargs)


def record(name, fn, inputs, key=None):
    """Record ``fn(*inputs)`` (a function over tensors built from torch
    ops) into the pending graph: its ops are recorded one by one. Returns
    ``(outputs: list, single: bool)`` as the reference's ``record``."""
    ts = _ts()
    pushed = not lazy_enabled()
    if pushed:
        _push(ts)
    try:
        out = fn(*inputs)
    finally:
        if pushed:
            _pop(ts)
    single = not isinstance(out, (tuple, list))
    return ([out] if single else list(out)), single


# -- the graph cache -----------------------------------------------------------------
_cache_lock = threading.Lock()
_flush_cache: "collections.OrderedDict" = collections.OrderedDict()  # guarded_by: _cache_lock
_FLUSH_CACHE_MAX = 128


class _Entry:
    """One signature's graph: the sights seen, and on the card the captured
    ``CUDAGraph`` with its static inputs and pool outputs. ``action`` is the
    device-neutral state machine: ``eager`` (the first sight, or a device
    that cannot capture), ``capture`` (the second sight on the card), then
    ``replay``; ``fallback`` after a failed capture."""

    __slots__ = ("sights", "captures", "replays", "graph", "static", "outs",
                 "copy_in", "copy_back", "ptrs", "launches", "handed",
                 "failed", "just_captured", "pool_bytes", "mem", "keyparts")

    def __init__(self):
        self.sights = 0
        self.captures = 0
        self.replays = 0
        self.graph = None
        self.static = None
        self.outs = None
        self.copy_in = ()
        self.copy_back = ()
        self.ptrs = {}
        self.launches = {}
        self.handed = []
        self.failed = None
        self.just_captured = False
        self.pool_bytes = 0
        self.mem = None  # the warm-up replay's measured footprint
        self.keyparts = ()  # the interned signature parts it was made for

    def action(self, capturable: bool) -> str:
        self.sights += 1
        if self.failed is not None:
            return "fallback"
        if self.graph is not None:
            return "replay"
        if capturable and self.sights >= 2:
            return "capture"
        return "eager"


def evict_cold(keep: int = 4) -> int:
    """Drop cold graph-cache entries, keeping the ``keep`` most recently
    used (the memory-pressure rung: a captured graph pins its pool). An
    evicted signature is warmed up and captured again if it comes back.
    Returns the number evicted."""
    n = 0
    with _cache_lock:
        while len(_flush_cache) > max(int(keep), 0):
            _, e = _flush_cache.popitem(last=False)
            _release(e)
            n += 1
    if n:
        _prof().counter_inc("hbm_cache_evicted", n)
        if _ON_CARD:
            torch.cuda.empty_cache()
    return n


def _release(e: _Entry):
    if e.outs:
        for o in e.outs:
            _pool_slots.discard(id(o))
    e.graph = e.static = e.outs = None
    e.handed = []


def graph_stats() -> dict:
    """The graph cache: entries, and their sights, captures, replays and
    pool bytes."""
    with _cache_lock:
        es = list(_flush_cache.values())
    return {"entries": len(es), "sights": sum(e.sights for e in es),
            "captures": sum(e.captures for e in es),
            "replays": sum(e.replays for e in es),
            "captured": sum(1 for e in es if e.graph is not None),
            "failed": sum(1 for e in es if e.failed is not None),
            "pool_bytes": sum(e.pool_bytes for e in es),
            "per_entry": [{"sights": e.sights, "captures": e.captures,
                           "replays": e.replays, "launches": dict(e.launches),
                           "pool_bytes": e.pool_bytes, "failed": e.failed}
                          for e in es]}


# launches of the hand-written kernels that replays of captured graphs made
# (a replay does not run the wrappers, which count at capture)
_replayed_launches: dict = collections.Counter()


def replayed_launches() -> dict:
    return dict(_replayed_launches)


def reset_replayed_launches() -> None:
    _replayed_launches.clear()


# -- profiler / flags hooks ------------------------------------------------------------
def _prof():
    from .. import profiler

    return profiler


def _spans():
    from ..profiler import spans

    return spans


def _flag(name, default):
    from ..framework import flags

    return flags.flag(name, default)


def pending_summary() -> dict:
    """This thread's pending graph for a post-mortem (flight recorder):
    node count, the tail of op names awaiting execution, and the deferred
    NaN/Inf checks not yet read."""
    ts = getattr(_state, "ts", None)
    g = ts.graph if ts is not None else None
    nodes = g.nodes if g is not None else []
    return {
        "pending_nodes": len(nodes),
        "tail_ops": [str(n.key[0]) for n in nodes[-8:]],
        "deferred_checks": sum(1 for e in (ts.deferred if ts else ())
                               if e[1] is not None),
    }


# -- host waits and deferred work ---------------------------------------------------------
def _timed_block(ev, where: str):
    t0 = time.perf_counter_ns()
    with _spans().span("block", where=where):
        if ev is not None:
            ev.synchronize()
    p = _prof()
    p.counter_inc("lazy_blocks")
    p.counter_inc("lazy_block_ns", time.perf_counter_ns() - t0)


def timed_block(x, where: str = "readback"):
    """Wait for the last flush's work before a host read of ``x`` (a
    tensor or a sequence of them) under a ``block`` span that feeds
    ``lazy_block_ns``. Identity for CPU tensors, finished work, non-tensors,
    and with ``FLAGS_lazy_async`` off (every flush waited already)."""
    xs = x if isinstance(x, (list, tuple)) else (x,)
    if not any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in xs):
        return x
    ts = _ts()
    ev = ts.inflight
    if ev is None or not _flag("FLAGS_lazy_async", True):
        return x
    if ev.query():
        ts.inflight = None
        return x
    ts.inflight = None
    _timed_block(ev, where)
    return x


def _enqueue_deferred(ts, sp, payload, census, results):
    ts.deferred.append((sp, payload, census, results))
    if _flag("FLAGS_lazy_verify", False):
        from ..analysis.verify_graph import _verify_deferred

        _verify_deferred(ts.deferred)


def _drain_deferred(ts):
    """Run the post-flush work deferred off the critical path: the memory
    census (attrs on the producing ``lazy_flush`` span) and the NaN/Inf
    check, which reads the fused finite flags and raises with the
    producing-span attribution. Called at flush entry, at every
    materialization point and by :func:`sync`."""
    d = ts.deferred
    if not d:
        return
    entries = list(d)
    del d[:]
    with suspended(), torch.no_grad():  # the scan's own ops run now
        _drain_entries(entries)


def _drain_entries(entries):
    spans_mod = _spans()
    for sp, payload, census, results in entries:
        if census:
            mem = _prof().memory_census()
            if sp is not None:
                spans_mod.update_attrs(
                    sp, live_bytes=mem["live_bytes"],
                    live_arrays=mem["live_arrays"],
                    peak_live_bytes=mem["peak_live_bytes"],
                    delta_bytes=mem["last_delta_bytes"])
        if payload is not None:
            with spans_mod.span("lazy_deferred_check", producing_span=(
                    sp.span_id if sp is not None else 0)):
                _read_scan(payload, deferred=True, producing=sp)


def sync():
    """Barrier: flush, surface any deferred NaN/Inf trip, and wait
    (attributed) for the card to finish the last flushed step."""
    ts = _ts()
    _flush_ts(ts)
    _drain_deferred(ts)
    tap = _stability_tap
    if tap is not None:
        tap()
    ev = ts.inflight
    ts.inflight = None
    if ev is not None or not _ON_CARD:
        _timed_block(ev, "sync")


# -- flush ---------------------------------------------------------------------------------
def flush():
    """Run the pending graph and write the results into the live
    LazyArrays. With ``FLAGS_lazy_async`` (default) the host returns once
    the work is enqueued on the card."""
    _flush_ts(_ts())


def _flush_ts(ts):
    if ts.flushing:
        return
    _drain_deferred(ts)
    tap = _stability_tap
    if tap is not None:
        tap()
    g = ts.graph
    if g is None or not g.nodes:
        return
    ts.flushing = True
    try:
        ts.graph = None  # a fresh epoch for anything recorded meanwhile
        # the replay runs below autograd, which saw the ops when they
        # were recorded (an in-place update of a parameter runs as such)
        with _disable_current_modes(), torch._C.DisableTorchFunction(), \
                torch.no_grad():
            with _spans().span("lazy_flush", nodes=len(g.nodes)) as sp:
                _flush_impl(ts, g, sp)
    finally:
        ts.flushing = False


def _donation_mask(leaves, cand, direct_uses):
    """Leaf positions provably dead after this flush: rebound through the
    graph (:func:`note_rebound`) and referenced only by the graph's own
    tables. Runs in its own frame so the caller's locals cannot inflate
    the count."""
    out = []
    for j in range(len(leaves)):
        x = leaves[j]
        i = id(x)
        if i not in cand:
            x = None
            continue
        # a dead leaf: one reference per use in a node's inputs, the
        # leaves list, the binding x and getrefcount's argument
        if sys.getrefcount(x) == direct_uses.get(i, 0) + 3:
            out.append(j)
        x = None
    return tuple(out)


def note_rebound(old):
    """Record that ``old`` (a tensor, or a LazyArray holding one) was
    replaced in its holder by a pending-graph output: a donation
    candidate. No-op when nothing is pending."""
    ts = _ts()
    g = ts.graph
    if g is None or not g.nodes:
        return
    if isinstance(old, LazyArray):
        old = old._concrete
    if isinstance(old, torch.Tensor) and len(ts.donate_ids) < 65536:
        ts.donate_ids.add(id(old))


def _flush_impl(ts, g: _Graph, sp=None):
    nodes = g.nodes
    leaves = g.leaves
    prof = _prof()
    with _spans().span("trace", nodes=len(nodes)) as trace_span:
        # the liveness sweep: the (node, output) pairs still referenced
        live = []
        for i, n in enumerate(nodes):
            for j, r in enumerate(n.out_refs):
                if r() is not None:
                    live.append((i, j))
        trace_span.set(leaves=len(leaves))
    check_nan = bool(_flag("FLAGS_check_nan_inf", False))
    async_on = bool(_flag("FLAGS_lazy_async", True))
    donate_ix: tuple = ()
    cand = ts.donate_ids
    if cand and _flag("FLAGS_lazy_donate", True):
        if check_nan:
            prof.counter_inc("naninf_donation_suppressed")
            if sp is not None:
                sp.set(donation="suppressed_naninf")
        else:
            donate_ix = _donation_mask(leaves, cand, g.direct_uses)
    ts.donate_ids = set()
    if _flag("FLAGS_lazy_verify", False):
        from ..analysis.verify_graph import verify_before_dispatch

        verify_before_dispatch(g, donate_ix)
    # the signature: the ops and wiring (a running hash of the interned
    # parts, checked part by part on a hit), the liveness, the leaves
    try:
        sig = (g.khash, len(nodes), tuple(live), tuple(g.leaf_avals),
               donate_ix)
        hash(sig)
    except TypeError:
        sig = None
    prof.counter_inc("lazy_flushes")
    capturable = _ON_CARD and all(x.device.type == "cuda" for x in leaves)
    with _cache_lock:
        entry = _flush_cache.get(sig) if sig is not None else None
        if entry is not None and (
                len(entry.keyparts) != len(g.keyparts) or not all(
                    map(operator.is_, entry.keyparts, g.keyparts))):
            entry, sig = None, None  # a hash collision: run it uncached
        hit = entry is not None
        if entry is None:
            entry = _Entry()
            entry.keyparts = tuple(g.keyparts)
            if sig is not None:
                _flush_cache[sig] = entry
                if len(_flush_cache) > _FLUSH_CACHE_MAX:
                    _, old = _flush_cache.popitem(last=False)
                    _release(old)
        else:
            _flush_cache.move_to_end(sig)
    if hit:
        prof.counter_inc("lazy_cache_hits")
    inject = _armed_injector()
    per_op = check_nan and bool(_flag("FLAGS_check_nan_inf_per_op", False))
    if inject is not None or per_op:
        capturable = False  # a poisoned or per-op-checked step runs eagerly
    action = entry.action(capturable)
    if sp is not None:
        sp.set(cache="hit" if hit else "miss", action=action,
               cache_key=(f"{hash(sig) & 0xFFFFFFFFFFFFFFFF:016x}"
                          if sig is not None else None))
    if action == "replay" and _flag("FLAGS_lazy_verify", False):
        from ..analysis.verify_graph import verify_bound_addresses

        verify_bound_addresses(entry, leaves)
    results = _admitted_execute(ts, g, entry, action, live, donate_ix, sp,
                                prof, check_nan, per_op, inject, sig)
    for (i, j), val in zip(live, results):
        o = nodes[i].out_refs[j]()
        if o is not None:
            o._concrete = val
    if action in ("replay", "capture"):
        entry.handed = [nodes[i].out_refs[j] for (i, j) in live]
    if donate_ix:
        prof.counter_inc("lazy_donated_buffers", len(donate_ix))
    on_card = _ON_CARD
    if on_card:
        ev = torch.cuda.Event()
        ev.record()
        ts.inflight = ev
    mem_active = prof._memory_active()
    if check_nan and not per_op:
        payload = _start_scan(nodes, live, results, g)
        if async_on:
            prof.counter_inc("lazy_deferred_checks")
            _enqueue_deferred(ts, sp, payload, mem_active, results)
        else:
            _read_scan(payload, deferred=False, producing=None)
    elif mem_active:
        if async_on:
            _enqueue_deferred(ts, sp, None, True, results)
        else:
            mem = prof.memory_census()
            if sp is not None:
                sp.set(live_bytes=mem["live_bytes"],
                       live_arrays=mem["live_arrays"],
                       peak_live_bytes=mem["peak_live_bytes"],
                       delta_bytes=mem["last_delta_bytes"])
    if on_card and not async_on:
        ts.inflight.synchronize()
        ts.inflight = None
    # release the graph's references to its inputs
    for n in nodes:
        n.inputs = ()
        n.args = n.kwargs = None
        n.graph = None


def _admitted_execute(ts, g, entry, action, live, donate_ix, sp, prof,
                      check_nan, per_op, inject, sig):
    """``_execute`` under ``FLAGS_hbm_admission``: a signature's first
    flush is measured (``cost_model.MeasuredStep``), and every later one
    (the capture, the replays) is admitted by ``fault.memory.preflight``
    first; an ``enforce`` rejection leaves the graph pending and the
    entry's sights as they were. With the flag off, one flag probe."""
    admission = _flag("FLAGS_hbm_admission", "off")
    if admission == "off":
        return _execute(ts, g, entry, action, live, donate_ix, sp, prof,
                        check_nan, per_op, inject)
    from ..fault import memory as _hbm

    device = "cuda" if _ON_CARD else "cpu"
    if entry.mem is not None:
        try:
            _hbm.preflight(entry.mem, "lazy_flush", span=sp, device=device)
        except Exception:
            entry.sights -= 1
            if ts.graph is None or not ts.graph.nodes:
                ts.graph = g  # nothing ran: the same flush can be retried
            raise
        return _execute(ts, g, entry, action, live, donate_ix, sp, prof,
                        check_nan, per_op, inject)
    from ..cost_model import MeasuredStep

    with MeasuredStep(device) as run:
        out = _execute(ts, g, entry, action, live, donate_ix, sp, prof,
                       check_nan, per_op, inject)
    key = f"lazy_flush:{hash(sig) & 0xFFFFFFFFFFFFFFFF:016x}" \
        if sig is not None else None
    entry.mem = _hbm.analyze_compiled(run, key=key)
    if entry.mem is not None and sp is not None:
        sp.set(hbm_exec_peak_bytes=entry.mem["peak_bytes"])
    return out


def _armed_injector():
    from ..fault import inject

    return inject if inject._armed else None


def _execute(ts, g, entry, action, live, donate_ix, sp, prof, check_nan,
             per_op, inject):
    leaves = g.leaves
    try:
        if action == "replay":
            return _replay_graph(entry, leaves, donate_ix, prof)
        if action == "capture":
            return _capture(entry, g, live, sp, prof)
        if action == "fallback":
            prof.counter_inc("lazy_replay_fallbacks")
            if sp is not None:
                sp.set(fallback=entry.failed)
        on_node = _per_op_checker(g) if per_op else None
        with _spans().span("execute", cache=action):
            env = _replay(g, leaves, set(live), on_node=on_node,
                          inject=inject)
        return [env[i][j] for (i, j) in live]
    except Exception as e:
        from ..fault import memory as _hbm

        if _hbm.is_oom(e):
            return _oom_recover(e, ts, g, entry, action, live, donate_ix,
                                sp, prof)
        if action in ("replay", "capture"):
            return _fallback_execute(e, g, entry, live, sp, prof)
        raise


def _replay(g, leaf_vals, keep, on_node=None, inject=None):
    """Run the recorded ops in order on real tensors; returns the per-node
    outputs, of which only ``keep`` (the live ``(node, output)`` pairs)
    are still held: every other value is dropped after its last use, so
    the replay's memory follows eager execution's. ``inject`` is the armed
    fault injector (the ``tensor.nan`` point poisons a named op's output),
    ``on_node(i, outs)`` observes each node as it lands."""
    nodes = g.nodes
    descs = g.descs
    n = len(nodes)
    release: list = [[] for _ in range(n)]
    last = {}
    for i, ds in enumerate(descs):
        for d in ds:
            if d[0] == "n":
                last[(d[1], d[2])] = i
    for i, node in enumerate(nodes):
        for j in range(node.n_out):
            if (i, j) not in keep:
                release[last.get((i, j), i)].append((i, j))
    env: list = [None] * n
    state0 = cur = _matmul_state()
    try:
        for i, node in enumerate(nodes):
            vals = [leaf_vals[d[1]] if d[0] == "l" else env[d[1]][d[2]]
                    for d in descs[i]]
            if node.state is not None and node.state != cur:
                _set_matmul_state(node.state)
                cur = node.state
            out = node.fn(*[_fill(a, vals) for a in node.args],
                          **{k: _fill(v, vals) for k, v in node.kwargs.items()})
            flat = list(_flat_result(node.outs_of, out)) if node.n_out else []
            env[i] = flat
            del out
            if inject is not None and inject.should_fire("tensor.nan",
                                                         op=str(node.fn)):
                inject.poison_first_nan(tuple(flat) if flat else tuple(
                    vals[p] for p in node.writes))
            if on_node is not None:
                on_node(i, tuple(flat) if flat else tuple(
                    vals[p] for p in node.writes))
            del vals
            for a, b in release[i]:
                env[a][b] = None
    finally:
        if cur != state0:
            _set_matmul_state(state0)
    return env


def _kernel_launches():
    from ..ops import kernels as K

    return K.launch_counts()


def _capture(entry, g, live, sp, prof):
    """Capture this flush's ops into a CUDA graph (the signature's second
    sight), then replay it once to run the step."""
    leaves = g.leaves
    static = list(leaves)
    copy_in = []
    for j, x in enumerate(leaves):
        if not g.leaf_avals[j][5]:
            s = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                    device=x.device)
            copy_in.append(j)
            static[j] = s
    for j in copy_in:
        static[j].copy_(leaves[j])
    graph = torch.cuda.CUDAGraph()
    for gen in g.generators.values():
        if gen.device.type == "cuda":
            graph.register_generator_state(gen)
    pool = torch.cuda.graph_pool_handle()
    k0 = _kernel_launches()
    m0 = torch.cuda.memory_reserved()
    with _spans().span("capture", nodes=len(g.nodes)):
        if _flag("FLAGS_lazy_bg_compile", False):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    env = _replay(g, static, set(live))
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        else:
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                env = _replay(g, static, set(live))
    k1 = _kernel_launches()
    entry.launches = {k: k1[k] - k0.get(k, 0) for k in k1
                      if k1[k] != k0.get(k, 0)}
    entry.pool_bytes = max(torch.cuda.memory_reserved() - m0, 0)
    entry.graph = graph
    entry.static = static
    entry.copy_in = tuple(copy_in)
    entry.copy_back = tuple(j for j in copy_in if j in g.written)
    entry.ptrs = {j: leaves[j].data_ptr() for j in range(len(leaves))
                  if g.leaf_avals[j][5]}
    entry.outs = [env[i][j] for (i, j) in live]
    for o in entry.outs:
        _pool_slots.add(id(o))
    entry.captures += 1
    entry.just_captured = True
    prof.counter_inc("lazy_graph_captures")
    if sp is not None:
        sp.set(captured=True, pool_bytes=entry.pool_bytes)
    return _replay_graph(entry, leaves, (), prof)


def _replay_graph(entry, leaves, donate_ix, prof):
    """Copy the fresh leaves in, replay, copy written leaves back; values
    of the last replay that are still alive are copied out first."""
    outs = entry.outs
    for r, o in zip(entry.handed, outs):
        la = r()
        if la is not None and la._concrete is o:
            la._concrete = o.clone()
    static = entry.static
    for j in entry.copy_in:
        static[j].copy_(leaves[j])
    entry.graph.replay()
    skip = set(donate_ix)
    for j in entry.copy_back:
        if j not in skip:
            leaves[j].copy_(static[j])
    entry.replays += 1
    prof.counter_inc("lazy_graph_replays")
    if entry.just_captured:
        entry.just_captured = False  # the wrappers counted at the capture
    else:
        _replayed_launches.update(entry.launches)
    return list(outs)


def _fallback_execute(exc, g, entry, live, sp, prof):
    """A capture or replay that failed: the step's ops run again eagerly
    on the same device with the same kernels, counted and never silent.
    The signature is not captured again."""
    entry.failed = f"{type(exc).__name__}: {exc}"[:200]
    if entry.graph is not None:
        _release(entry)
    prof.counter_inc("lazy_replay_fallbacks")
    if sp is not None:
        sp.set(fallback=entry.failed)
    import warnings

    warnings.warn(f"lazy flush: graph {('capture' if entry.captures == 0 else 'replay')} failed "
                  f"({entry.failed}); the step ran eagerly", RuntimeWarning,
                  stacklevel=3)
    with _spans().span("execute", fallback="eager_replay"):
        env = _replay(g, g.leaves, set(live))
    return [env[i][j] for (i, j) in live]


def _oom_recover(exc, ts, g, entry, action, live, donate_ix, sp, prof):
    """Out of device memory in a flush: evict cold graphs (their pools),
    retry the same action once, then raise ``HbmExhausted`` with a flight
    post-mortem."""
    from ..fault import memory as _hbm

    attempts = [{"action": "classify", **_hbm.note_oom("lazy_flush", exc)}]
    if sp is not None:
        sp.set(hbm_oom=type(exc).__name__)
    attempts.append({"action": "free_pressure",
                     **_hbm.free_pressure("lazy_flush")})
    try:
        with _spans().span("execute", retry="hbm_oom"):
            from ..fault import inject

            if inject._armed:
                inject.maybe_hbm_oom("lazy_flush")
            if action == "replay" and entry.graph is not None:
                out = _replay_graph(entry, g.leaves, donate_ix, prof)
            else:
                entry.graph = None
                env = _replay(g, g.leaves, set(live))
                out = [env[i][j] for (i, j) in live]
    except Exception as e2:
        if not _hbm.is_oom(e2):
            raise
        attempts.append({"action": "retry", "ok": False})
        path = _hbm.post_mortem("lazy_flush", attempts, e2)
        raise _hbm.HbmExhausted("lazy_flush", attempts, path) from e2
    prof.counter_inc("hbm_oom_recoveries")
    attempts.append({"action": "retry", "ok": True})
    if sp is not None:
        sp.set(hbm_oom_recovered=True)
    return out


# -- the NaN/Inf scan over a flush ------------------------------------------------------
def _start_scan(nodes, live, results, g):
    """Enqueue one fused finite check over the flush's live floating
    outputs and the leaves it wrote: a per-tensor norm (a NaN or an
    infinity makes it non-finite) in one multi-tensor launch. Returns the
    payload the drain reads."""
    names, ts_ = [], []
    for (i, j), v in zip(live, results):
        if v.is_floating_point():
            names.append((str(nodes[i].key[0]), j))
            ts_.append(v)
    for jl in sorted(g.written):
        x = g.leaves[jl]
        if x.is_floating_point():
            w = next((n for n in reversed(nodes)
                      if any(d == ("l", jl) for k, d in enumerate(
                          g.descs[n.gix]) if k in n.writes)), None)
            names.append((str(w.key[0]) if w is not None else "leaf", 0))
            ts_.append(x)
    if not ts_:
        return (names, [], None)
    with torch.no_grad():
        norms = torch._foreach_norm([t.detach() for t in ts_], 2)
        flags = torch.isfinite(torch.stack([n.float() for n in norms]))
    return (names, ts_, flags)


def _read_scan(payload, deferred, producing=None):
    """Read the fused finite flags (a host wait on the card, under a
    ``block`` span) and raise on the first tensor that is not finite."""
    from .dispatch import _nonfinite_error

    names, ts_, flags = payload
    if flags is None:
        return
    if flags.device.type == "cuda":
        t0 = time.perf_counter_ns()
        with _spans().span("block", where="deferred_naninf"):
            ok = flags.cpu()
        _prof().counter_inc("lazy_blocks")
        _prof().counter_inc("lazy_block_ns", time.perf_counter_ns() - t0)
    else:
        ok = flags
    if bool(ok.all()):
        return
    for k in (~ok).nonzero()[:, 0].tolist():
        t = ts_[k]
        if bool(torch.isfinite(t).all()):
            continue  # a norm that overflowed over finite values
        name, j = names[k]
        _prof().counter_inc("naninf_trips")
        extra = {"producing_span": producing.to_dict()} \
            if producing is not None else None
        raise _nonfinite_error(name, j, t, origin="lazy flush" + (
            " (deferred)" if deferred else ""), extra=extra)


def _per_op_checker(g):
    """``FLAGS_check_nan_inf_per_op``: the flush runs unfused and every
    node's outputs (or written arguments) are checked as they land."""
    from .dispatch import _nonfinite_error

    def check(i, outs):
        for j, o in enumerate(outs):
            if isinstance(o, torch.Tensor) and o.is_floating_point() \
                    and not bool(torch.isfinite(o).all()):
                _prof().counter_inc("naninf_trips")
                raise _nonfinite_error(str(g.nodes[i].key[0]), j, o,
                                       origin="lazy per-op replay")

    return check


# -- helpers -------------------------------------------------------------------------
def maybe_lazy_binary(fn, a, b, name="lazy_bin"):
    """``fn(a, b)``, recorded when lazy mode is on (or an operand is lazy)."""
    if lazy_enabled() or is_lazy(a) or is_lazy(b):
        (out,), _ = record(name, fn, [a, b])
        return out
    return fn(a, b)


def lazy_full(shape, dtype, value, name="lazy_full", device=None):
    """``torch.full`` that joins the pending graph when lazy mode is on."""
    shape = tuple(shape)
    if lazy_enabled():
        (out,), _ = record(name, lambda: torch.full(
            shape, value, dtype=dtype, device=device), [])
        return out
    return torch.full(shape, value, dtype=dtype, device=device)


def host_scalars(values, dtype, device) -> list:
    """0-dim tensors on ``device`` holding ``values`` (each rounded to
    ``dtype``), made at once, outside any recording: one host-to-device
    copy from pinned memory that does not wait for the card. Under lazy
    mode they are fresh leaves of the pending graph, so a value that
    changes every step (a learning rate) changes no signature."""
    dev = torch.device(device)
    with suspended():
        t = torch.tensor(list(values), dtype=dtype)
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        elif dev != t.device:
            t = t.to(dev)
        return list(t.unbind(0))
