"""The AMP hook (port of ``paddle_tpu/core/dispatch.py`` ``set_amp_hook`` :49
and its call in ``eager_call`` :268–269) and the ``FLAGS_check_nan_inf``
scan (``_nonfinite_error``/``_check_nan_inf`` :150–204, read by
``eager_call`` at :279, :306 and :389).

The port has no ``eager_call`` layer, so each port function whose reference
counterpart goes through ``eager_call`` under a name on ``amp``'s lists
calls :func:`amp_cast` at its entry with that name and its tensor inputs:
``linear``, ``matmul``, ``sum``, ``mean``, ``exp``, ``log``, ``square``,
``layer_norm``, ``cross_entropy`` and the exact route of
``scaled_dot_product_attention``. ``torch.autocast`` is not used: its lists
are ATen's, and it would recast the ops inside the port's composites (the
exact attention's softmax, the optimizers' sums) where the reference casts
only at the ``eager_call`` boundary. With AMP off, :func:`amp_cast` costs
one ``is None`` check.

While ``FLAGS_check_nan_inf`` is set, every floating output of every op is
checked, and the first one that holds a NaN or an infinity raises
``FloatingPointError`` with the reference's message: the op, the output's
index, shape and dtype, how many values are non-finite, the first one's flat
index and value, and the origin. Before the raise a ``naninf`` flight dump is
written (``profiler/flight.py``, with the reference's ``extra`` keys) and the
``naninf_trips`` counter goes up by one.

The scan is a ``TorchDispatchMode``: ``set_flags`` pushes it when the flag is
set and pops it when the flag is cleared, so with the flag off no mode sits
on the stack and an op costs nothing extra. With it on, each op pays a
device reduction and a host sync, the reference's documented cost of the
debug mode. Modes are per thread: the scan covers the thread that set the
flag, and the autograd engine's threads run its backward under it; the flag
must be cleared on the thread that set it.

What the port names and reaches differs from the reference in three ways:

* op names are ATen's (``aten.addmm.default``), not the reference's
  ``eager_call`` names (``"linear"``, ``"rms_norm"``): the port has no
  ``eager_call`` layer, and the mode sees the ops its tensors dispatch;
* the origin is always ``eager``: the port checks op by op (nothing is
  fused), so ``FLAGS_check_nan_inf_per_op``, which re-runs the reference's
  fused lazy flush unfused, is accepted and changes nothing, and the
  reference's hint about it (given for a lazy flush only) never appears;
* the reference checks its eager ops and its eager ``Optimizer.step()``,
  while its ``CompiledTrainStep`` is traced and cannot read the values: with
  the flag set, its every call raises jax's ``TracerBoolConversionError``,
  a ``TypeError``. The port's ``jit.CompiledTrainStep`` raises a
  ``TypeError`` too. Code that the reference runs as one jitted program
  outside ``eager_call`` (dense ``generate``, the serving engine's builders)
  is checked op by op here, and their ``-inf`` attention masks trip the scan:
  run them with the flag cleared.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack,
                                          _pop_mode, _push_mode)

__all__ = ["scan_active", "set_amp_hook", "amp_cast"]

# AMP hook, set by paddle_tpu_torch.amp.auto_cast; (op_name, tensors) -> tensors
_amp_hook = None


def set_amp_hook(hook) -> None:
    global _amp_hook
    _amp_hook = hook


def amp_cast(name: str, tensors):
    """``tensors`` as the op ``name`` should see them under the active
    ``auto_cast`` (the same sequence when AMP is off)."""
    if _amp_hook is None:
        return tensors
    return _amp_hook(name, tensors)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _nonfinite_error(name, idx, t, origin="eager", extra=None):
    """The reference's diagnostic for output ``idx`` of op ``name``, after
    a ``naninf`` flight dump."""
    a = t.detach().reshape(-1)
    bad = ~torch.isfinite(a)
    cnt = int(bad.sum())
    flat_idx = int(bad.nonzero()[0, 0]) if cnt else -1
    first = None
    if cnt:
        v = a[flat_idx].cpu()
        first = v.numpy()[()] if v.dtype in (torch.float16, torch.float32,
                                             torch.float64) else float(v)
    msg = (
        f"Operator '{name}' output {idx} (shape={tuple(t.shape)}, "
        f"dtype={_dtype_name(t.dtype)}) contains {cnt} non-finite value(s); "
        f"first at flat index {flat_idx} = {first!r} [{origin}] "
        "(FLAGS_check_nan_inf is set).")
    try:
        from ..profiler import flight

        flight.dump("naninf", extra={
            "op": name, "output": idx, "origin": origin,
            "nonfinite_count": cnt, "first_flat_index": flat_idx,
            "message": msg, **(extra or {})})
    except Exception:  # lint: ok(oom-handler) — flight-dump guard, nothing launches in this try
        pass  # a crash dump must never mask the diagnostic
    return FloatingPointError(msg)


def _outputs(out):
    if isinstance(out, torch.Tensor):
        return (out,)
    if isinstance(out, (tuple, list)):
        return tuple(o for x in out for o in _outputs(x))
    return ()


def _check_nan_inf(name, outs, origin="eager"):
    from .. import profiler

    for i, o in enumerate(outs):
        if o.is_floating_point() and not bool(torch.isfinite(o).all()):
            profiler.counter_inc("naninf_trips")
            raise _nonfinite_error(name, i, o, origin=origin)


# ops that compute nothing: lifting host data into a tensor
# (``torch.tensor(...)``; the reference's ``to_tensor`` is not an op either)
# and allocations whose memory a kernel writes next (uninitialized bits may
# read as NaN)
_UNCHECKED = {"aten::lift_fresh", "aten::empty", "aten::empty_like",
              "aten::empty_strided", "aten::empty_permuted", "aten::new_empty",
              "aten::new_empty_strided"}


def _written(func, args, kwargs):
    """The arguments an op writes in place (``torch._foreach_add_`` returns
    nothing: its outputs are its first argument's tensors)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out.extend(_outputs(v))
    return tuple(out)


class _NanInfScan(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._schema.name not in _UNCHECKED:
            outs = _outputs(out) or _written(func, args, kwargs)
            _check_nan_inf(str(func), outs)
        return out


_mode: Optional[_NanInfScan] = None
_owner: Optional[int] = None


def scan_active() -> bool:
    """Whether the scan's mode sits on this thread's dispatch-mode stack."""
    return any(isinstance(m, _NanInfScan)
               for m in _get_current_dispatch_mode_stack())


def _sync_scan() -> None:
    """Push the scan's mode when ``FLAGS_check_nan_inf`` is set and it is
    not pushed yet; pop it when the flag is cleared."""
    global _mode, _owner
    from ..framework.flags import flag

    on = bool(flag("FLAGS_check_nan_inf", False))
    if on and _mode is None:
        _mode, _owner = _NanInfScan(), threading.get_ident()
        _push_mode(_mode)
    elif not on and _mode is not None:
        stack = _get_current_dispatch_mode_stack()
        if _owner != threading.get_ident() or not stack \
                or stack[-1] is not _mode:
            raise RuntimeError(
                "FLAGS_check_nan_inf: clear the flag on the thread that set "
                "it, after every dispatch mode entered since has exited")
        _pop_mode()
        _mode = _owner = None
