"""Table-driven ops (port of ``paddle_tpu/ops/generated.py``).

``ops.json`` holds the reference's op-spec table (``paddle_tpu/ops/ops.yaml``:
the same 183 names in the same sections, read with ``json``), each entry's
``expr`` a Python expression over ``torch`` (``torch.special``,
``torch.linalg``), ``F`` (``torch.nn.functional``), ``math``, ``np`` and the
helpers below. Each entry's fields:

- ``args``: tensor argument names (default ``["x"]``; ``[]``: none);
- ``attrs``: keyword attributes with their defaults;
- ``grad``: differentiable (default true; false runs under ``no_grad``);
- ``nondiff``: output positions that carry no gradient;
- ``n_outs``: 2 for a pair, ``"list"`` for a tuple of any length;
- ``variadic``: one list-of-tensors argument ``xs``;
- ``domain``/``domain2``/...: the inputs' sampling domain (``any``,
  ``pos``, ``unit``, ``smallint``, ``index``), ``shape``/``shape2``/...:
  their test shapes (``sq`` 4 x 4, ``vec`` 6, default 2 x 3), and ``bf16``
  (false: no bfloat16 run), all read by the sweeps;
- ``method``: attach as a ``torch.Tensor`` method when torch has no
  attribute of that name (default true);
- ``alias_of``: another op's name; ``skip_test``: the sweep's generic
  sampler cannot feed it.

``GENERATED`` maps every name to its op. Each op calls
:func:`~paddle_tpu_torch.core.dispatch.amp_cast` with its name and tensor
inputs at entry, as the reference's ``eager_call`` casts by name.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from ..core.dispatch import amp_cast
from ..core.place import resolve_device
from . import math as _math
from .creation import _as

_SPEC_PATH = os.path.join(os.path.dirname(__file__), "ops.json")


# -- helpers the expressions call (jnp functions torch has no twin of) -------
def _nan_extreme(x, axis, keepdim, fn):
    """``jnp.nanmax``/``nanmin``: NaNs skipped, an all-NaN slice NaN."""
    d = _math._dims(x, axis)
    fill = -math.inf if fn is torch.amax else math.inf
    out = fn(torch.where(torch.isnan(x), fill, x), d, keepdim=keepdim)
    empty = torch.isnan(x).all(d, keepdim=keepdim)
    return torch.where(empty, math.nan, out)


def _nanvar(x, axis, keepdim):
    """``jnp.nanvar`` (ddof 0) over the non-NaN entries."""
    d = _math._dims(x, axis)
    ok = ~torch.isnan(x)
    mu = torch.nanmean(x, d, keepdim=True)
    dev = torch.where(ok, x - mu, 0.0)
    return (dev * dev).sum(d, keepdim=keepdim) / ok.sum(d, keepdim=keepdim)


def _unwrap(x, axis):
    """``jnp.unwrap`` (period 2 pi): each jump above pi is taken down by the
    multiple of 2 pi that brings it within (-pi, pi]."""
    n = x.shape[axis]
    dd = torch.diff(x, dim=axis)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    corr = torch.where(torch.abs(dd) < math.pi, 0.0, ddmod - dd)
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 1, n - 1)
                      + torch.cumsum(corr, axis)], axis)


def _unfold(x, axis, size, step):
    """Windows of ``size`` every ``step`` along ``axis``: that axis becomes
    the window and a new last axis counts the windows."""
    a = axis % x.dim()
    return x.unfold(a, size, step).transpose(a, -1)


def _slice_scatter(x, src, axis, start):
    """``src`` written into ``x`` along ``axis`` from ``start``, clamped so
    it fits (``lax.dynamic_update_slice_in_dim``)."""
    n, k = x.shape[axis], src.shape[axis]
    s = min(max(int(start), 0), n - k)
    return torch.slice_scatter(x, src.to(x.dtype), axis, s, s + k)


def _fill_diagonal(x, value):
    """``x`` with ``value`` on the diagonal of its first two axes."""
    out = x.clone()
    r = torch.arange(min(x.shape[0], x.shape[1]), device=x.device)
    out[r, r] = value.to(x.dtype) if isinstance(value, torch.Tensor) \
        else value
    return out


def _argwhere(x):
    """The nonzero coordinates, padded with -1 rows to ``x.numel()`` rows
    (``jnp.nonzero(size=x.size, fill_value=-1)``)."""
    nz = torch.nonzero(x)
    pad = torch.full((x.numel() - nz.shape[0], x.dim()), -1,
                     dtype=nz.dtype, device=x.device)
    return torch.cat([nz, pad])


def _histogram_bin_edges(x, bins):
    lo, hi = float(x.min()), float(x.max())
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=torch.float64,
                          device=x.device).to(x.dtype)


def _unique_with_counts(x):
    """The sorted unique values and their counts, padded to ``x.numel()``
    with the smallest value and a count of 0 (``jnp.unique(size=...)``)."""
    vals, counts = torch.unique(x.reshape(-1), return_counts=True)
    n = x.numel() - vals.numel()
    return (torch.cat([vals, vals[:1].expand(n)]),
            torch.cat([counts, counts.new_zeros(n)]))


def _vander(x, n, increasing):
    """``jnp.vander``: the powers of the 1-D ``x``, highest first unless
    ``increasing`` (``torch.vander``'s backward is broken)."""
    n = x.shape[0] if n is None else int(n)
    p = torch.arange(n, device=x.device)
    return x[:, None] ** (p if increasing else p.flip(0))


def _crop_tensor(x, offsets, shape_):
    """``lax.dynamic_slice``: each start clamped so the window fits."""
    idx = tuple(slice(o, o + s) for o, s in (
        (min(max(int(o), 0), n - int(s)), int(s))
        for o, s, n in zip(offsets, shape_, x.shape)))
    return x[idx]


_ENV = {"torch": torch, "F": F, "math": math, "np": np,
        "dims": _math._dims, "prod": _math.prod,
        "quantile": _math._quantile, "nan_extreme": _nan_extreme,
        "nanvar": _nanvar, "unwrap": _unwrap, "unfold": _unfold,
        "slice_scatter": _slice_scatter, "fill_diagonal": _fill_diagonal,
        "argwhere": _argwhere, "histogram_bin_edges": _histogram_bin_edges,
        "unique_with_counts": _unique_with_counts,
        "crop_tensor": _crop_tensor, "vander": _vander, "device": resolve_device,
        "default_dtype": dtypes.get_default_dtype,
        "__builtins__": {
            "len": len, "range": range, "tuple": tuple, "list": list,
            "sum": sum, "int": int, "float": float, "bool": bool,
            "min": min, "max": max, "hasattr": hasattr,
            "isinstance": isinstance, "zip": zip, "enumerate": enumerate,
            "reversed": reversed, "slice": slice, "__import__": __import__}}


def load_specs() -> List[Dict[str, Any]]:
    with open(_SPEC_PATH) as f:
        data = json.load(f)
    specs = []
    for section, entries in data.items():
        for e in entries:
            e = dict(e)
            e["section"] = section
            specs.append(e)
    return specs


SPECS: Dict[str, Dict[str, Any]] = {e["name"]: e for e in load_specs()}


def _compile_impl(spec):
    args = spec.get("args", ["x"])
    attrs = spec.get("attrs") or {}
    sig_attrs = ", ".join(f"{k}={v!r}" for k, v in attrs.items())
    if spec.get("variadic"):
        sig = "*xs" + (", " + sig_attrs if sig_attrs else "")
    else:
        sig = ", ".join(args + ([sig_attrs] if sig_attrs else []))
    return eval(f"lambda {sig}: ({spec['expr']})", dict(_ENV))


def _make_op(spec):
    name = spec["name"]
    arg_names = spec.get("args", ["x"])
    attr_names = list((spec.get("attrs") or {}).keys())
    variadic = bool(spec.get("variadic"))
    grad = spec.get("grad", True)
    nondiff = tuple(spec.get("nondiff", ()))
    impl = _compile_impl(spec)

    def op(*inputs, **kwargs):
        kwargs.pop("name", None)  # paddle API convention
        if variadic:
            if len(inputs) == 1 and isinstance(inputs[0], (list, tuple)):
                inputs = tuple(inputs[0])
            tensors = [_as(t) for t in inputs]
        else:
            tensors = [_as(t) for t in inputs[: len(arg_names)]]
            for aname, val in zip(attr_names, inputs[len(arg_names):]):
                kwargs.setdefault(aname, val)
        unknown = set(kwargs) - set(attr_names)
        if unknown:
            raise TypeError(f"{name}() got unexpected arguments "
                            f"{sorted(unknown)}")
        tensors = amp_cast(name, tensors)
        with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
            out = impl(*tensors, **kwargs)
        if nondiff and isinstance(out, tuple):
            out = tuple(o.detach() if i in nondiff else o
                        for i, o in enumerate(out))
        return out

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = (f"Table op `{name}` (ops.json: {spec['section']}): "
                  f"{spec['expr']}")
    op._op_spec = spec
    return op


def _build_all():
    ops = {}
    aliases = {}
    for name, spec in SPECS.items():
        if spec.get("alias_of"):
            aliases[name] = spec["alias_of"]
            continue
        ops[name] = _make_op(spec)
    # aliases resolve to a table op, else to a hand-written one
    from . import creation, linalg, manipulation

    hand = {}
    for mod in (_math, manipulation, creation, linalg):
        hand.update({k: getattr(mod, k) for k in mod.__all__})
    for name, target in aliases.items():
        fn = ops.get(target) or hand.get(target)
        if fn is None:
            raise KeyError(f"ops.json alias {name} -> unknown op {target}")
        ops[name] = fn
    return ops


GENERATED = _build_all()
globals().update(GENERATED)
__all__ = sorted(GENERATED)


def attach_tensor_methods():
    """Each ``method`` op as a ``torch.Tensor`` method, where torch has no
    attribute of that name (torch's own are never replaced)."""
    for name, spec in SPECS.items():
        if not spec.get("method", True) or name not in GENERATED:
            continue
        if not hasattr(torch.Tensor, name):
            setattr(torch.Tensor, name, GENERATED[name])


attach_tensor_methods()
