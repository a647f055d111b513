"""Shape, index and search ops (port of ``paddle_tpu/ops/manipulation.py``),
under Paddle's semantics where they differ from torch's:

- ``reshape``: a 0 copies the input's dimension at that place, a -1 is
  inferred;
- ``split(x, 3)`` makes 3 equal pieces (``torch.split`` makes pieces of
  size 3); a list of sizes may hold one -1;
- ``gather(x, index, axis)`` is ``index_select`` over the flattened index,
  not ``torch.gather``;
- ``scatter(x, index, updates, overwrite)`` writes (or, with
  ``overwrite=False``, adds) whole rows of ``x`` at ``index``;
  ``put_along_axis`` takes ``reduce="assign" | "add" | "mul"``;
- ``unique`` gives NumPy's up to four outputs (values, first index,
  inverse, counts), ``unique_consecutive`` works along the first axis of
  the (flattened, when ``axis`` is None) input;
- ``flatten`` takes ``start_axis``/``stop_axis``, ``expand`` keeps a -1
  dimension, ``topk`` returns ``(values, indices)``, ``t`` swaps the last
  two axes, ``pad`` with a full list pads every axis from the first.

``nonzero``, ``masked_select``, ``unique``, ``unique_consecutive``,
``bincount`` and ``histogram`` have shapes that depend on the data: on the
card they wait for it.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dtype as dtypes
from .creation import _as

builtins_sum = builtins.sum


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                for s in v]
    return int(v)


def _axes(axis):
    """``axis`` as an int, a tuple of ints or None."""
    if axis is None:
        return None
    v = _ints(axis)
    return tuple(v) if isinstance(v, list) else v


def reshape(x, shape, name=None):
    x = _as(x)
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))]
    return torch.reshape(x, shape)


def reshape_(x, shape, name=None):
    """``x`` reshaped in place: its data is rebound to the new shape, as the
    reference rebinds its buffer."""
    from .inplace import _rebind

    return _rebind(x, reshape(x, shape), "reshape_")


def transpose(x, perm, name=None):
    return _as(x).permute(*_ints(perm))


def t(x, name=None):
    """The last two axes swapped; a 0-d or 1-d input as it is."""
    x = _as(x)
    return x if x.dim() < 2 else x.transpose(-1, -2)


def concat(x, axis=0, name=None):
    return torch.cat([_as(t) for t in x], _ints(axis))


def stack(x, axis=0, name=None):
    return torch.stack([_as(t) for t in x], int(axis))


def split(x, num_or_sections, axis=0, name=None):
    x = _as(x)
    axis = _ints(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} on axis {axis} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = _ints(num_or_sections)
        if sections.count(-1) > 1:
            raise ValueError("split: at most one section may be -1")
        known = builtins.sum(s for s in sections if s != -1)
        sections = [dim - known if s == -1 else s for s in sections]
    return list(torch.split(x, sections, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(_as(x), int(axis)))


unstack = unbind


def squeeze(x, axis=None, name=None):
    """Drops the given axes that have size 1 (all of them when None)."""
    x = _as(x)
    if axis is None:
        return torch.squeeze(x)
    axes = _ints(axis)
    return torch.squeeze(x, tuple(axes) if isinstance(axes, list) else axes)


def unsqueeze(x, axis, name=None):
    """New size-1 axes at the given places of the output."""
    x = _as(x)
    axes = _ints(axis)
    axes = axes if isinstance(axes, list) else [axes]
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return torch.flatten(_as(x), int(start_axis), int(stop_axis))


def expand(x, shape, name=None):
    """Broadcast to ``shape``; a -1 keeps the input's dimension."""
    return _as(x).expand(*_ints(shape))


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, list(_as(y).shape))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[_as(t) for t in inputs]))


def tile(x, repeat_times, name=None):
    return torch.tile(_as(x), tuple(_ints(repeat_times)))


def repeat_interleave(x, repeats, axis=None, name=None):
    """Over the flattened input when ``axis`` is None."""
    if not isinstance(repeats, torch.Tensor):
        repeats = int(repeats)
    return torch.repeat_interleave(_as(x), repeats,
                                   None if axis is None else int(axis))


def flip(x, axis, name=None):
    axes = _axes(axis)
    return torch.flip(_as(x), axes if isinstance(axes, tuple) else (axes,))


def roll(x, shifts, axis=None, name=None):
    """Over the flattened input when ``axis`` is None."""
    return torch.roll(_as(x), _axes(shifts), _axes(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_as(x), int(k), _ints(axes))


def cast(x, dtype):
    from .math import cast as _cast

    return _cast(x, dtype)


# -- gather / scatter --------------------------------------------------------
def gather(x, index, axis=0, name=None):
    return torch.index_select(_as(x), _ints(axis), _as(index).reshape(-1))


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``: the last axis of ``index``
    addresses the leading axes of ``x``."""
    index = _as(index)
    return _as(x)[tuple(index.movedim(-1, 0))]


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(_as(arr), _as(indices), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` (broadcast to ``indices``' shape) written at
    ``indices`` along ``axis``: assigned, or added or multiplied in."""
    arr, idx = _as(arr), _as(indices).long()
    v = _as(values) if isinstance(values, torch.Tensor) else \
        torch.as_tensor(values, device=arr.device)
    v = torch.broadcast_to(v.to(arr.dtype), idx.shape)
    axis = int(axis)
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, v)
    if reduce == "add":
        return torch.scatter_add(arr, axis, idx, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, axis, idx, v, "prod")
    raise ValueError(f"put_along_axis: unknown reduce {reduce!r}")


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (``overwrite``) or
    ``updates`` added to them."""
    x, updates = _as(x), _as(updates)
    idx = (_as(index).reshape(-1).long(),)
    return x.index_put(idx, updates.to(x.dtype), accumulate=not overwrite)


def scatter_nd_add(x, index, updates, name=None):
    x, index = _as(x), _as(index)
    return x.index_put(tuple(index.long().movedim(-1, 0)),
                       _as(updates).to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = _as(updates)
    out = torch.zeros(tuple(_ints(shape)), dtype=updates.dtype,
                      device=updates.device)
    return scatter_nd_add(out, index, updates)


def index_select(x, index, axis=0, name=None):
    return torch.index_select(_as(x), int(axis), _as(index))


def index_sample(x, index):
    return torch.gather(_as(x), 1, _as(index).long())


def index_add(x, index, axis, value, name=None):
    x = _as(x)
    return torch.index_add(x, int(axis), _as(index),
                           _as(value).to(x.dtype))


def masked_select(x, mask, name=None):
    return torch.masked_select(_as(x), _as(mask))


def masked_fill(x, mask, value, name=None):
    x = _as(x)
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    return torch.masked_fill(x, _as(mask), value)


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with only a condition,
    the (N, 1) int64 index of its true entries along each axis."""
    condition = _as(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x = x if isinstance(x, (bool, int, float)) else _as(x)
    y = y if isinstance(y, (bool, int, float)) else _as(y)
    return torch.where(condition, x, y)


def nonzero(x, as_tuple=False, name=None):
    """(N, ndim) int64 coordinates of the nonzero entries; ``as_tuple``: one
    (N, 1) tensor an axis."""
    x = _as(x)
    if as_tuple:
        return tuple(i.reshape(-1, 1)
                     for i in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def slice(x, axes, starts, ends, name=None):
    """``x[starts[i]:ends[i]]`` along each of ``axes``; negative bounds count
    from the end, and bounds are clamped to the dimension."""
    x = _as(x)
    index = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(_ints(axes), _ints(starts), _ints(ends)):
        dim = x.shape[ax]
        st = builtins.max(st + dim, 0) if st < 0 else builtins.min(st, dim)
        en = builtins.max(en + dim, 0) if en < 0 else builtins.min(en, dim)
        index[ax] = builtins.slice(st, en)
    return x[tuple(index)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python's ``start:end:stride`` along each of ``axes`` (a negative
    stride walks backwards)."""
    x = _as(x)
    for ax, st, en, sr in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        picked = builtins.slice(st, en, sr).indices(x.shape[ax])
        if sr > 0:
            index = [builtins.slice(None)] * x.dim()
            index[ax] = builtins.slice(*picked)
            x = x[tuple(index)]
        else:
            rows = torch.arange(*picked, device=x.device)
            x = x.index_select(ax, rows)
    return x


def crop(x, shape=None, offsets=None, name=None):
    x = _as(x)
    shape = [int(s) for s in (shape or x.shape)]
    offsets = [int(o) for o in (offsets or [0] * x.dim())]
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offsets, shape))]


# -- python indexing ---------------------------------------------------------
def _index(item):
    """An index expression with lists and arrays as tensors; beside such an
    index an integer is one too, so the indexed axes go where NumPy puts
    them (first, when a slice separates them)."""
    if not isinstance(item, tuple):
        item = (item,)
    item = tuple(torch.as_tensor(np.asarray(it))
                 if isinstance(it, (list, np.ndarray)) else it for it in item)
    if any(isinstance(it, torch.Tensor) and it.dtype != torch.bool
           for it in item):
        # a 0-d tensor index is still a basic one to torch; (1,) broadcasts
        # as NumPy's integer does
        item = tuple(torch.tensor([it]) if isinstance(it, int)
                     and not isinstance(it, bool) else it for it in item)
    return item


def getitem(x, item):
    return _as(x)[_index(item)]


def setitem(x, item, value):
    """``x[item] = value`` in place (the reference's ``set_value``);
    returns ``x``."""
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    x[_index(item)] = value
    return x


# -- search / sort -----------------------------------------------------------
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    out = torch.topk(_as(x), k, int(axis), largest=largest, sorted=sorted)
    return out.values, out.indices


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(_as(x), stable=True, dim=int(axis),
                      descending=descending).values


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(_as(x), stable=True, dim=int(axis),
                         descending=descending)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(_as(sorted_sequence), _as(values),
                              out_int32=out_int32, right=right)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """NumPy's ``unique``: the sorted unique values (rows along ``axis``),
    and as asked the index of each one's first occurrence, the inverse (in
    the input's shape when ``axis`` is None) and the counts (int64)."""
    x = _as(x)
    shape = x.shape
    if axis is None:
        x = x.reshape(-1)
        dim = 0
    else:
        dim = int(axis) % x.dim()
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    if not (return_index or return_inverse or return_counts):
        return vals
    out = [vals]
    if return_index:
        pos = torch.arange(inv.numel(), device=x.device)
        first = torch.full((vals.shape[dim],), inv.numel(),
                           dtype=torch.int64, device=x.device)
        out.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        out.append(inv.reshape(shape) if axis is None else inv)
    if return_counts:
        out.append(counts)
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Runs of equal entries (rows along the first axis; the input is
    flattened when ``axis`` is None) collapsed to one."""
    x = _as(x)
    if axis is None:
        x = x.reshape(-1)
    vals, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=0)
    rets = [vals]
    if return_inverse:
        rets.append(inv)
    if return_counts:
        rets.append(counts)
    return rets[0] if len(rets) == 1 else tuple(rets)


def bincount(x, weights=None, minlength=0, name=None):
    """Counts (int64) or, with ``weights``, sums of the weights, summed in
    float64 (``np.bincount``) and given in the default float dtype."""
    if weights is None:
        return torch.bincount(_as(x), None, int(minlength))
    return torch.bincount(_as(x), _as(weights).double(), int(minlength)).to(
        dtypes.get_default_dtype())


def histogram(input, bins=100, min=0, max=0, name=None):
    """``np.histogram``'s int64 counts over ``bins`` equal bins of [min,
    max] (the data's range when both are 0), the last bin closed: the
    edges are ``np.linspace``'s in float64 and each value goes to the bin
    whose edges hold it, as NumPy decides."""
    x = _as(input).reshape(-1).double()
    if min == 0 and max == 0:
        min, max = float(x.min()), float(x.max())
    edges = torch.linspace(float(min), float(max), int(bins) + 1,
                           dtype=torch.float64, device=x.device)
    idx = torch.searchsorted(edges, x, right=True) - 1
    idx = torch.where(x == edges[-1], int(bins) - 1, idx)
    keep = (x >= edges[0]) & (x <= edges[-1])
    return torch.bincount(idx[keep], minlength=int(bins))


def _pad_index(n, lo, hi, mode, device):
    """Source positions of one axis padded by (lo, hi) in ``mode``."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "replicate":
        return j.clamp(0, n - 1)
    if mode == "circular":
        return j % n
    period = 2 * (n - 1)  # reflect: mirror at both ends, edges once
    j = j.abs() % builtins.max(period, 1)
    return torch.where(j >= n, period - j, j)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """A list of 2 x ndim pads every axis from the first; a shorter one
    pads the trailing spatial axes (after the channel axis of an
    ``N...C`` layout). ``mode``: constant, reflect, replicate, circular."""
    x = _as(x)
    pads = _ints(pad)
    nd = x.dim()
    if len(pads) == nd * 2:
        width = [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pads) // 2
        sp = [(pads[2 * i], pads[2 * i + 1]) for i in range(n_sp)]
        if data_format.endswith("C") and nd - 2 == n_sp:
            width = [(0, 0)] + sp + [(0, 0)]
        else:
            width = [(0, 0)] * (nd - n_sp) + sp
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return F.pad(x, flat, value=value)
    if mode not in ("reflect", "replicate", "circular"):
        raise ValueError(f"pad: unknown mode {mode!r}")
    for ax, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(ax, _pad_index(x.shape[ax], lo, hi, mode,
                                              x.device))
    return x


def atleast_1d(*inputs):
    outs = [torch.atleast_1d(_as(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs):
    outs = [torch.atleast_2d(_as(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs):
    outs = [torch.atleast_3d(_as(t)) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def as_real(x, name=None):
    x = _as(x)
    return torch.stack([x.real, x.imag], -1)


def as_complex(x, name=None):
    x = _as(x)
    return torch.complex(x[..., 0], x[..., 1])


def real(x, name=None):
    x = _as(x)
    return x.real.clone() if x.is_complex() else x


def imag(x, name=None):
    """The imaginary part; zeros for a real input (``jnp.imag``)."""
    x = _as(x)
    return x.imag.clone() if x.is_complex() else torch.zeros_like(x)


def conj(x, name=None):
    return torch.conj_physical(_as(x))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_as(x), _axes(source), _axes(destination))


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_as(x), int(axis0), int(axis1))


transpose_ = swapaxes


__all__ = [
    "reshape", "reshape_", "transpose", "t", "concat", "stack", "split",
    "builtins_sum", "chunk", "unbind", "unstack", "squeeze", "unsqueeze",
    "flatten", "expand", "broadcast_to", "expand_as", "broadcast_shape",
    "broadcast_tensors", "tile", "repeat_interleave", "flip", "roll",
    "rot90", "cast", "gather", "gather_nd", "take_along_axis",
    "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
    "index_select", "index_sample", "index_add", "masked_select",
    "masked_fill", "where", "nonzero", "slice", "strided_slice", "crop",
    "getitem", "setitem", "topk", "sort", "argsort", "searchsorted",
    "unique", "unique_consecutive", "bincount", "histogram", "pad",
    "atleast_1d", "atleast_2d", "atleast_3d", "as_real", "as_complex",
    "real", "imag", "conj", "moveaxis", "swapaxes", "transpose_",
]
