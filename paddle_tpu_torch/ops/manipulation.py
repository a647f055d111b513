"""Shape and index ops (port of the subset of
``paddle_tpu/ops/manipulation.py`` that ``nn`` and the models call), under
Paddle's semantics where they differ from torch's:

- ``reshape``: a 0 copies the input's dimension at that place, a -1 is
  inferred;
- ``split(x, 3)`` makes 3 equal pieces (``torch.split`` makes pieces of
  size 3); a list of sizes may hold one -1;
- ``gather(x, index, axis)`` is ``index_select`` over the flattened index,
  not ``torch.gather``;
- ``flatten`` takes ``start_axis``/``stop_axis``, ``expand`` keeps a -1
  dimension, ``topk`` returns ``(values, indices)``.
"""
from __future__ import annotations

import builtins

import torch

from .creation import _as


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [int(s.item()) if isinstance(s, torch.Tensor) else int(s)
                for s in v]
    return int(v)


def reshape(x, shape, name=None):
    x = _as(x)
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_ints(shape))]
    return torch.reshape(x, shape)


def transpose(x, perm, name=None):
    return _as(x).permute(*_ints(perm))


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


def tile(x, repeat_times, name=None):
    return torch.tile(_as(x), tuple(_ints(repeat_times)))


def gather(x, index, axis=0, name=None):
    return torch.index_select(_as(x), _ints(axis), _as(index).reshape(-1))


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``: the last axis of ``index``
    addresses the leading axes of ``x``."""
    index = _as(index)
    return _as(x)[tuple(index.movedim(-1, 0))]


def index_select(x, index, axis=0, name=None):
    return torch.index_select(_as(x), int(axis), _as(index))


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(_as(arr), _as(indices), int(axis))


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y``; with only a condition,
    the (N, 1) int64 index of its true entries along each axis."""
    condition = _as(condition)
    if x is None and y is None:
        return tuple(i.reshape(-1, 1)
                     for i in torch.nonzero(condition, as_tuple=True))
    x = x if isinstance(x, (bool, int, float)) else _as(x)
    y = y if isinstance(y, (bool, int, float)) else _as(y)
    return torch.where(condition, x, y)


def masked_fill(x, mask, value, name=None):
    x = _as(x)
    if isinstance(value, torch.Tensor):
        value = value.to(x.dtype)
    return torch.masked_fill(x, _as(mask), value)


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


def repeat_interleave(x, repeats, axis=None, name=None):
    """Over the flattened input when ``axis`` is None."""
    if not isinstance(repeats, torch.Tensor):
        repeats = int(repeats)
    return torch.repeat_interleave(_as(x), repeats,
                                   None if axis is None else int(axis))


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


__all__ = ["reshape", "transpose", "concat", "stack", "split", "chunk",
           "unbind", "squeeze", "unsqueeze", "flatten", "expand",
           "broadcast_to", "tile", "gather", "gather_nd", "index_select",
           "take_along_axis", "where", "masked_fill", "topk", "sort",
           "argsort", "repeat_interleave", "slice"]
