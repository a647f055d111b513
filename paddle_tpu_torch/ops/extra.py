"""Ops that need more than a table entry (port of
``paddle_tpu/ops/extra.py``): ``einsum``, the segment reductions
(``paddle.incubate.segment_*``) and ``histogramdd``.

The segment count is the largest id plus one, read on the host (the
reference sizes its output the same way); an empty segment sums to 0,
averages to 0 and reduces to -inf (max) or +inf (min), as
``jax.ops.segment_*``.
"""
from __future__ import annotations

import math

import torch

from ..core.dispatch import amp_cast
from .creation import _as


def einsum(equation, *operands, **kwargs):
    if operands and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    tensors = amp_cast("einsum", [_as(t) for t in operands])
    return torch.einsum(equation, *tensors)


def _segments(data, segment_ids):
    d, s = _as(data), _as(segment_ids).long()
    num = int(s.max()) + 1 if s.numel() else 0
    return d, s, num


def _segment_sum(d, s, num):
    out = torch.zeros((num,) + tuple(d.shape[1:]), dtype=d.dtype,
                      device=d.device)
    return out.index_add(0, s, d)


def segment_sum(data, segment_ids, name=None):
    return _segment_sum(*_segments(data, segment_ids))


def segment_mean(data, segment_ids, name=None):
    d, s, num = _segments(data, segment_ids)
    cnt = _segment_sum(torch.ones_like(d), s, num)
    return _segment_sum(d, s, num) / torch.clamp(cnt, min=1)


def _segment_extreme(data, segment_ids, reduce, fill):
    d, s, num = _segments(data, segment_ids)
    out = torch.full((num,) + tuple(d.shape[1:]), fill, dtype=d.dtype,
                     device=d.device)
    idx = s.reshape((-1,) + (1,) * (d.dim() - 1)).expand(d.shape)
    return out.scatter_reduce(0, idx, d, reduce)


def segment_max(data, segment_ids, name=None):
    return _segment_extreme(data, segment_ids, "amax", -math.inf)


def segment_min(data, segment_ids, name=None):
    return _segment_extreme(data, segment_ids, "amin", math.inf)


def _edges(col, bins, rng):
    lo, hi = (float(col.min()), float(col.max())) if rng is None \
        else (float(rng[0]), float(rng[1]))
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return torch.linspace(lo, hi, int(bins) + 1, dtype=col.dtype,
                          device=col.device)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """``(hist, edges)`` of the (N, D) sample ``x`` over equal bins per
    axis (``jnp.histogramdd``): a value on an axis' last edge counts in its
    last bin, values outside the range count nowhere."""
    a = _as(x)
    n, dd = a.shape
    bins = [bins] * dd if isinstance(bins, int) else list(bins)
    ranges = [None] * dd if ranges is None else list(ranges)
    edges = [_edges(a[:, i], bins[i], ranges[i]) for i in range(dd)]
    flat = torch.zeros(n, dtype=torch.int64, device=a.device)
    for i, e in enumerate(edges):
        b = torch.searchsorted(e, a[:, i].contiguous(), right=True)
        b = torch.where(a[:, i] == e[-1], b - 1, b)  # 0 and nb+1: outside
        flat = flat * (bins[i] + 2) + b
    w = None if weights is None else _as(weights).to(a.dtype)
    size = math.prod(b + 2 for b in bins)
    hist = torch.bincount(flat, w, size)  # int64 counts without weights
    if w is not None or density:
        hist = hist.to(a.dtype)
    hist = hist.reshape([b + 2 for b in bins])[(slice(1, -1),) * dd]
    if density:
        hist = hist / hist.sum()
        for i, e in enumerate(edges):
            shape = [1] * dd
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges


__all__ = ["einsum", "segment_sum", "segment_mean", "segment_max",
           "segment_min", "histogramdd"]
