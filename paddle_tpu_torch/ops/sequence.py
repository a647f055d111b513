"""Sequence ops over padded data with lengths (port of
``paddle_tpu/ops/sequence.py``): ``x`` is ``(B, T, ...)`` and ``length``
``(B,)`` the valid count of each row; ops that change the lengths return
``(values, new_length)``. Positions past a row's length are zero (or
``pad_value``) in every output.

``sequence_unpad`` keeps the reference's static shape: ``(B * T, ...)``
with the valid rows first, in order, and zeros after them.
"""
from __future__ import annotations

import torch

from .creation import _as

__all__ = [
    "sequence_pad", "sequence_unpad", "sequence_softmax", "sequence_pool",
    "sequence_reverse", "sequence_expand", "sequence_expand_as",
    "sequence_concat", "sequence_slice", "sequence_erase",
    "sequence_enumerate", "sequence_reshape", "sequence_scatter",
    "sequence_topk_avg_pooling", "sequence_conv", "sequence_first_step",
    "sequence_last_step",
]


def _valid(length, t):
    """(B, T) bool validity mask from (B,) lengths."""
    return torch.arange(t, device=length.device)[None, :] < length[:, None]


def _trail(mask, x, lead=2):
    """``mask`` with size-1 axes for ``x``'s trailing axes after ``lead``."""
    return mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - lead))


def _offsets(lv):
    return torch.cumsum(lv, 0) - lv


def sequence_pad(x, length, max_len, pad_value=0.0, name=None):
    """Packed rows ``(total, ...)`` of ``B`` sequences -> ``(B, max_len,
    ...)`` with ``pad_value`` past each row's length."""
    xv, lv = _as(x), _as(length)
    t = torch.arange(int(max_len), device=xv.device)[None, :]
    idx = torch.clamp(_offsets(lv)[:, None] + t, 0, xv.shape[0] - 1)
    out = xv[idx]
    mask = _trail(t < lv[:, None], xv, 1)
    return torch.where(mask, out, torch.as_tensor(pad_value, dtype=out.dtype,
                                                  device=out.device))


def sequence_unpad(x, length, name=None):
    """``(B, T, ...)`` -> ``(B * T, ...)``: the valid rows packed first."""
    xv, lv = _as(x), _as(length)
    b, t = xv.shape[0], xv.shape[1]
    tt = torch.arange(t, device=xv.device)[None, :]
    valid = tt < lv[:, None]
    pos = torch.where(valid, _offsets(lv)[:, None] + tt, b * t)  # trash slot
    flat = xv.reshape((b * t,) + tuple(xv.shape[2:]))
    out = torch.zeros((b * t + 1,) + tuple(xv.shape[2:]), dtype=xv.dtype,
                      device=xv.device)
    out = out.index_put((pos.reshape(-1),), flat)
    return out[: b * t]


def sequence_softmax(x, length, name=None):
    """Softmax over each row's valid positions (in float32), 0 past them."""
    xv, lv = _as(x), _as(length)
    mask = _trail(_valid(lv, xv.shape[1]), xv)
    s = torch.where(mask, xv.float(), -torch.inf)
    p = torch.softmax(s, dim=1)
    return torch.where(mask, p, 0.0).to(xv.dtype)


_POOLS = ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")


def sequence_pool(x, length, pool_type="SUM", name=None):
    """Pooling over each row's valid positions: SUM, AVERAGE, SQRT (sum
    over sqrt(length)), MAX, MIN, LAST or FIRST; a row of length 0 gives
    zeros."""
    xv, lv = _as(x), _as(length)
    pt = pool_type.upper()
    if pt not in _POOLS:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    t = xv.shape[1]
    mask = _trail(_valid(lv, t), xv)
    n = torch.clamp(lv, min=1).reshape((-1,) + (1,) * (xv.dim() - 2))
    empty = (lv == 0).reshape((-1,) + (1,) * (xv.dim() - 2))
    if pt in ("SUM", "AVERAGE", "SQRT"):
        total = torch.where(mask, xv, 0).sum(dim=1)
        if pt == "SUM":
            return total
        n = n.to(xv.dtype)
        return total / (n if pt == "AVERAGE" else torch.sqrt(n))
    if pt in ("MAX", "MIN"):
        fill = -torch.inf if pt == "MAX" else torch.inf
        red = torch.where(mask, xv, fill)
        out = red.amax(dim=1) if pt == "MAX" else red.amin(dim=1)
    else:
        idx = lv - 1 if pt == "LAST" else torch.zeros_like(lv)
        idx = torch.clamp(idx, 0, t - 1).reshape((-1, 1)
                                                 + (1,) * (xv.dim() - 2))
        out = torch.take_along_dim(xv, idx.long(), 1)[:, 0]
    return torch.where(empty, torch.zeros_like(out), out)


def sequence_first_step(x, length, name=None):
    return sequence_pool(x, length, "FIRST")


def sequence_last_step(x, length, name=None):
    return sequence_pool(x, length, "LAST")


def _take_time(xv, idx):
    """``xv[b, idx[b, t]]`` along the time axis."""
    return torch.take_along_dim(xv, _trail(idx, xv).long(), 1)


def sequence_reverse(x, length, name=None):
    """Each row's valid prefix reversed; positions past it stay."""
    xv, lv = _as(x), _as(length)
    tt = torch.arange(xv.shape[1], device=xv.device)[None, :]
    idx = torch.where(tt < lv[:, None], lv[:, None] - 1 - tt, tt)
    return _take_time(xv, idx)


def sequence_expand(x, length, max_len, name=None):
    """``(B, ...)`` -> ``(B, max_len, ...)``: each row repeated over its
    length, zeros past it."""
    xv, lv = _as(x), _as(length)
    max_len = int(max_len)
    out = xv[:, None].expand((xv.shape[0], max_len) + tuple(xv.shape[1:]))
    mask = _valid(lv, max_len).reshape((xv.shape[0], max_len)
                                       + (1,) * (xv.dim() - 1))
    return torch.where(mask, out, 0)


def sequence_expand_as(x, y, y_length, name=None):
    return sequence_expand(x, y_length, max_len=_as(y).shape[1])


def sequence_concat(x, x_length, y, y_length, name=None):
    """Row b becomes ``x[b, :lx] ++ y[b, :ly]``; returns ``(values, lx +
    ly)``."""
    xv, lx, yv, ly = _as(x), _as(x_length), _as(y), _as(y_length)
    t1, t2 = xv.shape[1], yv.shape[1]
    cat = torch.cat([xv, yv], dim=1)
    tt = torch.arange(t1 + t2, device=xv.device)[None, :]
    idx = torch.where(tt < lx[:, None], tt,
                      t1 + torch.clamp(tt - lx[:, None], 0, t2 - 1))
    out = _take_time(cat, idx)
    mask = _trail(tt < (lx + ly)[:, None], xv)
    return torch.where(mask, out, 0), lx + ly


def sequence_slice(x, length, offset, slice_length, name=None):
    """Row b's positions ``[offset[b], offset[b] + slice_length[b])``;
    returns ``(values, new_length)``."""
    xv, lv = _as(x), _as(length)
    off, sl = _as(offset), _as(slice_length)
    t = xv.shape[1]
    tt = torch.arange(t, device=xv.device)[None, :]
    out = _take_time(xv, torch.clamp(off[:, None] + tt, 0, t - 1))
    new_len = torch.minimum(sl, torch.clamp(lv - off, min=0))
    mask = _trail(tt < new_len[:, None], xv)
    return torch.where(mask, out, 0), new_len


def sequence_erase(x, length, tokens, name=None):
    """``(B, T)`` ids with the listed tokens removed and each row compacted;
    returns ``(values, new_length)``."""
    xv, lv = _as(x), _as(length)
    b, t = xv.shape
    tt = torch.arange(t, device=xv.device)[None, :]
    drop = torch.as_tensor([int(k) for k in tokens], dtype=xv.dtype,
                           device=xv.device)
    keep = (tt < lv[:, None]) & ~torch.isin(xv, drop)
    pos = torch.where(keep, torch.cumsum(keep, 1) - 1, t)  # trash slot
    out = torch.zeros((b, t + 1), dtype=xv.dtype, device=xv.device)
    rows = torch.arange(b, device=xv.device)[:, None].expand(b, t)
    out = out.index_put((rows, pos), xv)
    return out[:, :t], keep.sum(1).to(lv.dtype)


def sequence_enumerate(x, length, win_size, pad_value=0, name=None):
    """``(B, T)`` -> ``(B, T, win_size)`` windows of ids; positions past the
    row's length give ``pad_value``."""
    xv, lv = _as(x), _as(length)
    t = xv.shape[1]
    dev = xv.device
    tt = torch.arange(t, device=dev)[:, None] \
        + torch.arange(int(win_size), device=dev)[None, :]
    out = xv[:, torch.clamp(tt, 0, t - 1)]
    ok = tt[None] < lv[:, None, None]
    return torch.where(ok, out, torch.as_tensor(int(pad_value),
                                                dtype=xv.dtype, device=dev))


def sequence_reshape(x, length, new_dim, name=None):
    """``(B, T, D)`` -> ``(B, T * D / new_dim, new_dim)``; the lengths scale
    by ``D / new_dim``."""
    xv, lv = _as(x), _as(length)
    b, t, d = xv.shape
    new_dim = int(new_dim)
    return xv.reshape(b, t * d // new_dim, new_dim), (lv * d) // new_dim


def sequence_scatter(x, index, updates, updates_length, name=None):
    """Row b of ``x`` (B, T) plus ``updates[b, :updates_length[b]]`` added at
    ``index[b]`` (indices clamped to the row)."""
    xv, idx = _as(x), _as(index)
    upd, ul = _as(updates), _as(updates_length)
    k = idx.shape[1]
    ok = torch.arange(k, device=xv.device)[None, :] < ul[:, None]
    upd = torch.where(ok, upd, 0).to(xv.dtype)
    rows = torch.arange(xv.shape[0], device=xv.device)[:, None].expand_as(idx)
    return xv.index_put((rows, torch.clamp(idx, 0, xv.shape[1] - 1).long()),
                        upd, accumulate=True)


def sequence_topk_avg_pooling(x, length, topks, name=None):
    """``(B, T)`` -> ``(B, len(topks))``: the mean of each row's top
    ``min(k, length)`` valid values for each k."""
    xv, lv = _as(x), _as(length)
    t = xv.shape[1]
    masked = torch.where(_valid(lv, t), xv.float(), -torch.inf)
    srt = torch.sort(masked, dim=1, descending=True).values
    srt = torch.where(torch.isfinite(srt), srt, 0.0)
    csum = torch.cumsum(srt, dim=1)
    outs = []
    for k in topks:
        kk = torch.clamp(torch.clamp(lv, max=int(k)), min=1)
        outs.append(torch.gather(csum, 1, (kk - 1)[:, None].long())[:, 0]
                    / kk.float())
    return torch.stack(outs, dim=1).to(xv.dtype)


def sequence_conv(x, length, weight, context_start=None, name=None):
    """``(B, T, D)`` convolved over time with ``weight`` ``(ctx * D, M)``:
    each position sees ``ctx`` positions from ``context_start`` (default
    ``-(ctx // 2)``), zero outside the row."""
    xv, lv, wv = _as(x), _as(length), _as(weight)
    b, t, d = xv.shape
    ctx = wv.shape[0] // d
    start = -(ctx // 2) if context_start is None else int(context_start)
    mask = _valid(lv, t)[:, :, None]
    xz = torch.where(mask, xv, 0)
    frames = []
    for c in range(ctx):
        shift = start + c
        rolled = torch.roll(xz, -shift, dims=1)
        tt = torch.arange(t, device=xv.device)[None, :] + shift
        ok = (tt >= 0) & (tt < lv[:, None])
        frames.append(torch.where(ok[:, :, None], rolled, 0))
    out = torch.einsum("btc,cm->btm", torch.cat(frames, dim=-1), wv)
    return torch.where(mask, out, 0)
