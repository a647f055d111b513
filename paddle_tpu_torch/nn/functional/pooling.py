"""Pooling functionals (port of ``paddle_tpu/nn/functional/pooling.py``).

The reference's facts, each kept here:

- ``exclusive=True`` (the default) averages over the window's elements
  inside the input (torch's ``count_include_pad=False``);
- ``ceil_mode`` pads the high side until the last window fits (a window
  that starts in that padding is kept, unlike torch's ``ceil_mode``), so it
  and unequal (lo, hi) pads go through ``F.pad`` (-inf for max, 0 for the
  average) and a pool with no padding;
- ``divisor_override`` is accepted and not used;
- ``max_pool1d`` and ``max_pool3d`` return ``(out, None)`` under
  ``return_mask``, and ``max_pool2d``'s mask holds the flat ``h * W + w``
  index of each window's first maximum over the unpadded input, laid out
  (N, C, H', W') whatever the data format;
- the adaptive windows are ``floor(i * in / out)`` to
  ``ceil((i + 1) * in / out)`` (torch's own), and the adaptive max pools
  return ``(out, None)`` under ``return_mask``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import amp_cast

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}
_ADA_AVG = {1: TF.adaptive_avg_pool1d, 2: TF.adaptive_avg_pool2d,
            3: TF.adaptive_avg_pool3d}
_ADA_MAX = {1: TF.adaptive_max_pool1d, 2: TF.adaptive_max_pool2d,
            3: TF.adaptive_max_pool3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else list(v) * n)[:n])
    return tuple(int(v) for _ in range(n))


def _pads(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [(int(p), int(p)) for p in padding]


def _full_pads(spatial, kernel, stride, pads, ceil_mode):
    """(lo, hi) per spatial axis: the padding spec, then ``ceil_mode``'s
    extra high padding."""
    if pads == "SAME":
        pads = []
        for n_in, k, s in zip(spatial, kernel, stride):
            n_out = -(-n_in // s)
            total = max(0, (n_out - 1) * s + k - n_in)
            pads.append((total // 2, total - total // 2))
    elif pads == "VALID":
        pads = [(0, 0)] * len(kernel)
    pads = [tuple(p) for p in pads]
    if ceil_mode:
        for i, (n_in, k, s) in enumerate(zip(spatial, kernel, stride)):
            rem = (n_in + pads[i][0] + pads[i][1] - k) % s
            if rem:
                pads[i] = (pads[i][0], pads[i][1] + (s - rem))
    return pads


def _pool(x, kernel, stride, padding, nd, op, ch_last, ceil_mode=False,
          exclusive=True, name="pool"):
    x, = amp_cast(name, (x,))
    kernel = _tuple(kernel, nd)
    stride = _tuple(stride if stride is not None else kernel, nd)
    if ch_last:
        x = x.movedim(-1, 1)
    pads = _full_pads(x.shape[2:], kernel, stride, _pads(padding, nd),
                      ceil_mode)
    sym = all(lo == hi <= k // 2 for (lo, hi), k in zip(pads, kernel))
    if op == "max":
        if sym:
            out = _MAX[nd](x, kernel, stride, [lo for lo, _ in pads])
        else:
            flat = [p for lo_hi in reversed(pads) for p in lo_hi]
            out = _MAX[nd](TF.pad(x, flat, value=float("-inf")), kernel,
                           stride)
    elif sym:
        out = _AVG[nd](x, kernel, stride, [lo for lo, _ in pads],
                       count_include_pad=not exclusive)
    else:
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        out = _AVG[nd](TF.pad(x, flat), kernel, stride)
        if exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = out / _AVG[nd](TF.pad(ones, flat), kernel, stride)
    return out.movedim(1, -1) if ch_last else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    out = _pool(x, kernel_size, stride, padding, 1, "max", False, ceil_mode,
                name="max_pool1d")
    return (out, None) if return_mask else out


def _max_pool_indices(x, kernel_size, stride, data_format):
    """The reference's mask: flat indices of each window's first maximum
    over the unpadded (N, C, H, W) input, int64."""
    k = _tuple(kernel_size, 2)
    s = _tuple(stride if stride is not None else kernel_size, 2)
    a = x.detach()
    if data_format != "NCHW":
        a = a.movedim(-1, 1)
    _, idx = TF.max_pool2d(a, k, s, return_indices=True)
    return idx


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 2, "max",
                data_format[-1] == "C", ceil_mode, name="max_pool2d")
    if return_mask:
        return out, _max_pool_indices(x, kernel_size, stride, data_format)
    return out


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    out = _pool(x, kernel_size, stride, padding, 3, "max",
                data_format[-1] == "C", ceil_mode, name="max_pool3d")
    return (out, None) if return_mask else out


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, "avg", False, ceil_mode,
                 exclusive, name="avg_pool1d")


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, "avg",
                 data_format[-1] == "C", ceil_mode, exclusive,
                 name="avg_pool2d")


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, "avg",
                 data_format[-1] == "C", ceil_mode, exclusive,
                 name="avg_pool3d")


def _adaptive_pool(x, output_size, nd, op, ch_last, name):
    x, = amp_cast(name, (x,))
    if ch_last:
        x = x.movedim(-1, 1)
    size = _tuple(output_size, nd) if not isinstance(output_size, (
        list, tuple)) or None not in output_size else tuple(output_size)
    size = tuple(s if o is None else int(o)
                 for o, s in zip(size, x.shape[2:]))
    out = (_ADA_MAX if op == "max" else _ADA_AVG)[nd](x, size)
    return out.movedim(1, -1) if ch_last else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_pool(x, output_size, 1, "avg", False,
                          "adaptive_avg_pool1d")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_pool(x, output_size, 2, "avg", data_format[-1] == "C",
                          "adaptive_avg_pool2d")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_pool(x, output_size, 3, "avg", data_format[-1] == "C",
                          "adaptive_avg_pool3d")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 1, "max", False,
                         "adaptive_max_pool1d")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 2, "max", False,
                         "adaptive_max_pool2d")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive_pool(x, output_size, 3, "max", False,
                         "adaptive_max_pool3d")
    return (out, None) if return_mask else out


__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]
