"""Convolution functionals (port of ``paddle_tpu/nn/functional/conv.py``)
over ``torch.nn.functional``'s convolutions (cuDNN's on the card).

Padding takes every form the reference takes: an int, one int per spatial
axis, the ``2n`` list ``[lo0, hi0, lo1, hi1, ...]``, a list of (lo, hi)
pairs (the last ``n`` of them), and the strings ``"SAME"`` (XLA's: the odd
pixel goes at the end) and ``"VALID"``. Torch's convolutions pad
symmetrically, so unequal (lo, hi) pairs pad the input with ``F.pad`` first.
A channel-last ``data_format`` permutes the input and output views (no
copy: cuDNN runs the permuted view in its NHWC layout). The transposes'
weight is ``(in, out / groups, *k)``, as in torch; ``output_padding`` goes on
the high side, a string padding raises ``ValueError`` and ``output_size`` is
accepted and not used, as in the reference.
"""
from __future__ import annotations

import torch.nn.functional as TF

from ...core.dispatch import amp_cast

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n):
    """The reference's padding spec: a string, or (lo, hi) per axis."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding[-n:]]
    return [(int(p), int(p)) for p in padding]


def _same_pads(spatial, k_eff, stride):
    """XLA's ``SAME``: ceil(in / stride) outputs, the odd pixel at the
    end."""
    out = []
    for n_in, k, s in zip(spatial, k_eff, stride):
        n_out = -(-n_in // s)
        total = max((n_out - 1) * s + k - n_in, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_input(x, pads):
    """Pad the trailing spatial axes of channel-first ``x`` by (lo, hi)."""
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    return TF.pad(x, flat) if any(flat) else x


def _conv(x, weight, bias, stride, padding, dilation, groups, nd, ch_last):
    x, weight, bias = amp_cast(f"conv{nd}d", (x, weight, bias))
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    if ch_last:
        x = x.movedim(-1, 1)
    spatial = x.shape[2:]
    k_eff = [d * (k - 1) + 1 for d, k in zip(dilation, weight.shape[2:])]
    pad = _padding(padding, nd)
    if pad == "SAME":
        pad = _same_pads(spatial, k_eff, stride)
    elif pad == "VALID":
        pad = [(0, 0)] * nd
    if all(lo == hi for lo, hi in pad):
        sym = [lo for lo, _ in pad]
    else:
        x, sym = _pad_input(x, pad), 0
    out = _CONV[nd](x, weight, bias, stride, sym, dilation, int(groups))
    return out.movedim(1, -1) if ch_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format in ("NLC", "NWC"))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format[-1] == "C")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format[-1] == "C")


def _conv_transpose(x, weight, bias, stride, padding, output_padding, groups,
                    dilation, nd, ch_last):
    """The gradient of a convolution: out = (in - 1) * stride - lo - hi +
    dilation * (k - 1) + output_padding + 1 along each axis."""
    x, weight, bias = amp_cast(f"conv{nd}d_transpose", (x, weight, bias))
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    out_pad = _tuple(output_padding, nd) if output_padding is not None \
        else (0,) * nd
    if ch_last:
        x = x.movedim(-1, 1)
    pad = _padding(padding, nd)
    if isinstance(pad, str):
        raise ValueError(
            f"conv{nd}d_transpose: string padding {padding!r} is not "
            "supported; give the (lo, hi) pads")
    direct = all(lo == hi >= 0 for lo, hi in pad) and all(
        op < max(s, d) for op, s, d in zip(out_pad, stride, dilation))
    if direct:
        out = _CONV_T[nd](x, weight, bias, stride, [lo for lo, _ in pad],
                          out_pad, int(groups), dilation)
    else:
        # the full transpose, then each axis cut to [lo, full - hi + op)
        out = _CONV_T[nd](x, weight, None, stride, 0, 0, int(groups),
                          dilation)
        for i, ((lo, hi), op) in enumerate(zip(pad, out_pad)):
            ax = 2 + i
            full = out.shape[ax]
            if lo < 0:
                out = TF.pad(out.movedim(ax, -1), (-lo, 0)).movedim(-1, ax)
                full, lo = full - lo, 0
            end = full - hi + op
            if end > full:
                out = TF.pad(out.movedim(ax, -1), (0, end - full)).movedim(
                    -1, ax)
            out = out.narrow(ax, lo, end - lo)
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * nd)
    return out.movedim(1, -1) if ch_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 1, data_format in ("NLC", "NWC"))


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 2, data_format[-1] == "C")


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCDHW", output_size=None, name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 3, data_format[-1] == "C")


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]
