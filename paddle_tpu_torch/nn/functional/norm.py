"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``).

``batch_norm`` keeps Paddle's momentum, the weight of the *old* running
value: ``running = running * momentum + batch * (1 - momentum)``, so
``torch.nn.functional.batch_norm`` (cuDNN's on the card) takes
``1 - momentum``. Both normalise by the biased batch variance and update
the running variance with the unbiased one. ``data_format`` picks the
channel axis: 1 for ``NC...``, else the last.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core.dispatch import amp_cast


def _channel_axis(data_format, ndim):
    return 1 if data_format.startswith("NC") else ndim - 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (``running_mean``/``running_var`` are
    updated in place), the running ones otherwise or when
    ``use_global_stats``."""
    x, weight, bias = amp_cast("batch_norm", (x, weight, bias))
    ch = _channel_axis(data_format, x.dim())
    use_batch = training and not (use_global_stats or False)
    xc = x.movedim(ch, 1) if ch != 1 else x
    out = TF.batch_norm(xc, running_mean, running_var, weight, bias,
                        training=use_batch, momentum=1.0 - momentum,
                        eps=epsilon)
    return out.movedim(1, ch) if ch != 1 else out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """Normalizes over the trailing ``len(normalized_shape)`` axes with the
    reference's explicit mean/variance expression, evaluated in x's dtype
    (``torch.layer_norm`` would upcast bf16)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    x, weight, bias = amp_cast("layer_norm", (x, weight, bias))
    axes = tuple(range(-len(normalized_shape), 0))
    mu = x.mean(axes, keepdim=True)
    var = ((x - mu) ** 2).mean(axes, keepdim=True)
    out = (x - mu) / torch.sqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Mean and biased variance over each group of channels and the
    spatial axes."""
    x, weight, bias = amp_cast("group_norm", (x, weight, bias))
    ch_last = data_format[-1] == "C"
    xc = x.movedim(-1, 1) if ch_last else x
    out = TF.group_norm(xc, int(num_groups), weight, bias, epsilon)
    return out.movedim(1, -1) if ch_last else out


def _affine(out, weight, bias):
    shape = (1, out.shape[1]) + (1,) * (out.dim() - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each (sample, channel)'s own statistics over the axes after 1. As in
    the reference, the running statistics, ``use_input_stats``,
    ``momentum`` and ``data_format`` are accepted and not used."""
    x, weight, bias = amp_cast("instance_norm", (x, weight, bias))
    axes = tuple(range(2, x.dim()))
    if axes:
        m = x.mean(axes, keepdim=True)
        v = ((x - m) ** 2).mean(axes, keepdim=True)
    else:  # no axis to reduce: each value is its own mean
        m, v = x, torch.zeros_like(x)
    return _affine((x - m) / torch.sqrt(v + eps), weight, bias)


def local_response_norm(x, size, alpha=0.0001, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha * sum_window(x^2) / size) ** beta`` over ``size``
    neighbouring channels of axis 1 (``size // 2`` before, the rest after;
    ``data_format`` is not used, as in the reference)."""
    x, = amp_cast("local_response_norm", (x,))
    sq = x * x
    half = size // 2
    c = x.shape[1]
    pads = [0, 0] * (x.dim() - 2) + [half, size - 1 - half]
    sp = TF.pad(sq, pads)
    acc = sp[:, 0:c]
    for i in range(1, size):
        acc = acc + sp[:, i: i + c]
    return x / torch.pow(k + alpha * acc / size, beta)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight / sigma``: sigma from ``power_iters`` power iterations on
    the matrix with ``dim`` first, started from all-ones vectors."""
    weight, = amp_cast("spectral_norm", (weight,))
    wm = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    u = torch.ones(wm.shape[0], dtype=wm.dtype, device=wm.device)
    v = torch.ones(wm.shape[1], dtype=wm.dtype, device=wm.device)
    for _ in range(power_iters):
        v = wm.T @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ wm @ v
    return weight / sigma


__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "spectral_norm"]
