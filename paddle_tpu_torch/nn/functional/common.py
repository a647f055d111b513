"""Common functionals (port of ``paddle_tpu/nn/functional/common.py``):
linear, dropout and its variants, padding, one-hot, label smoothing,
interpolation, im2col, the pixel shuffles, ``normalize``, ``bilinear`` and
``class_center_sample``.

Random ops draw from the port's generator of the input's device
(``core/random.py``), never from torch's global stream.

``interpolate`` is the reference's: ``jax.image.resize`` for the linear and
cubic modes, its own floor indexing for ``nearest``. ``jax.image.resize``
samples at half pixels whatever ``align_corners`` and ``align_mode`` say,
widens its kernel by 1 / scale when it downsamples (antialiasing), and its
cubic kernel is Keys' with a = -0.5; ``area`` maps to linear. So each axis
gets the weight matrix that ``jax.image.scale_and_translate`` builds, and
the matrices are applied one axis at a time.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...core import random as random_state
from ...core.dispatch import amp_cast


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with Paddle's (in, out) weight."""
    x, weight, bias = amp_cast("linear", (x, weight, bias))
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``. The ``padding_idx`` row
    is zeroed before the lookup, as the reference does, so it reads 0 and
    gets no gradient."""
    if padding_idx is not None:
        weight = weight.index_fill(
            0, torch.tensor([int(padding_idx)], device=weight.device), 0.0)
    return weight[x]


def _keep_mask(shape, p: float, device) -> torch.Tensor:
    """A bool mask that keeps each element with probability ``1 - p``,
    drawn from the device's default generator."""
    u = torch.empty(shape, device=device)
    u.uniform_(generator=random_state.default_generator(device))
    return u >= p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Dropout with the reference's signature. ``axis`` draws one mask over
    those axes and broadcasts it over the others. ``upscale_in_train``
    scales the kept elements by ``1 / (1 - p)`` in training and passes the
    input through at inference; ``downscale_in_infer`` keeps them unscaled
    in training and scales by ``1 - p`` at inference."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    x, = amp_cast("dropout", (x,))
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.dim() for a in axes]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    m = _keep_mask(shape, float(p), x.device).to(x.dtype)
    if mode == "upscale_in_train":
        return x * m / (1.0 - p)
    return x * m


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One draw per (sample, channel) plane."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: dropped elements take the negative saturation value,
    then an affine map keeps the mean and variance."""
    x, = amp_cast("alpha_dropout", (x,))
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    m = _keep_mask(x.shape, float(p), x.device).to(x.dtype)
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    return a_coef * (x * m + alpha_p * (1 - m)) + b_coef


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad

    return _pad(x, pad, mode=mode, value=value, data_format=data_format)


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows; an id outside [0, num_classes) gives a zero
    row, as ``jax.nn.one_hot``."""
    classes = torch.arange(int(num_classes), device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / K`` (or ``epsilon * prior``)."""
    label, prior_dist = amp_cast("label_smooth", (label, prior_dist))
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


_INTERP_MODES = {"nearest": "nearest", "bilinear": "linear",
                 "trilinear": "linear", "linear": "linear",
                 "bicubic": "cubic", "area": "linear"}


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _resize_weights(n_in, n_out, cubic):
    """The (n_in, n_out) matrix of ``jax.image``'s ``compute_weight_mat``
    (scale n_out / n_in, no translation, antialiased), in float64."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = (_keys_cubic if cubic else _triangle)(x / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to ``size`` (or ``int(in * scale_factor)``).
    ``align_corners`` and ``align_mode`` are accepted and, as in the
    reference, do not change the result."""
    if isinstance(size, torch.Tensor):
        size = size.tolist()
    nd = x.dim() - 2
    ch_last = data_format[-1] == "C"
    axes = list(range(1, x.dim() - 1)) if ch_last else list(range(2, x.dim()))
    spatial = [x.shape[a] for a in axes]
    if size is None:
        if scale_factor is None:
            raise ValueError("either size or scale_factor required")
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * nd
        size = [int(s * f) for s, f in zip(spatial, sf)]
    size = [int(s) for s in (size if isinstance(size, (list, tuple))
                             else [size] * nd)]
    kind = _INTERP_MODES[mode]
    x, = amp_cast("interpolate", (x,))
    if kind == "nearest":
        # the reference's floor indexing
        for ax, n_out in zip(axes, size):
            n_in = x.shape[ax]
            ix = np.clip(np.floor(np.arange(n_out) * (n_in / n_out)), 0,
                         n_in - 1).astype(np.int64)
            x = x.index_select(ax, torch.from_numpy(ix).to(x.device))
        return x
    # the reference maps any 3-axis resize to trilinear (bicubic included)
    cubic = kind == "cubic" and len(axes) != 3
    for ax, n_out in zip(axes, size):
        w = torch.from_numpy(_resize_weights(x.shape[ax], n_out, cubic)).to(
            device=x.device, dtype=x.dtype)
        x = (x.movedim(ax, -1) @ w).movedim(-1, ax)
    return x


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW", name=None):
    return interpolate(x, size, scale_factor, mode, align_corners, align_mode,
                       data_format)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C, H, W) -> (N, C * kh * kw, L), channel-major. A
    4-list of paddings is (top, left, bottom, right)."""
    k, s, d = _pair(kernel_sizes), _pair(strides), _pair(dilations)
    if isinstance(paddings, (list, tuple)) and len(paddings) == 4:
        p = tuple(paddings)
        x = TF.pad(x, (p[1], p[3], p[0], p[2]))
    else:
        p = _pair(paddings)
        x = TF.pad(x, (p[1], p[1], p[0], p[0]))
    x, = amp_cast("unfold", (x,))
    return TF.unfold(x, k, dilation=d, padding=0, stride=s)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the adjoint of ``unfold``: overlapping entries add up."""
    x, = amp_cast("fold", (x,))
    return TF.fold(x, _pair(output_sizes), _pair(kernel_sizes),
                   dilation=_pair(dilations), padding=_pair(paddings),
                   stride=_pair(strides))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    x1, x2 = amp_cast("cosine_similarity", (x1, x2))
    num = (x1 * x2).sum(axis)
    den = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return num / torch.clamp(den, min=eps)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    x, = amp_cast("pixel_shuffle", (x,))
    r = int(upscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    x, = amp_cast("pixel_unshuffle", (x,))
    r = int(downscale_factor)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    x = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    x, = amp_cast("channel_shuffle", (x,))
    g = int(groups)
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(
            n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, g, c // g).transpose(3, 4).reshape(n, h, w, c)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    x, = amp_cast("normalize", (x,))
    n = torch.linalg.vector_norm(x, ord=p, dim=axis, keepdim=True)
    return x / torch.clamp(n, min=epsilon)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias[o])``."""
    x1, x2, weight, bias = amp_cast("bilinear", (x1, x2, weight, bias))
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def class_center_sample(label, num_classes, num_samples, group=None):
    """Every class in ``label`` plus negatives drawn without replacement
    (from the port's generator of the label's device) up to
    ``num_samples``, sorted: returns (the labels remapped to their index in
    the sample, the sampled classes), both int64 on the label's device."""
    lab = label.detach().reshape(-1).cpu().numpy().astype(np.int64)
    pos = np.unique(lab)
    rest = np.setdiff1d(np.arange(num_classes), pos)
    n_extra = max(0, min(num_samples, num_classes) - pos.size)
    if n_extra > 0 and rest.size:
        perm = torch.randperm(
            rest.size, device=label.device,
            generator=random_state.default_generator(label.device))
        sampled = np.sort(np.concatenate(
            [pos, rest[perm.cpu().numpy()[:n_extra]]]))
    else:
        sampled = pos
    remap = -np.ones(num_classes, np.int64)
    remap[sampled] = np.arange(sampled.size)
    return (torch.from_numpy(remap[lab]).to(label.device),
            torch.from_numpy(sampled).to(label.device))


__all__ = [
    "linear", "embedding", "dropout", "dropout2d", "dropout3d",
    "alpha_dropout", "pad", "one_hot", "label_smooth", "interpolate",
    "upsample", "unfold", "fold", "cosine_similarity", "pixel_shuffle",
    "pixel_unshuffle", "channel_shuffle", "normalize", "bilinear",
    "class_center_sample",
]
