"""layer_norm (port of ``paddle_tpu/nn/functional/norm.py:79``)."""
from __future__ import annotations

import torch

from ...core.dispatch import amp_cast


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


__all__ = ["layer_norm"]
