"""Activation functionals (port of the subset of
``paddle_tpu/nn/functional/activation.py`` the models call)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU, or the tanh form when ``approximate``, as
    ``jax.nn.gelu``'s two forms."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    """``x * sigmoid(x)`` (``jax.nn.silu``)."""
    return TF.silu(x)


__all__ = ["gelu", "tanh", "silu"]
