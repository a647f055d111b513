"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``)."""
from __future__ import annotations

from ..functional.activation import gelu
from .layers import Layer


class GELU(Layer):
    """``gelu(x)``, exact or (``approximate=True``) the tanh form."""

    def __init__(self, approximate=False, name=None):
        super().__init__()
        self._approximate = approximate

    def forward(self, x):
        return gelu(x, self._approximate)


__all__ = ["GELU"]
