"""LayerNorm (port of ``paddle_tpu/nn/layer/norm.py``) with the reference's
parameter names and formula."""
from __future__ import annotations

from .. import initializer as I
from ..functional.norm import layer_norm
from .layers import Layer


class LayerNorm(Layer):
    """Over the trailing ``normalized_shape``; ``weight_attr``/``bias_attr``
    as ``Linear``'s (``False``: no gain or no shift), and the keyword
    arguments ``device`` and ``dtype``."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0), device=device)
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0), device=device)

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias,
                          self.epsilon)


__all__ = ["LayerNorm"]
