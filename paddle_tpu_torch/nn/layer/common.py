"""Linear, Embedding and Dropout (port of ``paddle_tpu/nn/layer/common.py``)
with the reference's parameter layout and names.

Each takes Paddle's ``weight_attr``/``bias_attr`` (a ``ParamAttr``, a name,
an initializer, or ``False`` for no bias) and, as keyword arguments, the
``device`` (default ``get_device()``: the card unless the CPU was asked
for), ``dtype`` (default ``get_default_dtype()``) and the ``generator``
that random initializers draw from.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from .. import initializer as I
from ..functional.common import dropout, linear
from .layers import Layer


class Linear(Layer):
    """``x @ weight + bias`` with Paddle's **(in, out)** weight layout, so
    weights carry across from the reference with no transpose."""

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.in_features, self.out_features = in_features, out_features
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform(), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], attr=bias_attr, is_bias=True,
            default_initializer=I.Constant(0.0), **kw)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}")


class Embedding(Layer):
    """Row lookup into a ``(num_embeddings, embedding_dim)`` table named
    ``weight`` (Xavier-uniform unless ``weight_attr`` says otherwise); the
    ``padding_idx`` row starts at 0 and gets no gradient."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierUniform(), device=device,
            generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0

    def forward(self, ids):
        if self._padding_idx is None:
            return self.weight[ids]
        return TF.embedding(ids, self.weight, self._padding_idx)


class Dropout(Layer):
    """Inverted dropout drawn from the port's generators (``core/random``),
    never from torch's global RNG; active only in ``train()`` mode."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        if axis is not None or mode != "upscale_in_train":
            raise NotImplementedError(
                "Dropout: only axis=None, mode='upscale_in_train' are ported")
        self.p = float(p)

    def forward(self, x):
        return dropout(x, self.p, self.training)


__all__ = ["Linear", "Embedding", "Dropout"]
