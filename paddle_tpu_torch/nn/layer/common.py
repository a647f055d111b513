"""Common layers (port of ``paddle_tpu/nn/layer/common.py``) with the
reference's parameter layout and names: Linear, Embedding, Bilinear, the
dropouts, padding, resizing, shuffles, fold/unfold and the containers.

Each takes Paddle's ``weight_attr``/``bias_attr`` (a ``ParamAttr``, a name,
an initializer, or ``False`` for no bias) where it holds parameters and, as
keyword arguments, the ``device`` (default ``get_device()``: the card
unless the CPU was asked for), ``dtype`` (default ``get_default_dtype()``)
and the ``generator`` that random initializers draw from.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from .. import functional as F
from .. import initializer as I
from .layers import Layer, LayerList  # noqa: F401 (the reference's home)


class Identity(Layer):
    def __init__(self, *args, device=None, dtype=None, generator=None,
                 **kwargs):
        super().__init__(dtype=dtype)

    def forward(self, x):
        return x


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
        return F.linear(x, self.weight, self.bias)

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


class _Stateless(Layer):
    """A layer with no parameters: ``device``, ``dtype`` and ``generator``
    are accepted, as every layer's."""

    def __init__(self, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)


class Dropout(_Stateless):
    """``F.dropout`` with the reference's ``axis`` and ``mode``, drawn from
    the port's generators (``core/random``); active in ``train()`` mode
    (``downscale_in_infer`` scales at inference)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.p, self.axis, self.mode = float(p), axis, mode

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(_Stateless):
    def __init__(self, p=0.5, data_format="NCHW", name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format)


class Dropout3D(_Stateless):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.p, self.data_format = p, data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format)


class AlphaDropout(_Stateless):
    def __init__(self, p=0.5, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training)


class Flatten(_Stateless):
    def __init__(self, start_axis=1, stop_axis=-1, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return x.flatten(self.start_axis, self.stop_axis)


class Upsample(_Stateless):
    """``F.interpolate`` as a layer (the reference's resize semantics)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format,
                         dtype=dtype)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format,
                         dtype=dtype)


class _PadNd(_Stateless):
    def __init__(self, padding, mode, value=0.0, data_format="NCHW",
                 dtype=None):
        super().__init__(dtype=dtype)
        self.padding, self.mode = padding, mode
        self.value, self.data_format = value, data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(padding, mode, value, data_format, dtype)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(padding, mode, value, data_format, dtype)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(padding, mode, value, data_format, dtype)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(padding, "constant", 0.0, data_format, dtype=dtype)


class CosineSimilarity(_Stateless):
    def __init__(self, axis=1, eps=1e-8, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class PixelShuffle(_Stateless):
    def __init__(self, upscale_factor, data_format="NCHW", name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(_Stateless):
    def __init__(self, downscale_factor, data_format="NCHW", name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.downscale_factor, self.data_format = downscale_factor, \
            data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(_Stateless):
    def __init__(self, groups, data_format="NCHW", name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """``x1 @ weight[o] @ x2 + bias[o]`` with a Xavier-uniform
    ``(out, in1, in2)`` weight; the bias ignores ``bias_attr`` except
    ``False``, as in the reference."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_features], is_bias=True, **kw)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(_Stateless):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(_Stateless):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


# -- containers (reference fluid/dygraph/container.py) -----------------------
class Sequential(Layer):
    """Sublayers run in order, named ``0``, ``1``, ... or by the names of
    ``(name, layer)`` pairs or an ``OrderedDict``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class ParameterList(Layer, nn.ParameterList):
    """Parameters named ``0``, ``1``, ..."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            for p in parameters:
                self.append(p)


class LayerDict(Layer, nn.ModuleDict):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers:
            self.update(sublayers)

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) \
            else sublayers
        for k, v in items:
            self.add_sublayer(k, v)
        return self


__all__ = [
    "Identity", "Linear", "Embedding", "Dropout", "Dropout2D", "Dropout3D",
    "AlphaDropout", "Flatten", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
    "CosineSimilarity", "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
    "Bilinear", "Unfold", "Fold", "Sequential", "LayerList", "ParameterList",
    "LayerDict",
]
