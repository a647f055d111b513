"""Norm layers (port of ``paddle_tpu/nn/layer/norm.py``) with the
reference's parameter and buffer names: ``weight``, ``bias`` and, for the
batch norms, the float32 running statistics ``_mean`` and ``_variance``.

``SyncBatchNorm``: the reference's statistics are global over its sharded
batch. The port's data-parallel ranks each hold a shard, so at a world of
more than one (the default process group) the per-channel sum, then the
sum of squared deviations, and the count are all-reduced before the
normalisation (differentiably), which gives the statistics of the whole
batch; the running update uses the global count's unbiased variance.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...core.dispatch import amp_cast
from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I
from ..functional.norm import _channel_axis
from .layers import Layer


def _affine_params(layer, shape, weight_attr, bias_attr, device, generator):
    kw = {"device": device, "generator": generator}
    layer.weight = None if weight_attr is False else layer.create_parameter(
        shape, attr=weight_attr, default_initializer=I.Constant(1.0), **kw)
    layer.bias = None if bias_attr is False else layer.create_parameter(
        shape, attr=bias_attr, is_bias=True,
        default_initializer=I.Constant(0.0), **kw)


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        _affine_params(self, [num_features], weight_attr, bias_attr, device,
                       generator)
        dev = self.weight.device if self.weight is not None else \
            resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features,
                                                  dtype=torch.float32,
                                                  device=dev))
        self.register_buffer("_variance", torch.ones(num_features,
                                                     dtype=torch.float32,
                                                     device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    """The fluid-style BatchNorm: the channel axis is 1 at any rank, and
    ``act`` (a functional's name) follows the normalisation. As in the
    reference, the other keyword arguments are accepted and not used."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 *, device=None, dtype=None, generator=None, **kwargs):
        super().__init__(num_channels, momentum, epsilon, device=device,
                         dtype=dtype, generator=generator)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm whose training statistics span every rank of the default
    process group."""

    def forward(self, x):
        if not (self.training and not self._use_global_stats
                and dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return super().forward(x)
        from torch.distributed.nn.functional import all_reduce

        x, w, b = amp_cast("batch_norm", (x, self.weight, self.bias))
        ch = _channel_axis(self._data_format, x.dim())
        axes = [i for i in range(x.dim()) if i != ch]
        shape = [1] * x.dim()
        shape[ch] = x.shape[ch]
        count = torch.tensor([x.numel() // x.shape[ch]], dtype=x.dtype,
                             device=x.device)
        count = all_reduce(count)
        mean = all_reduce(x.sum(axes)) / count
        var = all_reduce(((x - mean.reshape(shape)) ** 2).sum(axes)) / count
        n = float(count.item())
        with torch.no_grad():
            m = self._momentum
            self._mean.mul_(m).add_(mean.detach().float() * (1 - m))
            self._variance.mul_(m).add_(
                var.detach().float() * (n / max(n - 1, 1)) * (1 - m))
        out = (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                     + self._epsilon)
        if w is not None:
            out = out * w.reshape(shape)
        if b is not None:
            out = out + b.reshape(shape)
        return out

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it (or itself) replaced by
        a SyncBatchNorm sharing its parameters and buffers."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False, bias_attr=False,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


class LayerNorm(Layer):
    """Over the trailing ``normalized_shape``; ``weight_attr``/``bias_attr``
    as ``Linear``'s (``False``: no gain or no shift), and the keyword
    arguments ``device``, ``dtype`` and ``generator``."""

    def __init__(self, normalized_shape, epsilon: float = 1e-5,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        _affine_params(self, self._normalized_shape, weight_attr, bias_attr,
                       device, generator)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        _affine_params(self, [num_channels], weight_attr, bias_attr, device,
                       generator)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """A gain and a shift of ``num_features`` (both left out when
    ``weight_attr`` is False; the attributes' other settings are not used,
    as in the reference)."""

    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._epsilon = epsilon
        on = None if weight_attr is not False else False
        _affine_params(self, [num_features], on, on, device, generator)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``forward(weight)`` divides ``weight`` by its spectral norm (power
    iteration from ones, as ``F.spectral_norm``); the reference's layer
    holds no parameter or buffer."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", *, device=None, generator=None):
        super().__init__(dtype=dtype)
        self.dim, self.power_iters, self.eps = dim, power_iters, eps

    def forward(self, weight):
        return F.spectral_norm(weight, self.dim, self.power_iters, self.eps)


__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "SpectralNorm",
]
