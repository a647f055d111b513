"""Weight initializers (port of ``paddle_tpu/nn/initializer.py``).

Each initializer is a callable ``(shape, dtype, device, generator)`` that
returns a new tensor. The random ones draw in float32 and cast to
``dtype``, as the reference does, from ``generator`` when one is given, else
from the port's generator of the device (``core/random.py``). Torch's Philox
stream is not JAX's threefry, so the same seed gives other numbers than the
reference; the formulas (bounds, ``_fan``, gains) are the reference's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import random as random_state
from ..core.place import resolve_device


def _fan(shape):
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = int(shape[0]) if shape else 1
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
        fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


def _dtype(dtype):
    return dtypes.convert_dtype(dtype) or dtypes.get_default_dtype()


class Initializer:
    def __call__(self, shape, dtype=None, device=None, generator=None):
        raise NotImplementedError

    @staticmethod
    def _f32(shape, device, generator):
        """An empty float32 tensor and the generator to fill it from."""
        dev = resolve_device(device)
        gen = generator if generator is not None \
            else random_state.default_generator(dev)
        return torch.empty(tuple(shape), dtype=torch.float32, device=dev), gen


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        return torch.full(tuple(shape), self.value, dtype=_dtype(dtype),
                          device=resolve_device(device))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t, gen = self._f32(shape, device, generator)
        return t.uniform_(self.low, self.high, generator=gen).to(_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t, gen = self._f32(shape, device, generator)
        return t.normal_(self.mean, self.std, generator=gen).to(_dtype(dtype))


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2], times ``std`` plus ``mean``."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t, gen = self._f32(shape, device, generator)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * self.std + self.mean).to(_dtype(dtype))


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fan(shape)
        fi = self._fan_in or fi
        fo = self._fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, fo = _fan(shape)
        fi = self._fan_in or fi
        fo = self._fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fan(shape)
        fi = self._fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="leaky_relu"):
        self._fan_in = fan_in
        self.negative_slope = negative_slope

    def __call__(self, shape, dtype=None, device=None, generator=None):
        fi, _ = _fan(shape)
        fi = self._fan_in or fi
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        return Normal(0.0, gain / math.sqrt(fi))(shape, dtype, device,
                                                 generator)


class Assign(Initializer):
    """The given value (numpy, list or tensor), which must have ``shape``."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype=None, device=None, generator=None):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        t = v.to(device=resolve_device(device),
                 dtype=dtypes.convert_dtype(dtype) or v.dtype, copy=True)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"Assign shape {tuple(t.shape)} != {tuple(shape)}")
        return t


class Orthogonal(Initializer):
    """A (semi-)orthogonal matrix times ``gain``, drawn in float32."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype=None, device=None, generator=None):
        t, gen = self._f32(shape, device, generator)
        torch.nn.init.orthogonal_(t, self.gain, generator=gen)
        return t.to(_dtype(dtype))


class Dirac(Initializer):
    """Identity kernels: 1 at the spatial center of (out, in) pairs d, d of
    each group, 0 elsewhere."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype=None, device=None, generator=None):
        arr = np.zeros(shape, dtype=np.float32)
        o, i = shape[0], shape[1]
        mins = min(o // self.groups, i)
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for d in range(mins):
                arr[(g * (o // self.groups) + d, d) + tuple(centers)] = 1.0
        return torch.from_numpy(arr).to(device=resolve_device(device),
                                        dtype=_dtype(dtype))


# the defaults (reference: fluid.initializer._global_weight_initializer)
_default_weight_init = XavierUniform()
_default_bias_init = Constant(0.0)


def set_global_initializer(weight_init, bias_init=None):
    global _default_weight_init, _default_bias_init
    _default_weight_init = weight_init
    if bias_init is not None:
        _default_bias_init = bias_init


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4,
    }
    return gains[nonlinearity]


__all__ = ["Initializer", "Constant", "Uniform", "Normal", "TruncatedNormal",
           "XavierUniform", "XavierNormal", "KaimingUniform", "KaimingNormal",
           "Assign", "Orthogonal", "Dirac", "set_global_initializer",
           "calculate_gain"]
