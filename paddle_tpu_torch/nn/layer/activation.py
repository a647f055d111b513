"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``).

Each takes the keyword arguments ``device``, ``dtype`` and ``generator``
as every layer does; only ``PReLU`` holds a parameter (``weight``, of
``num_parameters`` values, ``init`` each), and ``RReLU`` draws its slopes
in training from the port's generator of the input's device.
"""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer


class _Act(Layer):
    """A parameterless activation over ``F.<_fn>``; ``_keys`` names the
    stored arguments passed after the input."""

    _fn = ""
    _keys = ()

    def __init__(self, *args, name=None, device=None, dtype=None,
                 generator=None, **kwargs):
        super().__init__(dtype=dtype)
        self._kw = dict(zip(self._keys, args))
        self._kw.update(kwargs)

    def forward(self, x):
        return getattr(F, self._fn)(x, **self._kw)

    def extra_repr(self):
        return ", ".join(f"{k}={v}" for k, v in self._kw.items())


def _act(cls_name, fn, keys=(), defaults=()):
    """An ``_Act`` subclass with the reference's positional arguments
    ``keys`` (their defaults ``defaults``) and ``name`` after them."""
    def __init__(self, *args, name=None, device=None, dtype=None,
                 generator=None, **kwargs):
        if len(args) > len(keys):  # a positional ``name`` after the keys
            args = args[:len(keys)]
        vals = dict(zip(keys, defaults))
        vals.update(zip(keys, args))
        vals.update(kwargs)
        _Act.__init__(self, device=device, dtype=dtype, **vals)

    return type(cls_name, (_Act,), {"_fn": fn, "_keys": keys,
                                    "__init__": __init__,
                                    "__module__": __name__,
                                    "__doc__": f"``F.{fn}`` as a layer."})


ReLU = _act("ReLU", "relu")
ReLU6 = _act("ReLU6", "relu6")
GELU = _act("GELU", "gelu", ("approximate",), (False,))
Sigmoid = _act("Sigmoid", "sigmoid")
Tanh = _act("Tanh", "tanh")
Softmax = _act("Softmax", "softmax", ("axis",), (-1,))
LogSoftmax = _act("LogSoftmax", "log_softmax", ("axis",), (-1,))
LeakyReLU = _act("LeakyReLU", "leaky_relu", ("negative_slope",), (0.01,))
ELU = _act("ELU", "elu", ("alpha",), (1.0,))
CELU = _act("CELU", "celu", ("alpha",), (1.0,))
SELU = _act("SELU", "selu")
Silu = _act("Silu", "silu")
Swish = _act("Swish", "swish")
Mish = _act("Mish", "mish")
Hardshrink = _act("Hardshrink", "hardshrink", ("threshold",), (0.5,))
Softshrink = _act("Softshrink", "softshrink", ("threshold",), (0.5,))
Hardtanh = _act("Hardtanh", "hardtanh", ("min", "max"), (-1.0, 1.0))
Hardsigmoid = _act("Hardsigmoid", "hardsigmoid")
Hardswish = _act("Hardswish", "hardswish")
Softplus = _act("Softplus", "softplus", ("beta", "threshold"), (1.0, 20.0))
Softsign = _act("Softsign", "softsign")
Tanhshrink = _act("Tanhshrink", "tanhshrink")
LogSigmoid = _act("LogSigmoid", "log_sigmoid")
Maxout = _act("Maxout", "maxout", ("groups", "axis"), (None, 1))
ThresholdedReLU = _act("ThresholdedReLU", "thresholded_relu",
                       ("threshold",), (1.0,))
GLU = _act("GLU", "glu", ("axis",), (-1,))


class PReLU(Layer):
    """``where(x > 0, x, weight * x)`` with a learned ``weight`` of
    ``num_parameters`` values (one per channel along the channel axis of
    ``data_format``), each ``init`` at first."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init), device=device,
            generator=generator)

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    """Negative inputs times a slope drawn from ``U(lower, upper)`` in
    training, their mean in eval."""

    def __init__(self, lower=0.125, upper=0.3333333333333333, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._lower, self._upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training)


__all__ = [
    "ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Softmax", "LogSoftmax",
    "LeakyReLU", "PReLU", "ELU", "CELU", "SELU", "Silu", "Swish", "Mish",
    "Hardshrink", "Softshrink", "Hardtanh", "Hardsigmoid", "Hardswish",
    "Softplus", "Softsign", "Tanhshrink", "LogSigmoid", "Maxout",
    "ThresholdedReLU", "RReLU", "GLU",
]
