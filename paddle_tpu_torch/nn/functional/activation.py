"""Activation functionals (port of ``paddle_tpu/nn/functional/activation.py``).

Each function is the reference's formula in PyTorch ops and calls
``amp_cast`` with the reference's ``eager_call`` name at its entry, so the
O1 lists cast ``softmax`` and ``log_softmax`` to float32 as the reference
does. The random ones (``gumbel_softmax``, ``rrelu`` in training) draw from
the port's generator of the input's device (``core/random.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...core import random as random_state
from ...core.dispatch import amp_cast


def _act(op_name, fn, doc):
    def op(x, name=None):
        x, = amp_cast(op_name, (x,))
        return fn(x)

    op.__name__ = op_name
    op.__doc__ = doc
    return op


def _clip(a, lo, hi):
    """``jnp.clip``'s gradient: halved at a bound (``torch.clamp`` passes
    all of it there)."""
    return torch.minimum(torch.maximum(a, a.new_tensor(lo)), a.new_tensor(hi))


relu = _act("relu", torch.relu, "``max(x, 0)``.")
# jax.nn.relu6's derivative is 0 at 0 and at 6, as hardtanh's backward
relu6 = _act("relu6", TF.relu6, "``min(max(x, 0), 6)``.")
sigmoid = _act("sigmoid", torch.sigmoid, "``1 / (1 + exp(-x))``.")
tanh = _act("tanh", torch.tanh, "``tanh(x)``.")
silu = _act("silu", TF.silu, "``x * sigmoid(x)`` (``jax.nn.silu``).")
swish = silu
mish = _act("mish", lambda a: a * torch.tanh(
    torch.logaddexp(a, torch.zeros_like(a))), "``x * tanh(softplus(x))``.")
tanhshrink = _act("tanhshrink", lambda a: a - torch.tanh(a),
                  "``x - tanh(x)``.")
softsign = _act("softsign", lambda a: a / (1 + a.abs()),
                "``x / (1 + |x|)``.")
log_sigmoid = _act("log_sigmoid", TF.logsigmoid, "``-softplus(-x)``.")
hardswish = _act("hardswish", lambda a: a * _clip(a / 6.0 + 0.5, 0.0, 1.0),
                 "``x * clip(x / 6 + 0.5, 0, 1)``.")


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU, or the tanh form when ``approximate``, as
    ``jax.nn.gelu``'s two forms."""
    x, = amp_cast("gelu", (x,))
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = amp_cast("leaky_relu", (x,))
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``where(x > 0, x, w * x)``; a weight of more than one value lies
    along the channel axis (1, or the last for an ``N...C`` layout)."""
    x, weight = amp_cast("prelu", (x, weight))
    if weight.numel() > 1:
        shape = [1] * x.dim()
        shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
        weight = weight.reshape(shape)
    return torch.where(x > 0, x, weight * x)


def elu(x, alpha=1.0, name=None):
    x, = amp_cast("elu", (x,))
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    x, = amp_cast("celu", (x,))
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554804934193349852946,
         alpha=1.6732632423543772848170429916717, name=None):
    x, = amp_cast("selu", (x,))
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardshrink(x, threshold=0.5, name=None):
    x, = amp_cast("hardshrink", (x,))
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    x, = amp_cast("softshrink", (x,))
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def hardtanh(x, min=-1.0, max=1.0, name=None):
    x, = amp_cast("hardtanh", (x,))
    return _clip(x, min, max)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x, = amp_cast("hardsigmoid", (x,))
    return _clip(slope * x + offset, 0.0, 1.0)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``x`` where ``beta * x > threshold``, else ``softplus(beta * x) /
    beta``."""
    x, = amp_cast("softplus", (x,))
    bx = beta * x
    return torch.where(bx > threshold, x,
                       torch.logaddexp(bx, torch.zeros_like(bx)) / beta)


def _cast(x, dtype):
    if dtype is None:
        return x
    from ...core import dtype as dtypes

    return x.to(dtypes.convert_dtype(dtype))


def softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast("softmax", (_cast(x, dtype),))
    return torch.softmax(x, int(axis))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast("log_softmax", (_cast(x, dtype),))
    return torch.log_softmax(x, int(axis))


def _uniform(shape, device, low, high):
    """Float32 uniform draws in [low, high) from the device's generator."""
    u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return u.uniform_(low, high,
                      generator=random_state.default_generator(device))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """``softmax((x + g) / temperature)`` with Gumbel noise ``g`` drawn from
    the port's generator; ``hard`` gives the one-hot of the argmax with the
    soft gradient (straight through)."""
    x, = amp_cast("gumbel_softmax", (x,))
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(_uniform(x.shape, x.device, tiny, 1.0)))
    y = torch.softmax((x + g.to(x.dtype)) / temperature, axis)
    if hard:
        idx = y.argmax(axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter(axis, idx, 1.0)
        y = (hard_y - y).detach() + y
    return y


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels along ``axis``."""
    x, = amp_cast("maxout", (x,))
    shape = list(x.shape)
    c = shape[axis]
    shape[axis: axis + 1] = [c // groups, groups]
    return x.reshape(shape).amax(axis + 1)


def glu(x, axis=-1, name=None):
    """``a * sigmoid(b)`` of the two halves along ``axis``."""
    x, = amp_cast("glu", (x,))
    return TF.glu(x, axis)


def thresholded_relu(x, threshold=1.0, name=None):
    x, = amp_cast("thresholded_relu", (x,))
    return torch.where(x > threshold, x, torch.zeros_like(x))


def rrelu(x, lower=0.125, upper=0.3333333333333333, training=False,
          name=None):
    """Negative inputs times a slope: drawn per element from
    ``U(lower, upper)`` in training (float32, then cast), else their mean."""
    x, = amp_cast("rrelu", (x,))
    if training:
        slope = _uniform(x.shape, x.device, lower, upper).to(x.dtype)
    else:
        slope = torch.full_like(x, (lower + upper) / 2.0)
    return torch.where(x >= 0, x, slope * x)


def _inplace(x, what):
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{what}(): in-place on a tensor that requires grad")


def relu_(x, name=None):
    """In-place relu (refused on a tensor that records gradients, as the
    reference's)."""
    _inplace(x, "relu_")
    return x.copy_(relu(x))


def elu_(x, alpha=1.0, name=None):
    _inplace(x, "elu_")
    return x.copy_(elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    _inplace(x, "softmax_")
    return x.copy_(softmax(x, axis))


__all__ = [
    "relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish",
    "tanhshrink", "softsign", "log_sigmoid", "gelu", "leaky_relu", "prelu",
    "elu", "celu", "selu", "hardshrink", "softshrink", "hardtanh",
    "hardsigmoid", "hardswish", "softplus", "softmax", "log_softmax",
    "gumbel_softmax", "maxout", "glu", "thresholded_relu", "rrelu", "relu_",
    "elu_", "softmax_",
]
