"""Math ops (port of the subset of ``paddle_tpu/ops/math.py`` that ``nn`` and
the models call): plain functions over ``torch.Tensor`` under Paddle's names
and arguments (``axis``, ``keepdim``, ``transpose_x``). A Python number
operand stays a weakly typed scalar, as in the reference.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtypes
from ..core.dispatch import amp_cast
from .creation import _as


def _operand(v):
    return v if isinstance(v, (bool, int, float)) else _as(v)


def _binary(fn):
    def op(x, y, name=None):
        x, y = _operand(x), _operand(y)
        if not isinstance(x, torch.Tensor):  # a 0-d CPU scalar stays weak
            x = torch.as_tensor(x)
        return fn(x, y)

    op.__name__ = fn.__name__
    return op


add = _binary(torch.add)
subtract = _binary(torch.subtract)
multiply = _binary(torch.multiply)
divide = _binary(torch.divide)
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)


def pow(x, y, name=None):
    return torch.pow(_as(x), _operand(y))


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    x = _as(x)
    if bias_after_scale:
        return x * float(scale) + float(bias)
    return (x + float(bias)) * float(scale)


def _unary(fn, amp_name=None):
    """``amp_name``: the reference's ``eager_call`` name, when it is on one
    of ``amp``'s lists (the input is cast under ``auto_cast``)."""
    if amp_name is None:
        def op(x, name=None):
            return fn(_as(x))
    else:
        def op(x, name=None):
            x, = amp_cast(amp_name, (_as(x),))
            return fn(x)

    op.__name__ = fn.__name__
    return op


exp = _unary(torch.exp, "exp")
log = _unary(torch.log, "log")
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
abs = _unary(torch.abs)
tanh = _unary(torch.tanh)
sigmoid = _unary(torch.sigmoid)
square = _unary(torch.square, "square")


def clip(x, min=None, max=None, name=None):
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    return torch.clamp(_as(x), mn, mx)


def _cmp(fn):
    def op(x, y, name=None):
        return fn(_as(x), _operand(y))

    op.__name__ = fn.__name__
    return op


equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
greater_than = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
less_than = _cmp(torch.lt)
less_equal = _cmp(torch.le)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor on the inputs' device (no host sync)."""
    return torch.isclose(_as(x), _as(y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


# -- reductions -------------------------------------------------------------
def _dims(x, axis):
    """``axis`` as a tuple of dims (None: every dim)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return (int(axis),)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    """bool and integer inputs sum in int64, as the reference under x64."""
    x, = amp_cast("sum", (_as(x),))
    dt = dtypes.convert_dtype(dtype)
    if dt is None and not x.is_floating_point() and not x.is_complex():
        dt = torch.int64
    return torch.sum(x, _dims(x, axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    x, = amp_cast("mean", (_as(x),))
    return torch.mean(x, _dims(x, axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    return torch.amax(x, _dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    return torch.amin(x, _dims(x, axis), keepdim=keepdim)


def prod(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _dims(x, axis)),
                    reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = _as(x)
    if axis is None:
        return torch.argmax(x)
    return torch.argmax(x, int(axis), keepdim=keepdim)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    x = _as(x)
    if axis is None:
        return torch.argmin(x)
    return torch.argmin(x, int(axis), keepdim=keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    """Over the flattened input when ``axis`` is None."""
    x = _as(x)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0)
    return torch.cumsum(x, int(axis))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = amp_cast("matmul", (_as(x), _as(y)))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def cast(x, dtype):
    return _as(x).to(dtypes.convert_dtype(dtype))


__all__ = ["add", "subtract", "multiply", "divide", "maximum", "minimum",
           "pow", "scale", "exp", "log", "sqrt", "rsqrt", "abs", "tanh",
           "sigmoid", "square", "clip", "equal", "not_equal", "greater_than",
           "greater_equal", "less_than", "less_equal", "allclose", "sum",
           "mean", "max", "min", "prod", "argmax", "argmin", "cumsum",
           "matmul", "cast"]
