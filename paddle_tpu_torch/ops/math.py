"""Math ops (port of ``paddle_tpu/ops/math.py``): plain functions over
``torch.Tensor`` under Paddle's names and arguments (``axis``, ``keepdim``,
``transpose_x``). A Python number operand stays a weakly typed scalar, as in
the reference. The functions whose reference counterparts ``amp``'s lists
name (``matmul``, ``mm``, ``bmm``, ``addmm``, ``exp``, ``log``, ``square``,
``sum``, ``mean``, ``logsumexp``, ``erf``, ``erfinv``) cast their inputs
through :func:`~paddle_tpu_torch.core.dispatch.amp_cast` at entry.

Where torch's function of the same name differs from the reference's, the
reference's is kept: ``median`` and ``quantile`` interpolate (torch's
``median`` takes the lower middle), ``cummax``/``cummin`` give the first
index of a tie (torch's the last), ``outer`` flattens its inputs and
``lerp`` is ``x + w * (y - x)``.
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtypes
from ..core.dispatch import amp_cast
from .creation import _as


def _operand(v):
    return v if isinstance(v, (bool, int, float)) else _as(v)


def _pair(x, y, keep_y=False):
    """Tensor operands; a Python number becomes a 0-d CPU tensor, which
    promotes like a weak scalar and combines with a tensor on the card.
    ``keep_y``: ``y`` may stay a number (the op takes one)."""
    x, y = _operand(x), _operand(y)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    if not isinstance(y, torch.Tensor) and not keep_y:
        y = torch.as_tensor(y)
    return x, y


def _binary(fn, keep_y=False):
    def op(x, y, name=None):
        return fn(*_pair(x, y, keep_y))

    op.__name__ = fn.__name__
    return op


add = _binary(torch.add, keep_y=True)
subtract = _binary(torch.subtract, keep_y=True)
multiply = _binary(torch.multiply, keep_y=True)
divide = _binary(torch.divide, keep_y=True)
floor_divide = _binary(torch.floor_divide, keep_y=True)
remainder = _binary(torch.remainder, keep_y=True)
mod = remainder
floor_mod = remainder
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2)
hypot = _binary(torch.hypot)
copysign = _binary(torch.copysign)
nextafter = _binary(torch.nextafter)
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
ldexp = _binary(torch.ldexp)


def heaviside(x, y, name=None):
    x, y = _pair(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


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

    op.__name__ = getattr(fn, "__name__", amp_name)
    return op


exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1)
log = _unary(torch.log, "log")
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
abs = _unary(torch.abs)
neg = _unary(torch.neg)
sign = _unary(torch.sign)
floor = _unary(torch.floor)
ceil = _unary(torch.ceil)
round = _unary(torch.round)  # half to even, as jnp.round
trunc = _unary(torch.trunc)
frac = _unary(lambda a: a - torch.trunc(a))
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
erf = _unary(torch.erf, "erf")
erfinv = _unary(torch.erfinv, "erfinv")
reciprocal = _unary(torch.reciprocal)
square = _unary(torch.square, "square")
digamma = _unary(torch.digamma)
lgamma = _unary(torch.lgamma)
sigmoid = _unary(torch.sigmoid)
i0 = _unary(torch.special.i0)
i1 = _unary(torch.special.i1)
isnan = _unary(torch.isnan)
isinf = _unary(torch.isinf)
isfinite = _unary(torch.isfinite)
logical_not = _unary(torch.logical_not)
bitwise_not = _unary(torch.bitwise_not)


def clip(x, min=None, max=None, name=None):
    """``jnp.clip``: on floating tensors the gradient is halved at a bound
    (``torch.clamp`` would pass all of it)."""
    mn = min.item() if isinstance(min, torch.Tensor) else min
    mx = max.item() if isinstance(max, torch.Tensor) else max
    x = _as(x)
    if not x.is_floating_point():
        return torch.clamp(x, mn, mx)
    if mn is not None:
        x = torch.maximum(x, x.new_tensor(mn))
    if mx is not None:
        x = torch.minimum(x, x.new_tensor(mx))
    return x


def lerp(x, y, weight, name=None):
    x, y = _as(x), _as(y)
    return x + _operand(weight) * (y - x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(_as(x), nan=nan, posinf=posinf, neginf=neginf)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * _as(x))


# -- comparison / logical ----------------------------------------------------
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
logical_and = _binary(torch.logical_and)
logical_or = _binary(torch.logical_or)
logical_xor = _binary(torch.logical_xor)
bitwise_and = _binary(torch.bitwise_and)
bitwise_or = _binary(torch.bitwise_or)
bitwise_xor = _binary(torch.bitwise_xor)


def equal_all(x, y, name=None):
    """A 0-d bool tensor: same shape and every element equal."""
    x, y = _as(x), _as(y)
    if x.shape != y.shape:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.eq(x, y).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor on the inputs' device (no host sync)."""
    return torch.isclose(_as(x), _as(y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(_as(x), _as(y), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


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


amax = max
amin = min


def prod(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    for d in sorted((a % builtins.max(x.dim(), 1) for a in _dims(x, axis)),
                    reverse=True):
        x = torch.prod(x, d, keepdim=keepdim)
    return x


def all(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    return torch.all(x, _dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    return torch.any(x, _dims(x, axis), keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _as(x)
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _as(x)
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


def _quantile(x, q, axis, keepdim, nan=False):
    """``jnp.quantile``/``jnp.nanquantile`` (linear interpolation) over one
    axis, several or all: the axes are moved last and flattened into one.
    Half types are computed in float32 and cast back."""
    x = _as(x)
    dims = tuple(sorted(d % builtins.max(x.dim(), 1)
                        for d in _dims(x, axis)))
    keep = [d for d in range(x.dim()) if d not in dims]
    y = x.permute(*keep, *dims).reshape(*[x.shape[d] for d in keep], -1)
    work = y if y.dtype in (torch.float32, torch.float64) else y.float()
    qt = torch.as_tensor(q, dtype=work.dtype, device=work.device)
    fn = torch.nanquantile if nan else torch.quantile
    out = fn(work, qt, dim=-1)
    if keepdim:
        shape = [1 if d in dims else s for d, s in enumerate(x.shape)]
        out = out.reshape(*out.shape[:qt.dim()], *shape)
    return out.to(x.dtype)


def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values for an even count (``jnp.median``;
    ``torch.median`` takes the lower one)."""
    return _quantile(x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = _as(x)
    return torch.nanmean(x, _dims(x, axis), keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = _as(x)
    return torch.nansum(x, _dims(x, axis), keepdim=keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x, = amp_cast("logsumexp", (_as(x),))
    return torch.logsumexp(x, _dims(x, axis), keepdim=keepdim)


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


# -- scans ------------------------------------------------------------------
def _scan_input(x, axis):
    """(tensor, dim): the flattened input along 0 when ``axis`` is None."""
    x = _as(x)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def cumsum(x, axis=None, dtype=None, name=None):
    """Over the flattened input when ``axis`` is None."""
    x, d = _scan_input(x, axis)
    return torch.cumsum(x, d)


def cumprod(x, dim=None, dtype=None, name=None):
    x, d = _scan_input(x, dim)
    return torch.cumprod(x, d)


def _cum_minmax(x, axis, fn):
    """Running max/min with the index where each running value was first
    reached (the reference's scan keeps the earlier index of a tie)."""
    x, d = _scan_input(x, axis)
    vals = fn(x, d).values
    n = x.shape[d]
    shape = [1] * x.dim()
    shape[d] = n
    pos = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    first = torch.ones_like(vals.narrow(d, 0, 1), dtype=torch.bool)
    change = torch.cat([first, vals.narrow(d, 1, n - 1)
                        != vals.narrow(d, 0, n - 1)], d)
    idx = torch.cummax(torch.where(change, pos, torch.zeros_like(pos)),
                       d).values
    return vals, idx


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_minmax(x, axis, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_minmax(x, axis, torch.cummin)


def logcumsumexp(x, axis=None, name=None):
    x, d = _scan_input(x, axis)
    return torch.logcumsumexp(x, d)


# -- matmul family ----------------------------------------------------------
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = amp_cast("matmul", (_as(x), _as(y)))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    x, y = amp_cast("mm", (_as(x), _as(y)))
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    x, y = amp_cast("bmm", (_as(x), _as(y)))
    return torch.matmul(x, y)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    i, x, y = amp_cast("addmm", (_as(input), _as(x), _as(y)))
    return beta * i + alpha * torch.matmul(x, y)


def dot(x, y, name=None):
    x, y = _as(x), _as(y)
    return torch.sum(x * y, -1)


def inner(x, y, name=None):
    return torch.inner(_as(x), _as(y))


def outer(x, y, name=None):
    return torch.outer(_as(x).reshape(-1), _as(y).reshape(-1))


def kron(x, y, name=None):
    return torch.kron(_as(x), _as(y))


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_as(x), offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_as(x), offset, axis1, axis2)


def mv(x, vec, name=None):
    return torch.matmul(_as(x), _as(vec))


def dist(x, y, p=2, name=None):
    return torch.linalg.vector_norm((_as(x) - _as(y)).reshape(-1),
                                    ord=float(p))


# -- misc -------------------------------------------------------------------
def cast(x, dtype):
    return _as(x).to(dtypes.convert_dtype(dtype))


def increment(x, value=1.0, name=None):
    """Adds ``value`` to ``x`` in place (outside the autograd record, as
    the reference rebinds the buffer) and returns ``x``."""
    with torch.no_grad():
        x.add_(value)
    return x


def accuracy_tensor(pred, label):
    """Top-1 accuracy of (N, C) scores against (N,) labels, a 0-d f32."""
    pred, label = _as(pred), _as(label)
    hit = torch.argmax(pred, -1) == label.reshape(-1)
    return hit.float().mean()


__all__ = [
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "floor_mod", "maximum", "minimum", "fmax", "fmin", "atan2",
    "hypot", "heaviside", "copysign", "nextafter", "gcd", "lcm", "ldexp",
    "pow", "scale", "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "abs", "neg", "sign", "floor", "ceil", "round", "trunc", "frac",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
    "asinh", "acosh", "atanh", "erf", "erfinv", "reciprocal", "square",
    "digamma", "lgamma", "sigmoid", "i0", "i1", "isnan", "isinf",
    "isfinite", "logical_not", "bitwise_not", "clip", "lerp", "nan_to_num",
    "stanh", "equal", "not_equal", "greater_than", "greater_equal",
    "less_than", "less_equal", "logical_and", "logical_or", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "equal_all", "allclose",
    "isclose", "sum", "mean", "max", "min", "amax", "amin", "prod", "all",
    "any", "std", "var", "median", "quantile", "nanmean", "nansum",
    "logsumexp", "argmax", "argmin", "cumsum", "cumprod", "cummax",
    "cummin", "logcumsumexp", "matmul", "mm", "bmm", "addmm", "dot",
    "inner", "outer", "kron", "trace", "diagonal", "mv", "dist", "cast",
    "increment", "accuracy_tensor",
]
