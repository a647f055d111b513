"""In-place op variants (port of ``paddle_tpu/ops/inplace.py``):
``INPLACE_OPS`` maps ``<op>_`` to a function ``(x, *args, **kwargs)`` that
computes ``<op>(x, ...)`` and writes it into ``x``: with ``copy_`` when the
shape and dtype stay, else by rebinding ``x``'s data (``reshape_``,
``cast_``, ...), as the reference rebinds its buffer. Like the reference,
each refuses a target that requires grad while grad is enabled.

``uniform_(min, max, seed)`` (a nonzero ``seed`` makes the refill
repeatable), ``normal_``, ``exponential_``, ``fill_`` and ``zero_`` draw
from the port's generator of the tensor's device.

``attach`` sets a ``torch.Tensor`` method only where torch has no attribute
of that name. Torch's own ``uniform_(from, to)``, ``scatter_``,
``renorm_``, ``fill_diagonal_`` and the rest stay torch's, with torch's
semantics; the functions in ``INPLACE_OPS`` (and the top-level
``paddle_tpu_torch.scatter_`` and friends) are Paddle's.
"""
from __future__ import annotations

import torch

from ..core import random as random_state

# base-op name -> resolved from the assembled package at call time
_INPLACE_BASES = [
    "add", "subtract", "multiply", "divide", "remainder", "pow",
    "clip", "scale", "exp", "sqrt", "rsqrt", "reciprocal", "round",
    "floor", "ceil", "trunc", "abs", "tanh", "sigmoid", "erfinv", "sin",
    "cos", "neg", "sign", "lerp", "cast", "flatten", "reshape", "squeeze",
    "unsqueeze", "clone", "tril", "triu", "digamma", "lgamma",
    "nan_to_num", "logit", "masked_fill", "index_add", "put_along_axis",
    "scatter", "renorm", "fill_diagonal",
]


def _refuse(x, name):
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}(): in-place on a tensor that requires grad is not "
            "supported (the reference's inplace version-check error); use "
            f"the out-of-place {name[:-1]}() instead")


def _rebind(x, out, name):
    """``x`` holding ``out``'s values (and shape and dtype), returned."""
    _refuse(x, name)
    with torch.no_grad():
        if out.shape == x.shape and out.dtype == x.dtype:
            x.copy_(out)
        else:
            x.data = out
    return x


def _make_inplace(base_name):
    def op_(self, *args, **kwargs):
        import paddle_tpu_torch as _p

        base = getattr(_p, base_name)
        return _rebind(self, base(self, *args, **kwargs), base_name + "_")

    op_.__name__ = base_name + "_"
    op_.__doc__ = f"In-place variant of `{base_name}` (writes into the tensor)."
    return op_


def _generator(x, seed=0):
    if seed:
        return torch.Generator(device=x.device).manual_seed(int(seed))
    return random_state.default_generator(x.device)


def uniform_(self, min=-1.0, max=1.0, seed=0):
    """Refill with uniform draws on [min, max); a nonzero ``seed`` draws
    from a generator seeded with it (the same refill every time)."""
    _refuse(self, "uniform_")
    with torch.no_grad():
        torch.Tensor.uniform_(self, min, max, generator=_generator(self, seed))
    return self


def normal_(self, mean=0.0, std=1.0):
    _refuse(self, "normal_")
    with torch.no_grad():
        torch.Tensor.normal_(self, mean, std, generator=_generator(self))
    return self


def exponential_(self, lam=1.0):
    _refuse(self, "exponential_")
    with torch.no_grad():
        torch.Tensor.exponential_(self, lam, generator=_generator(self))
    return self


def fill_(self, value):
    _refuse(self, "fill_")
    with torch.no_grad():
        torch.Tensor.fill_(self, value)
    return self


def zero_(self):
    return fill_(self, 0.0)


INPLACE_OPS = {}


def attach():
    for base in _INPLACE_BASES:
        name = base + "_"
        fn = _make_inplace(base)
        INPLACE_OPS[name] = fn
        if not hasattr(torch.Tensor, name):
            setattr(torch.Tensor, name, fn)
    for name, fn in (
        ("fill_", fill_), ("zero_", zero_), ("uniform_", uniform_),
        ("normal_", normal_), ("exponential_", exponential_),
    ):
        INPLACE_OPS[name] = fn
        if not hasattr(torch.Tensor, name):
            setattr(torch.Tensor, name, fn)


attach()
