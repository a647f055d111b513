"""Custom op registration (port of ``paddle_tpu/incubate/custom_op.py``).

Reference ``paddle/fluid/framework/custom_operator.cc`` and
``python/paddle/utils/cpp_extension``: the plugin path for user-defined
ops. A user op is a PyTorch function of tensors (which may launch a kernel
of its own), optionally with a hand-written vjp: ``vjp=(fwd, bwd)`` as in
``jax.custom_vjp`` — ``fwd(*inputs, **attrs)`` returns ``(out,
residuals)``, ``bwd(residuals, cotangent)`` the inputs' cotangents — which
becomes a ``torch.autograd.Function``. Registration installs the op as
``paddle_tpu_torch.<name>`` and, with ``tensor_method``, as a tensor method
where ``torch.Tensor`` has no attribute of that name::

    def my_gelu(x):
        return 0.5 * x * (1 + torch.tanh(0.79788456 * (x + 0.044715 * x**3)))

    paddle.incubate.register_custom_op("my_gelu", my_gelu)
    y = paddle.my_gelu(t)  # autograd-ready
"""
from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.place import get_device

_REGISTRY = {}


class _VjpOp(torch.autograd.Function):
    """``spec`` = (fwd, bwd, attrs, nondiff_outputs); the tensors follow."""

    @staticmethod
    def forward(ctx, spec, *inputs):
        fwd, bwd, attrs, nondiff = spec
        out, res = fwd(*inputs, **attrs)
        ctx.bwd, ctx.res, ctx.tuple_out = bwd, res, isinstance(out,
                                                              (tuple, list))
        outs = tuple(out) if ctx.tuple_out else (out,)
        ctx.mark_non_differentiable(*[outs[i] for i in nondiff])
        return tuple(outs) if ctx.tuple_out else out

    @staticmethod
    def backward(ctx, *gs):
        cts = ctx.bwd(ctx.res, tuple(gs) if ctx.tuple_out else gs[0])
        return (None, *cts)


def _as_tensor(t):
    if isinstance(t, torch.Tensor):
        return t
    return torch.as_tensor(np.asarray(t), device=get_device())


def register_custom_op(
    name: str,
    fn: Callable,
    vjp: Optional[Tuple[Callable, Callable]] = None,
    n_inputs: Optional[int] = None,
    differentiable: bool = True,
    nondiff_outputs: Sequence[int] = (),
    tensor_method: bool = False,
):
    """Register ``fn(*tensors, **attrs)`` as op ``name`` and return the
    wrapper (also installed as ``paddle_tpu_torch.<name>``)."""
    if name in _REGISTRY:
        raise ValueError(f"custom op {name!r} already registered")
    try:
        param_names = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):  # a builtin such as torch.square
        param_names = []
    nondiff = tuple(int(i) for i in nondiff_outputs)

    def op(*inputs, **attrs):
        attrs.pop("name", None)
        k = n_inputs if n_inputs is not None else len(inputs)
        tensors = [_as_tensor(t) for t in inputs[:k]]
        # trailing positionals are non-tensor attrs: map them onto fn's
        # remaining parameter names so fn(*tensors, **attrs) receives them
        for pname, val in zip(param_names[k:], inputs[k:]):
            attrs.setdefault(pname, val)
        if not differentiable:
            with torch.no_grad():
                return fn(*tensors, **attrs)
        if vjp is not None:
            return _VjpOp.apply((vjp[0], vjp[1], attrs, nondiff), *tensors)
        out = fn(*tensors, **attrs)
        if nondiff:
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            for i in nondiff:
                outs[i] = outs[i].detach()
            out = type(out)(outs) if isinstance(out, (tuple, list)) \
                else outs[0]
        return out

    op.__name__ = name
    op.__doc__ = f"Custom op {name!r} (reference custom_operator.cc plugin path)."
    _REGISTRY[name] = op

    import paddle_tpu_torch as _p

    if not hasattr(_p, name):
        setattr(_p, name, op)
    if tensor_method and not hasattr(torch.Tensor, name):
        setattr(torch.Tensor, name, op)
    return op


def get_custom_op(name: str):
    return _REGISTRY.get(name)


def registered_custom_ops():
    return sorted(_REGISTRY)


__all__ = ["register_custom_op", "get_custom_op", "registered_custom_ops"]
