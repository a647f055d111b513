"""paddle.autograd (port of ``paddle_tpu/autograd/__init__.py``):
``backward``, ``grad``, ``jacobian``, ``hessian`` and ``PyLayer`` over
torch's autograd.

``grad`` takes Paddle's signature and returns a list; ``PyLayer`` subclasses
write static ``forward(ctx, ...)`` and ``backward(ctx, ...)`` and run as a
``torch.autograd.Function`` made once per subclass; ``jacobian`` and
``hessian`` are ``torch.func``'s over the caller's function.
"""
from __future__ import annotations

import torch

from ..core.engine import enable_grad, no_grad, set_grad_enabled  # noqa: F401


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate into ``.grad`` the gradients of ``tensors`` (one or a
    list), seeded by ``grad_tensors`` (ones for scalars when None)."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    if isinstance(grad_tensors, torch.Tensor):
        grad_tensors = [grad_tensors]
    torch.autograd.backward(list(tensors), grad_tensors,
                            retain_graph=bool(retain_graph))


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """Gradients of ``outputs`` with respect to ``inputs``, without touching
    ``.grad``; an input that ``outputs`` do not reach raises unless
    ``allow_unused`` (then its entry is None). The tensors of
    ``no_grad_vars`` are held constant: no gradient flows through them."""
    outputs = [outputs] if isinstance(outputs, torch.Tensor) else list(outputs)
    inputs = [inputs] if isinstance(inputs, torch.Tensor) else list(inputs)
    if isinstance(grad_outputs, torch.Tensor):
        grad_outputs = [grad_outputs]
    if isinstance(no_grad_vars, torch.Tensor):
        no_grad_vars = [no_grad_vars]
    # a hook that zeroes the gradient arriving at a constant stops it there
    hooks = [t.register_hook(torch.zeros_like) for t in no_grad_vars or ()
             if t.requires_grad]
    try:
        return list(torch.autograd.grad(
            outputs, inputs, grad_outputs,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=allow_unused))
    finally:
        for h in hooks:
            h.remove()


class PyLayerContext:
    """The ``ctx`` a PyLayer's forward and backward share; other attributes
    may be set on it freely."""

    def __init__(self, fctx=None):
        self._fctx = fctx
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        self._fctx.save_for_backward(*tensors)

    def saved_tensor(self):
        return list(self._fctx.saved_tensors)

    saved_tensors = saved_tensor


def _function_for(layer_cls):
    """The ``torch.autograd.Function`` running ``layer_cls``'s forward and
    backward; keyword arguments ride in as the first (non-tensor) input."""
    fn = layer_cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    def forward(fctx, kwargs, *args):
        fctx.pyctx = PyLayerContext(fctx)
        fctx.tensor_args = [isinstance(a, torch.Tensor) for a in args]
        return layer_cls.forward(fctx.pyctx, *args, **kwargs)

    def backward(fctx, *grads):
        out = layer_cls.backward(fctx.pyctx, *grads)
        if out is None or isinstance(out, torch.Tensor):
            out = (out,)
        it = iter(out)
        # one gradient per tensor input, in order; None for the others
        return (None,) + tuple(next(it, None) if is_t else None
                               for is_t in fctx.tensor_args)

    fn = type(f"{layer_cls.__name__}Function", (torch.autograd.Function,),
              {"forward": staticmethod(forward),
               "backward": staticmethod(backward)})
    layer_cls._torch_function = fn
    return fn


class PyLayerMeta(type):
    """The metaclass ``PyLayer`` is built with, as the reference's."""


class PyLayer(metaclass=PyLayerMeta):
    """Custom autograd op: subclass with static ``forward(ctx, *args)`` and
    ``backward(ctx, *grads)``, call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_for(cls).apply(kwargs, *args)


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


def _functional(func, xs, transform):
    """``transform`` (``jacrev`` or ``hessian``) of ``func`` over every
    input; one input gives the first entry, a list all of them."""
    single = isinstance(xs, torch.Tensor)
    xs_l = [xs] if single else list(xs)

    def f(*ts):
        return func(ts[0] if single else list(ts))

    out = transform(f, argnums=tuple(range(len(xs_l))))(
        *[t.detach() for t in xs_l])
    return out, single


def jacobian(func, xs, create_graph=False, allow_unused=False):
    """The Jacobian of ``func`` at ``xs``: a tensor for one input, a tuple
    (one entry an input) for a list."""
    jac, single = _functional(func, xs, torch.func.jacrev)
    return jac[0] if single else tuple(jac)


def hessian(func, xs, create_graph=False, allow_unused=False):
    """The Hessian of scalar ``func`` at ``xs``: a tensor for one input, a
    tuple of tuples (a block a pair of inputs) for a list."""
    hess, single = _functional(func, xs, torch.func.hessian)
    return hess[0][0] if single else tuple(tuple(row) for row in hess)


__all__ = ["backward", "grad", "jacobian", "hessian", "is_grad_enabled",
           "no_grad", "enable_grad", "set_grad_enabled", "PyLayer",
           "PyLayerMeta", "PyLayerContext"]
