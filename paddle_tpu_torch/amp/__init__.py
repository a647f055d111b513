"""AMP: automatic mixed precision (port of ``paddle_tpu/amp/__init__.py``).

``auto_cast`` installs the reference's hook (``core/dispatch.py``
``set_amp_hook``), which casts the floating inputs of the port functions
named on its O1/O2 lists at their entry: under O1 the white list runs in
the low-precision dtype, the black list in float32 and every other op
follows its inputs; under O2 everything but the black list runs in the
low-precision dtype. The cast is ``Tensor.to``, which is differentiable, so
a float32 parameter gets a float32 gradient. bfloat16 is the default (no
loss scaling needed); float16 with ``GradScaler``'s dynamic loss scaling is
kept, as in the reference.

The hook is called only by the port functions whose reference counterparts
are named on the lists (``core/dispatch.py``). Under O2 the reference also
casts every other op at its ``eager_call``; the port's other functions
follow their inputs, which are low precision already once
``decorate(level="O2")`` has cast the parameters.
"""
from __future__ import annotations

import contextlib

import torch

from ..core import dispatch
from ..core import dtype as dtypes

# O1 lists (reference fluid/dygraph/amp/auto_cast.py:33-79)
WHITE_LIST = {
    "matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm", "addmm",
    "scaled_dot_product_attention", "einsum",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "c_softmax_with_cross_entropy", "layer_norm", "norm",
    "batch_norm", "group_norm", "instance_norm", "logsumexp", "erf", "erfinv",
    "log_softmax", "mse_loss", "l1_loss", "nll_loss", "bce", "bce_with_logits",
}


class _AmpState:
    enabled = False
    dtype = torch.bfloat16
    level = "O1"


_state = _AmpState()


def _cast_tensors(tensors, dt):
    return [t.to(dt) if isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.dtype != dt else t for t in tensors]


def _amp_hook(op_name, tensors):
    if not _state.enabled:
        return tensors
    if _state.level == "O2":
        if op_name in BLACK_LIST:
            return _cast_tensors(tensors, torch.float32)
        return _cast_tensors(tensors, _state.dtype)
    # O1: white list -> low precision; black list -> fp32; else follow inputs
    if op_name in WHITE_LIST:
        return _cast_tensors(tensors, _state.dtype)
    if op_name in BLACK_LIST:
        return _cast_tensors(tensors, torch.float32)
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """``paddle.amp.auto_cast``: the custom lists join the white or black
    list for the block, and the lists, level and dtype are restored on
    exit."""
    prev = (_state.enabled, _state.dtype, _state.level)
    prev_white = set(WHITE_LIST)
    prev_black = set(BLACK_LIST)
    if custom_white_list:
        WHITE_LIST.update(custom_white_list)
        BLACK_LIST.difference_update(custom_white_list)
    if custom_black_list:
        BLACK_LIST.update(custom_black_list)
        WHITE_LIST.difference_update(custom_black_list)
    _state.enabled = enable
    _state.dtype = dtypes.convert_dtype(dtype)
    _state.level = level
    dispatch.set_amp_hook(_amp_hook if enable else None)
    try:
        yield
    finally:
        _state.enabled, _state.dtype, _state.level = prev
        WHITE_LIST.clear()
        WHITE_LIST.update(prev_white)
        BLACK_LIST.clear()
        BLACK_LIST.update(prev_black)
        dispatch.set_amp_hook(_amp_hook if _state.enabled else None)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Casts the models' parameters to ``dtype`` for O2; O1 leaves them."""
    dt = dtypes.convert_dtype(dtype)
    singleton = not isinstance(models, (list, tuple))
    model_list = [models] if singleton else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=dt)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (reference ``paddle/amp/grad_scaler.py:26``).

    ``unscale_`` divides each gradient by the scale in float32 (a true
    division by a 0-d tensor on the gradients' device: the card's kernel for
    a tensor divided by a Python number multiplies by the reciprocal, which
    changes the bits when the scale is not a power of two), stores it back
    in the gradient's dtype, and reads one non-finite flag over all of them
    with one host sync (the reference syncs once a parameter)."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = set()  # id(optimizer) already unscaled this step

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        if id(optimizer) in self._unscaled:
            return  # already unscaled this step (e.g. an explicit unscale_
            # for grad clipping followed by step())
        self._unscaled.add(id(optimizer))
        params = [p for p in optimizer._parameter_list or []
                  if p.grad is not None]
        if not params:
            self._found_inf = False
            return
        self._found_inf = _unscale_grads(params, self._scale)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def update(self):
        self._unscaled.clear()
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled.clear()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_scale(self):
        return self._scale

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)

    set_state_dict = load_state_dict


def _unscale_grads(params, scale: float) -> bool:
    """Divide every ``p.grad`` by ``scale`` in float32, in place; True when
    any unscaled value is not finite (one host sync)."""
    grads = [p.grad for p in params]
    f32 = [g if g.dtype == torch.float32 else g.float() for g in grads]
    s = torch.tensor(scale, dtype=torch.float32, device=grads[0].device)
    torch._foreach_div_(f32, s)
    # x * 0 is 0 for a finite x and NaN otherwise, and a sum keeps a NaN:
    # the flag is exact at any magnitude (a sum of squares could overflow)
    probe = torch._foreach_norm(torch._foreach_mul(f32, 0.0), 1)
    found = not bool(torch.isfinite(torch.stack(probe).sum()))
    for g, u in zip(grads, f32):
        if u is not g:
            g.copy_(u)
    return found


__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "WHITE_LIST",
           "BLACK_LIST"]
