"""Layer (port of ``paddle_tpu/nn/layer/layers.py:28``), LayerList and
HookRemoveHelper.

``Layer`` is a ``torch.nn.Module`` with Paddle's API on top: parameters are
made by ``create_parameter`` from a ``ParamAttr`` and an initializer,
``parameters()`` is a list, ``set_state_dict`` returns ``(missing,
unexpected)``, ``to``/``astype`` take Paddle's places and dtype names, and
``register_forward_post_hook`` is Paddle's name for torch's forward hook
(``register_forward_pre_hook`` has the same name and arguments in both:
``hook(layer, inputs)``, a non-None result replacing the inputs); both
return Paddle's ``HookRemoveHelper``. ``__call__`` is torch's, so a Layer
costs no host time over a Module.

``state_dict`` is torch's: structured names, persistable buffers only, each
value a detached tensor that shares the parameter's storage.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core import dtype as dtypes
from ...core.place import resolve_device
from ...core.tensor import Parameter
from .. import initializer as init_mod
from ..param_attr import ParamAttr


class HookRemoveHelper:
    """``remove()`` takes the hook ``hook_id`` out of ``hooks`` (one of the
    layer's hook tables)."""

    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._hook_id = hook_id

    def remove(self):
        self._hooks.pop(self._hook_id, None)


class Layer(nn.Module):
    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = (dtypes.convert_dtype(dtype) if dtype
                       else dtypes.get_default_dtype())
        self._name_scope = name_scope or type(self).__name__.lower()

    # -- construction ---------------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None) -> Parameter:
        """A new Parameter of ``shape`` on ``device`` (default
        ``get_device()``), initialized by ``attr``'s initializer, else
        ``default_initializer``, else Xavier-uniform (weights) or 0 (biases);
        ``attr`` also sets its name, trainable flag, lr scale, regularizer
        and ``need_clip``. Random initializers draw from ``generator`` when
        given."""
        dtype = dtypes.convert_dtype(dtype) if dtype else self._dtype
        attr = ParamAttr._to_attr(attr) or ParamAttr()
        initializer = attr.initializer or default_initializer or (
            init_mod._default_bias_init if is_bias
            else init_mod._default_weight_init)
        data = initializer(shape, dtype, resolve_device(device), generator)
        p = Parameter(data, name=attr.name, trainable=attr.trainable)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, persistent=None):
        """``persistable=False`` keeps the buffer out of ``state_dict``."""
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    # -- iteration ------------------------------------------------------------
    def parameters(self, include_sublayers=True, recurse=None):
        return list(super().parameters(
            include_sublayers if recurse is None else recurse))

    def named_parameters(self, prefix="", include_sublayers=True, recurse=None,
                         remove_duplicate=True):
        return super().named_parameters(
            prefix, include_sublayers if recurse is None else recurse,
            remove_duplicate)

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False):
        for i, (name, m) in enumerate(self.named_modules(prefix=prefix)):
            if i or include_self:
                yield name, m

    # -- state ----------------------------------------------------------------
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy each value (a tensor, a numpy array or the reference's
        tensor) into the parameter or buffer of the same name, cast to its
        dtype and moved to its device; a shape mismatch raises
        ``ValueError``. Returns ``(missing, unexpected)`` names."""
        own = self.state_dict(keep_vars=True)
        missing = [name for name in own if name not in state_dict]
        unexpected = []
        for name, value in state_dict.items():
            target = own.get(name)
            if target is None:
                unexpected.append(name)
                continue
            if not isinstance(value, torch.Tensor):
                arr = np.asarray(value)
                if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch view
                    arr = arr.astype(np.float32)
                value = torch.tensor(arr)
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {name}: {tuple(value.shape)} vs "
                    f"{tuple(target.shape)}")
            target.copy_(value)
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- dtype / device -------------------------------------------------------
    def to(self, *args, device=None, dtype=None, blocking=None,
           non_blocking=False):
        """``to(device=None, dtype=None)`` with Paddle's places (``"gpu:0"``,
        ``CUDAPlace``) and dtype names; floating parameters and buffers are
        cast, the others only moved. torch's positional forms work too."""
        for a in args:
            if isinstance(a, (torch.dtype, np.dtype, type)):
                dtype = a
            elif isinstance(a, str) and a.replace("paddle.", "") in \
                    dtypes._NAME_TO_DTYPE:
                dtype = a
            else:
                device = a
        dev = resolve_device(device) if device is not None else None
        dt = dtypes.convert_dtype(dtype)
        if dt is not None and not dtypes.is_floating_point(dt):
            raise TypeError(f"to(): a Layer casts to a floating dtype, "
                            f"not {dt}")
        super().to(device=dev, dtype=dt)
        if dt is not None:
            for layer in self.modules():
                if isinstance(layer, Layer):
                    layer._dtype = dt
        return self

    def astype(self, dtype):
        return self.to(dtype=dtype)

    def float(self):
        return self.to(dtype=torch.float32)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    # -- hooks ----------------------------------------------------------------
    def register_forward_pre_hook(self, hook, *, prepend=False,
                                  with_kwargs=False):
        """``hook(layer, inputs)``; a non-None result replaces the inputs
        (a non-tuple one becomes the only input)."""
        h = super().register_forward_pre_hook(hook, prepend=prepend,
                                              with_kwargs=with_kwargs)
        return HookRemoveHelper(self._forward_pre_hooks, h.id)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)``; a non-None result replaces the
        outputs."""
        h = self.register_forward_hook(hook)
        return HookRemoveHelper(self._forward_hooks, h.id)

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def full_name(self):
        return self._name_scope


class LayerList(Layer, nn.ModuleList):
    """A list of sublayers, named ``0``, ``1``, ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.extend(sublayers)


__all__ = ["Layer", "LayerList", "HookRemoveHelper"]
