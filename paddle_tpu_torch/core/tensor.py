"""Tensor, Parameter and ``to_tensor`` (port of ``paddle_tpu/core/tensor.py``).

There is no wrapper class: ``Tensor`` is ``torch.Tensor``. The train step is
host-bound, and a ``__torch_function__`` subclass would tax every op it
launches. ``Parameter`` subclasses ``torch.nn.Parameter`` and adds Paddle's
attributes; ``to_tensor`` keeps the reference's dtype rules and lands on
``set_device``'s device (the card unless the CPU was asked for).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import unique_name
from . import dtype as dtypes
from . import place as place_mod

Tensor = torch.Tensor


class Parameter(torch.nn.Parameter):
    """A trainable tensor with Paddle's ``name`` (``param_<n>`` unless
    given), ``trainable``, ``optimize_attr`` (the per-parameter lr scale),
    ``regularizer`` and ``need_clip``. ``stop_gradient`` and ``trainable``
    read and write ``requires_grad``.

    ``Module.to``/``bfloat16()`` keep the object (they assign ``.data``), so
    the attributes survive them; ``copy.deepcopy`` copies them. The
    ``Parameter(data, requires_grad)`` call of ``torch.nn.Parameter`` is
    accepted too."""

    def __new__(cls, data=None, dtype=None, name=None, trainable=True):
        if isinstance(dtype, bool):  # nn.Parameter's (data, requires_grad)
            dtype, trainable = None, dtype
        if data is None:
            data = torch.empty(0)
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if dtype is not None:
            data = data.to(dtypes.convert_dtype(dtype))
        self = torch.Tensor._make_subclass(cls, data.detach(), bool(trainable))
        self.name = name or unique_name.generate("param")
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.persistable = True
        return self

    def __init__(self, *args, **kwargs):
        pass  # all set in __new__

    @property
    def name(self) -> str:  # torch's own ``Tensor.name`` is read-only
        return self.__dict__["_param_name"]

    @name.setter
    def name(self, value: str) -> None:
        self.__dict__["_param_name"] = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value: bool) -> None:
        self.requires_grad_(not value)

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value: bool) -> None:
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         name=self.name, trainable=self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


def _place_device(place) -> torch.device:
    return place_mod.resolve_device(place)


def to_tensor(data, dtype=None, place=None,
              stop_gradient=True) -> torch.Tensor:
    """A new tensor on ``place`` (default: ``get_device()``). A float64
    array or a Python float becomes the default dtype, a Python int int64;
    other numpy dtypes are kept. ``stop_gradient=False`` makes it a leaf
    that records gradients."""
    dev = _place_device(place)
    dt = dtypes.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach()
        if dt is None and t.dtype == torch.float64:
            dt = dtypes.get_default_dtype()
        t = t.to(device=dev, dtype=dt, copy=True)
    else:
        arr = np.asarray(data)
        if dt is None and arr.dtype == np.float64:
            dt = dtypes.get_default_dtype()
        t = torch.tensor(arr, device=dev)
        if dt is not None and t.dtype != dt:
            t = t.to(dt)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def host_arrays(*xs):
    """Every argument as a numpy array (bfloat16 as float32), with one
    device sync: each card tensor is copied without blocking (into pinned
    memory), then the current stream is waited on once, instead of one
    blocking ``.cpu()`` a tensor."""
    ts = [x.detach() if isinstance(x, torch.Tensor)
          else torch.as_tensor(np.asarray(x)) for x in xs]
    on_card = [t.device.type == "cuda" for t in ts]
    if any(on_card):
        ts = [t.to("cpu", non_blocking=True) if c else t
              for t, c in zip(ts, on_card)]
        torch.cuda.current_stream().synchronize()
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for t in ts]


__all__ = ["Tensor", "Parameter", "to_tensor", "host_arrays"]
