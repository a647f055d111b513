"""Tensor, Parameter and ``to_tensor`` (port of ``paddle_tpu/core/tensor.py``).

There is no wrapper class: ``Tensor`` is ``torch.Tensor``. Under the lazy
engine (``core/lazy.py``) an op's result is a :class:`LazyArray`, a
``torch.Tensor`` subclass whose host reads flush the pending graph first
(as the reference's ``.numpy()``, ``__array__`` and print do);
``lazy_timed_block`` is the engine's attributed host wait. The train step is
host-bound, and a ``__torch_function__`` subclass would tax every op it
launches. ``Parameter`` subclasses ``torch.nn.Parameter`` and adds Paddle's
attributes; ``to_tensor`` keeps the reference's dtype rules and lands on
``set_device``'s device (the card unless the CPU was asked for).

The reference Tensor's own attributes that ``torch.Tensor`` lacks
(``stop_gradient``, ``place``, ``persistable``, ``clear_grad`` and
``clear_gradient``, ``set_value``, ``pspec``, ``grad_pspec``,
``opt_state_pspec``) are set on ``torch.Tensor`` at import, each only where
torch has no attribute of that name (:data:`ATTACHED` lists them); a
``Parameter`` is a leaf, so its ``stop_gradient`` is ``requires_grad``
negated.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..utils import unique_name
from . import dtype as dtypes
from . import lazy
from . import place as place_mod
from .lazy import LazyArray, timed_block as lazy_timed_block

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
        # a parameter holds a concrete tensor: under the lazy engine its
        # data is materialized and it is made eagerly
        data = lazy.concrete(data)
        with lazy.eager():
            if dtype is not None:
                data = data.to(dtypes.convert_dtype(dtype))
            self = torch.Tensor._make_subclass(cls, data.detach(),
                                               bool(trainable))
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


def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value) -> None:
    """``True`` on a leaf stops recording; on an intermediate it cuts the
    graph there (``detach_``): later ops see the tensor as a constant, as the
    reference's routes do. ``False`` on a leaf records gradients; on an
    intermediate it changes nothing. A cut cannot be undone, and a view
    cannot be cut in place: both raise."""
    if value:
        if self.grad_fn is None:
            self.requires_grad_(False)
            return
        if self._is_view():
            raise RuntimeError(
                "stop_gradient = True on a view of another tensor cannot "
                "cut the graph in place; use x = x.detach() instead")
        self.detach_()
        self.__dict__["_graph_cut"] = True
    elif self.grad_fn is None:
        if self.__dict__.get("_graph_cut"):
            raise RuntimeError(
                "stop_gradient = False cannot reconnect a tensor whose graph "
                "was cut by stop_gradient = True; compute it again instead")
        self.requires_grad_(True)


def _place(self):
    """The tensor's ``Place``: ``CUDAPlace(i)`` or ``CPUPlace()``."""
    if self.device.type == "cuda":
        return place_mod.CUDAPlace(self.device.index or 0)
    if self.device.type == "cpu":
        return place_mod.CPUPlace()
    return place_mod.Place(self.device.type, self.device.index or 0)


def _clear_grad(self) -> None:
    self.grad = None


def _set_value(self, value) -> None:
    """Copy ``value`` (a tensor or an array of this shape) into the tensor in
    place, cast to its dtype, with no gradient recorded."""
    src = value.detach() if isinstance(value, torch.Tensor) \
        else torch.as_tensor(np.asarray(value))
    if tuple(src.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {tuple(src.shape)} vs "
                         f"{tuple(self.shape)}")
    with torch.no_grad():
        self.copy_(src)


_TENSOR_ATTRS = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "place": property(_place),
    "persistable": False,
    "clear_grad": _clear_grad,
    "clear_gradient": _clear_grad,
    "set_value": _set_value,
    "pspec": None,
    "grad_pspec": None,
    "opt_state_pspec": None,
}


def attach_tensor_attributes():
    """Set the reference Tensor's attributes that ``torch.Tensor`` lacks;
    returns the names set. The settable ones (``persistable`` and the
    ``*pspec`` annotations) are class defaults an instance overrides."""
    done = []
    for name, value in _TENSOR_ATTRS.items():
        if not hasattr(torch.Tensor, name):
            setattr(torch.Tensor, name, value)
            done.append(name)
    return done


ATTACHED = attach_tensor_attributes()


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
    blocking ``.cpu()`` a tensor. A pending lazy graph is flushed first."""
    ts = [lazy.concrete(x).detach() if isinstance(x, torch.Tensor)
          else torch.as_tensor(np.asarray(x)) for x in xs]
    on_card = [t.device.type == "cuda" for t in ts]
    if any(on_card):
        ts = [t.to("cpu", non_blocking=True) if c else t
              for t, c in zip(ts, on_card)]
        torch.cuda.current_stream().synchronize()
    return [(t.float() if t.dtype == torch.bfloat16 else t).numpy()
            for t in ts]


__all__ = ["Tensor", "Parameter", "to_tensor", "host_arrays", "LazyArray",
           "lazy_timed_block"]
