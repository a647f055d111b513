"""``paddle.save``/``paddle.load`` and ``atomic_open`` (port of
``paddle_tpu/framework/io.py``).

A checkpoint is a pickle of plain containers in which every tensor is the
reference's self-describing record ``{"__paddle_tpu_tensor__": 1, "dtype",
"is_param", "name", "stop_gradient", "data"}``: ``data`` a numpy array, or
for bfloat16 (which numpy lacks) the raw bytes plus ``shape``. Files written
by either package load in the other, and nothing but pickle and numpy is
needed to read one. The reference's legacy ``_TensorPayload`` pickles load
through an unpickler that maps that one class to this module's copy and
refuses every other class of ``paddle_tpu``, which is never imported.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pickle
import threading
from typing import Any

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import place as place_mod
from ..core.tensor import Parameter

__all__ = ["atomic_open", "save", "load"]

_TENSOR_KEY = "__paddle_tpu_tensor__"
_LEGACY = ("paddle_tpu.framework.io", "_TensorPayload")

_tmp_seq = itertools.count(1)  # same-process same-path writers get unique tmps


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w"):
    """Open a tmp file beside ``path``, flush and fsync it, and ``os.replace``
    it over ``path`` on a clean exit (removed on error). A reader, at any
    time or after a kill mid-write, sees the old content or the whole new
    write, never a torn file. The tmp name carries the pid, the thread id
    and a sequence number, so two threads writing one path never truncate
    each other's tmp."""
    tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}-{next(_tmp_seq)}"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


class _TensorPayload:
    """The reference's legacy pickle container, so its older checkpoints
    load (attributes ``dtype_name``, ``array`` or ``buf`` + ``shape``,
    ``is_param``, ``name``, ``stop_gradient``)."""

    def to_tensor(self, return_numpy=False, device=None):
        if self.dtype_name == "bfloat16":
            data = _bf16_from_bytes(self.buf, self.shape)
        else:
            data = self.array
        return _make_tensor(data, self.is_param, self.name,
                            self.stop_gradient, return_numpy, device)


def _bf16_from_bytes(buf, shape) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if not len(buf):
        return torch.empty(shape, dtype=torch.bfloat16)
    raw = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    return raw.view(torch.bfloat16).reshape(shape)


def _make_tensor(data, is_param, name, stop_gradient, return_numpy,
                 device=None):
    """A ``Parameter`` (with its name) or a tensor on ``device`` (default the
    current place), or a numpy array (bfloat16 as float32: exact, numpy has
    no bfloat16)."""
    if return_numpy:
        if isinstance(data, torch.Tensor):
            return data.float().numpy()
        return np.asarray(data)
    t = data if isinstance(data, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(data))
    t = t.to(place_mod.resolve_device(device))
    if is_param:
        return Parameter(t, name=name, trainable=not stop_gradient)
    if not stop_gradient and t.is_floating_point():
        t.requires_grad_(True)
    return t


def _pack(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        dtype_name = dtypes.dtype_name(t.dtype)
        rec = {
            _TENSOR_KEY: 1,
            "dtype": dtype_name,
            "is_param": isinstance(obj, Parameter),
            "name": obj.name if isinstance(obj, Parameter) else None,
            "stop_gradient": not obj.requires_grad,
        }
        if dtype_name == "bfloat16":
            rec["shape"] = tuple(t.shape)
            rec["data"] = t.contiguous().view(torch.int16).numpy().tobytes()
        else:
            rec["data"] = t.numpy()
        return rec
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return tuple(packed) if isinstance(obj, tuple) else type(obj)(packed)
    return obj


def _unpack(obj: Any, return_numpy=False, device=None) -> Any:
    if isinstance(obj, _TensorPayload):
        return obj.to_tensor(return_numpy, device)
    if isinstance(obj, dict):
        if obj.get(_TENSOR_KEY):
            if obj["dtype"] == "bfloat16":
                data = _bf16_from_bytes(obj["data"], obj["shape"])
            else:
                data = obj["data"]
            return _make_tensor(data, obj["is_param"], obj["name"],
                                obj["stop_gradient"], return_numpy, device)
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_unpack(v, return_numpy, device) for v in obj]
        return tuple(out) if isinstance(obj, tuple) else out
    return obj


class _Unpickler(pickle.Unpickler):
    """Maps the reference's legacy ``_TensorPayload`` to this module's copy
    and refuses any other class of ``paddle_tpu``."""

    def find_class(self, module, name):
        if (module, name) == _LEGACY:
            return _TensorPayload
        if module.split(".")[0] == "paddle_tpu":
            raise pickle.UnpicklingError(
                f"{module}.{name}: a checkpoint names a class of the JAX "
                "package, which paddle_tpu_torch does not import")
        return super().find_class(module, name)


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` through ``atomic_open`` (a kill mid-write
    leaves the old file). Tensors on the card are copied to the host. A
    pending lazy graph is flushed first, so a parameter whose update is
    still pending is saved updated."""
    from ..core import lazy

    lazy.flush()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with lazy.eager():
        packed = _pack(obj)
    with atomic_open(path, "wb") as f:
        pickle.dump(packed, f, protocol=protocol)


def load(path, return_numpy=False, device=None, **configs):
    """The object ``save`` wrote (by either package): tensors on ``device``
    (default the current place, ``set_device``), ``Parameter``s with their
    names and ``stop_gradient``; with ``return_numpy`` numpy arrays
    instead."""
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy=return_numpy, device=device)
