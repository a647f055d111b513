"""``paddle.device`` (port of ``paddle_tpu/device/__init__.py``).

Devices are named as the reference names them, ``"<platform>:<id>"``, with
``gpu`` for a CUDA card and ``cpu`` for the host. ``synchronize`` waits for
the card: the reference's ``cuda.synchronize`` is a no-op because it has no
CUDA, and a no-op here would hide the device's queue.
"""
from __future__ import annotations

import torch

from ..core.place import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, TPUPlace, current_place, get_device,
    is_compiled_with_cuda, is_compiled_with_tpu, resolve_device, set_device,
)


def _devices():
    """The default platform's devices, as ``jax.devices()`` lists the
    default backend's: the cards, or the host when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [("gpu", i) for i in range(n)] or [("cpu", 0)]


def device_count(device_type=None):
    """How many devices of ``device_type`` (``"gpu"`` or ``"cpu"``; every
    device when None)."""
    devs = _devices()
    if device_type:
        devs = [d for d in devs if d[0] == device_type]
    return len(devs)


def get_all_device_type():
    return sorted({p for p, _ in _devices()})


def get_available_device():
    return [f"{p}:{i}" for p, i in _devices()]


class cuda:  # namespace parity: paddle.device.cuda
    @staticmethod
    def device_count():
        return torch.cuda.device_count()

    @staticmethod
    def synchronize(device=None):
        torch.cuda.synchronize(None if device is None
                               else resolve_device(device))


def synchronize(device=None):
    """Block until the card's queued work is done (``torch.cuda.synchronize``
    of ``device``, else of the current card); raises without CUDA, as
    every entry point does."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


__all__ = ["device_count", "get_all_device_type", "get_available_device",
           "cuda", "synchronize", "set_device", "get_device", "Place",
           "CPUPlace", "CUDAPlace", "TPUPlace", "is_compiled_with_cuda",
           "is_compiled_with_tpu"]
