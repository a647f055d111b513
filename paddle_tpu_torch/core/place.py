"""Places and device selection (port of ``paddle_tpu/core/place.py``).

The card by default, the CPU only when asked for: ``set_device("cpu")``,
``place=CPUPlace()`` or ``device="cpu"``. Without CUDA every other request
raises; nothing falls back to the CPU quietly. ``set_device`` is
thread-local, as the reference's ``_state``.
"""
from __future__ import annotations

import threading

import torch

_NO_CUDA = ("CUDA is not available; pass device='cpu' (or call "
            "set_device('cpu')) to run on the CPU")


class Place:
    """A logical device; ``device_type`` is ``"cpu"`` or ``"gpu"``."""

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device(torch.device("cuda", self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    """``torch.device("cuda", device_id)``; raises without CUDA."""

    def __init__(self, device_id: int = 0):
        super().__init__("gpu", int(device_id))
        resolve_device(torch.device("cuda", self.device_id))


class TPUPlace(Place):
    """Kept for the reference's name; this build has no TPU."""

    def __init__(self, device_id: int = 0):
        raise ValueError("TPUPlace: this build runs on CUDA or the CPU; use "
                         "CUDAPlace or CPUPlace")


_state = threading.local()


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name == "cpu":
        return CPUPlace()
    if name in ("gpu", "cuda"):
        return CUDAPlace(idx)
    if name in ("tpu", "xla"):
        return TPUPlace(idx)
    raise ValueError(f"Unknown device {device!r}")


def set_device(device) -> Place:
    """``set_device("cpu" | "gpu" | "gpu:1" | place)`` for this thread."""
    place = _parse(device)
    _state.place = place
    return place


def current_place() -> Place:
    """``set_device``'s choice, else ``CUDAPlace`` of the current card
    (which raises without CUDA)."""
    place = getattr(_state, "place", None)
    if place is None:
        dev = resolve_device(torch.device("cuda"))
        place = CUDAPlace(dev.index)
    return place


def get_device() -> str:
    p = current_place()
    return f"{p.device_type}:{p.device_id}"


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    """This build runs on CUDA or the CPU: never a TPU."""
    return False


class CUDAPinnedPlace(CPUPlace):
    """Pinned host memory (reference ``platform/place.h``): host memory to
    the caller; pinning the staging copies is the caching host allocator's
    job (``DevicePrefetcher`` pins what it copies)."""


class _UnavailablePlace:
    """The reference's places with no hardware behind them here (IPU, MLU,
    NPU, XPU, custom): constructing one raises instead of running on
    another device."""

    def __init__(self, *a, **k):
        raise RuntimeError(
            f"{type(self).__name__} hardware is not available in this "
            "build; use CUDAPlace() or CPUPlace()")


class IPUPlace(_UnavailablePlace):
    pass


class MLUPlace(_UnavailablePlace):
    pass


class NPUPlace(_UnavailablePlace):
    pass


class XPUPlace(_UnavailablePlace):
    pass


class CustomPlace(_UnavailablePlace):
    pass


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` for ``device`` (a Place, ``"gpu:0"``, a torch
    device or string); ``None`` reads ``set_device``'s choice and defaults
    to ``cuda``. Raises when CUDA is missing and the caller did not ask for
    the CPU — never a quiet CPU fallback."""
    if device is None:
        place = getattr(_state, "place", None)
        dev = torch.device("cuda") if place is None else place.torch_device()
    elif isinstance(device, Place):
        dev = device.torch_device()
    elif isinstance(device, str) and device.split(":")[0] == "gpu":
        dev = _parse(device).torch_device()
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # an explicit index: torch.cuda.set_device needs one in other threads
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "CUDAPinnedPlace",
           "IPUPlace", "MLUPlace", "NPUPlace", "XPUPlace", "CustomPlace",
           "set_device", "get_device", "current_place",
           "is_compiled_with_cuda", "is_compiled_with_tpu",
           "resolve_device"]
