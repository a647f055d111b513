"""DLPack interop (port of ``paddle_tpu/utils/dlpack.py``; reference
``python/paddle/utils/dlpack.py`` over ``framework/dlpack_tensor.cc``).

Zero-copy both ways, on the card and on the host: ``to_dlpack`` hands out
an object that speaks the DLPack protocol (``__dlpack__`` and
``__dlpack_device__``), so ``torch.from_dlpack``, ``np.from_dlpack`` and
``jnp.from_dlpack`` all take it (a bare PyCapsule serves only the first),
and ``from_dlpack`` returns a tensor over the producer's memory.
"""
from __future__ import annotations

import torch


class _DLPackView:
    """A tensor's DLPack export: the tensor detached from autograd (the
    protocol refuses a tensor that needs a gradient), same memory."""

    __slots__ = ("_t",)

    def __init__(self, t: torch.Tensor):
        self._t = t.detach()

    def __dlpack__(self, *args, **kwargs):
        return self._t.__dlpack__(*args, **kwargs)

    def __dlpack_device__(self):
        return self._t.__dlpack_device__()


def to_dlpack(x):
    """Tensor -> an object implementing the DLPack protocol, over the
    tensor's own memory."""
    if not isinstance(x, torch.Tensor):
        from ..core.tensor import to_tensor

        x = to_tensor(x)
    return _DLPackView(x)


def from_dlpack(dlpack):
    """A DLPack capsule or protocol object -> a tensor over the same memory
    that needs no gradient."""
    return torch.from_dlpack(dlpack).detach()


__all__ = ["to_dlpack", "from_dlpack"]
