"""``paddle.fft`` (port of ``paddle_tpu/fft.py``) over ``torch.fft``.

A bfloat16 or float16 input is computed in float32, as ``jnp.fft`` promotes
it (cuFFT has no bfloat16): a real half input gives complex64 (the
reference's real transforms refuse bfloat16; the port takes it). The n-d
transforms keep the reference's signature, whose ``axes`` default to the
last two axes for ``fftn``/``ifftn``/``rfftn``/``irfftn`` too.
"""
from __future__ import annotations

import torch

from .core.dtype import convert_dtype
from .core.place import resolve_device
from .ops.creation import _as

_HALF = (torch.bfloat16, torch.float16)


def _in(x):
    x = _as(x)
    return x.float() if x.dtype in _HALF else x


def _out(t):
    """A result without torch's lazy conjugate bit."""
    return t.resolve_conj() if t.is_conj() else t


def _mk(name, fn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return _out(fn(_in(x), n=n, dim=axis, norm=norm))

    op.__name__ = name
    op.__doc__ = f"paddle.fft.{name} (torch.fft.{name})."
    return op


def _mk2(name, fn):
    def op(x, s=None, axes=(-2, -1), norm="backward", name=None):
        return _out(fn(_in(x), s=s, dim=tuple(axes), norm=norm))

    op.__name__ = name
    op.__doc__ = f"paddle.fft.{name} (torch.fft.{name})."
    return op


fft = _mk("fft", torch.fft.fft)
ifft = _mk("ifft", torch.fft.ifft)
rfft = _mk("rfft", torch.fft.rfft)
irfft = _mk("irfft", torch.fft.irfft)
hfft = _mk("hfft", torch.fft.hfft)
ihfft = _mk("ihfft", torch.fft.ihfft)
fft2 = _mk2("fft2", torch.fft.fft2)
ifft2 = _mk2("ifft2", torch.fft.ifft2)
rfft2 = _mk2("rfft2", torch.fft.rfft2)
irfft2 = _mk2("irfft2", torch.fft.irfft2)
fftn = _mk2("fftn", torch.fft.fftn)
ifftn = _mk2("ifftn", torch.fft.ifftn)
rfftn = _mk2("rfftn", torch.fft.rfftn)
irfftn = _mk2("irfftn", torch.fft.irfftn)


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(_as(x), dim=axes)


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(_as(x), dim=axes)


def fftfreq(n, d=1.0, dtype=None, name=None):
    """Sample frequencies, float64 unless ``dtype`` is given (the
    reference's, under x64)."""
    return torch.fft.fftfreq(int(n), d=float(d), device=resolve_device(),
                             dtype=convert_dtype(dtype) or torch.float64)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return torch.fft.rfftfreq(int(n), d=float(d), device=resolve_device(),
                              dtype=convert_dtype(dtype) or torch.float64)


__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "fftn", "ifftn", "rfftn", "irfftn",
    "fftshift", "ifftshift", "fftfreq", "rfftfreq",
]
