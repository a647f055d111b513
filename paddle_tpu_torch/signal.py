"""``paddle.signal`` (port of ``paddle_tpu/signal.py``): ``frame``,
``overlap_add``, ``stft`` and ``istft``, built as the reference builds
them: framing is a gather, the transform ``paddle_tpu_torch.fft``'s, and
overlap-add an ``index_add`` onto the output line. ``stft`` pads by
``n_fft // 2`` at both ends when ``center`` (``pad_mode`` ``reflect``,
``constant`` or ``edge``), windows each frame (a window shorter than
``n_fft`` centred in it) and gives ``(..., freq, frames)``; ``istft``
divides by the summed squared window.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fft as _fft
from .ops.creation import _as
from .ops.manipulation import _pad_index

_MODES = {"reflect": "reflect", "edge": "replicate", "wrap": "circular"}


def _frame_index(n, frame_length, hop_length, device):
    num = 1 + (n - frame_length) // hop_length
    return (torch.arange(num, device=device)[:, None] * hop_length
            + torch.arange(frame_length, device=device)[None, :])


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames along ``axis``: ``axis=-1`` gives ``(...,
    frame_length, num_frames)``, ``axis=0`` ``(num_frames, frame_length,
    ...)``."""
    a = _as(x)
    axis = int(axis)
    last = axis in (-1, a.dim() - 1)
    if not last:
        a = a.movedim(axis, -1)
    idx = _frame_index(a.shape[-1], int(frame_length), int(hop_length),
                       a.device)
    out = a[..., idx].movedim(-2, -1)  # (..., frame_length, num)
    if not last:
        out = out.movedim((-2, -1), (axis + 1, axis))
    return out


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of ``frame``: frames summed where they overlap."""
    a = _as(x)
    axis = int(axis)
    last = axis in (-1, a.dim() - 1)
    if not last:
        a = a.movedim((axis, axis + 1), (-1, -2))
    fl, num = a.shape[-2], a.shape[-1]
    hop = int(hop_length)
    n = (num - 1) * hop + fl
    vals = a.movedim(-1, -2).reshape(tuple(a.shape[:-2]) + (-1,))
    idx = _frame_index(n, fl, hop, a.device).reshape(-1)
    out = torch.zeros(tuple(a.shape[:-2]) + (n,), dtype=a.dtype,
                      device=a.device).index_add(-1, idx, vals)
    return out if last else out.movedim(-1, axis)


def _window(w, win_length, n_fft):
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = F.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    a = _as(x)
    hop = int(hop_length or n_fft // 4)
    win_length = int(win_length or n_fft)
    if center:
        p = n_fft // 2
        if pad_mode == "constant":
            a = F.pad(a, (p, p))
        else:
            a = a.index_select(-1, _pad_index(a.shape[-1], p, p,
                                              _MODES[pad_mode], a.device))
    frames = a[..., _frame_index(a.shape[-1], n_fft, hop, a.device)]
    if window is not None:
        frames = frames * _window(_as(window), win_length, n_fft)
    spec = _fft.rfft(frames) if onesided else _fft.fft(frames)
    if normalized:
        spec = spec / n_fft ** 0.5
    return spec.transpose(-1, -2)  # (..., freq, num_frames)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    spec = _as(x).transpose(-1, -2)  # (..., num, freq)
    hop = int(hop_length or n_fft // 4)
    win_length = int(win_length or n_fft)
    if normalized:
        spec = spec * n_fft ** 0.5
    frames = _fft.irfft(spec, n=n_fft) if onesided \
        else _fft.ifft(spec).real
    if window is not None:
        win = _window(_as(window), win_length, n_fft).to(frames.dtype)
    else:
        win = torch.ones((n_fft,), dtype=frames.dtype, device=frames.device)
    frames = frames * win
    num = frames.shape[-2]
    n = (num - 1) * hop + n_fft
    idx = _frame_index(n, n_fft, hop, frames.device).reshape(-1)
    lead = tuple(frames.shape[:-2])
    out = torch.zeros(lead + (n,), dtype=frames.dtype,
                      device=frames.device).index_add(
        -1, idx, frames.reshape(lead + (-1,)))
    env = torch.zeros((n,), dtype=frames.dtype, device=frames.device)
    env = env.index_add(0, idx, (win * win).repeat(num))
    out = out / torch.clamp(env, min=1e-11)
    if center:
        out = out[..., n_fft // 2: n - n_fft // 2]
    if length:
        out = out[..., :int(length)]
    return out


__all__ = ["frame", "overlap_add", "stft", "istft"]
