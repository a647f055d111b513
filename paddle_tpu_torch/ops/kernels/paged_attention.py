"""Paged-attention decode read (port of ``paddle_tpu/ops/kernels/
paged_attention.py`` ``paged_attention_rows``).

One decode step's attention for B rows, each with one fresh query token,
read through the row's block table straight out of ONE layer's KV pool.
The kernel is ``csrc/paged_attention.cu`` (CUDA C++, sm_90a); its plain
PyTorch version ``paged_attention_rows_plain`` is the reference's gather
path (``kpool[tables]`` then ``_grouped_attention``).

Contract, as the reference's: the caller scatters the step's fresh K/V into
the pool BEFORE this read. Dead table columns point at the trash block and
padding rows carry ``pos = 0``; only positions ``<= pos`` count.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (and counts the launch in ``launches``) or raises.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _build

__all__ = ["paged_attention_rows", "paged_attention_rows_plain", "launches"]

launches = 0  # kernel launches since the last reset (plain calls excluded)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {"pt_paged_attention": (
    (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P), _I)}


def paged_attention_rows_plain(q, kpool, vpool, tables, pos):
    """The gather path: each row's context gathered dense from its block
    table, then grouped attention over positions ``<= pos``."""
    from ...models.generation import _grouped_attention

    B, H, D = q.shape
    _, BS, KV, _ = kpool.shape
    T_pad = tables.shape[1] * BS
    tables = tables.long()
    kc = kpool[tables].reshape(B, T_pad, KV, D)
    vc = vpool[tables].reshape(B, T_pad, KV, D)
    live = (torch.arange(T_pad, device=q.device)[None, :]
            <= pos.long()[:, None])
    o = _grouped_attention(q[:, None], kc, vc, live[:, None, None, None, :],
                           H // KV)
    return o.reshape(B, H * D)


@lru_cache(maxsize=None)
def _scale(D: int, dtype: torch.dtype) -> float:
    # the reference's q-dtype scalar 1/sqrt(D), handed to the kernel in f32
    return float(torch.tensor(1.0 / np.sqrt(D), dtype=dtype))


def paged_attention_rows(q, kpool, vpool, tables, pos):
    """q (B, H, D); kpool/vpool (NB, BS, KV, D) for one layer; tables (B, MB)
    int32; pos (B,) int32 → (B, H*D) in q's dtype."""
    if q.device.type == "cpu":
        return paged_attention_rows_plain(q, kpool, vpool, tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_rows: unsupported device {q.device}")
    B, H, D = q.shape
    NB, BS, KV, Dk = kpool.shape
    MB = tables.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attention_rows: dtype {q.dtype} not supported")
    for name, t in (("kpool", kpool), ("vpool", vpool), ("tables", tables),
                    ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"paged_attention_rows: {name} on {t.device}, "
                             f"q on {q.device}")
    if kpool.dtype != q.dtype or vpool.dtype != q.dtype:
        raise TypeError("paged_attention_rows: pools must have q's dtype")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention_rows: tables and pos must be int32")
    if Dk != D or vpool.shape != kpool.shape or H % KV \
            or tables.shape != (B, MB) or pos.shape != (B,):
        raise ValueError(
            f"paged_attention_rows: shapes q{tuple(q.shape)} "
            f"kpool{tuple(kpool.shape)} vpool{tuple(vpool.shape)} "
            f"tables{tuple(tables.shape)} pos{tuple(pos.shape)}")
    rep = H // KV
    if D > 256 or D % 8 or rep > 8 or rep * D > 1024:
        raise ValueError(
            f"paged_attention_rows: kernel takes D <= 256 with D % 8 == 0, "
            f"rep <= 8 and rep*D <= 1024 (got D={D}, rep={rep})")
    if not all(t.is_contiguous() for t in (q, kpool, vpool, tables, pos)):
        raise ValueError("paged_attention_rows: inputs must be contiguous")
    out = torch.empty((B, H * D), dtype=q.dtype, device=q.device)
    lib = _build.load("paged_attention", _SIGS)
    with torch.cuda.device(q.device):
        rc = lib.pt_paged_attention(
            _DTYPES[q.dtype], q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), B, KV, rep, D,
            BS, MB, _scale(D, q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, lib, "paged_attention_rows")
    global launches
    launches += 1
    return out
