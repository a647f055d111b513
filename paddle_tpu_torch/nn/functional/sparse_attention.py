"""CSR-masked attention (port of
``paddle_tpu/nn/functional/sparse_attention.py``): dense scores with every
position off the per-row CSR pattern filled with -1e30, then softmax."""
from __future__ import annotations

import math

import torch

from ...core.dispatch import amp_cast


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, name=None):
    """q, k, v (B, H, T, D); ``sparse_csr_offset`` (B, H, T + 1) and
    ``sparse_csr_columns`` (B, H, nnz) give, per (batch, head), the key
    columns each query row attends to."""
    query, key, value = amp_cast("sparse_attention", (query, key, value))
    B, H, T, D = query.shape
    scores = torch.einsum("bhqd,bhkd->bhqk", query, key) * (1.0 / math.sqrt(D))
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    nnz = cols.shape[-1]
    pos = torch.arange(nnz, device=cols.device).expand(B, H, nnz).contiguous()
    rows = torch.searchsorted(off[..., 1:].contiguous(), pos, right=True)
    rows = rows.clamp(max=T - 1)
    mask = torch.zeros(B, H, T * T, dtype=torch.bool, device=cols.device)
    mask = mask.scatter(2, rows * T + cols, True).reshape(B, H, T, T)
    scores = torch.where(mask, scores,
                         torch.full((), -1e30, dtype=scores.dtype,
                                    device=scores.device))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), value)


__all__ = ["sparse_attention"]
