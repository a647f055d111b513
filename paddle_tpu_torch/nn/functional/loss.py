"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``): hard-label
``cross_entropy`` and the fused LM-head cross-entropy."""
from __future__ import annotations

import torch

from ...ops.fused_ce import fused_linear_cross_entropy as _fce


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross-entropy over the last axis with integer labels. Rows
    labelled ``ignore_index`` count 0 and leave the mean's denominator."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got {reduction!r}")
    logp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1).to(loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss


def fused_linear_cross_entropy(x, weight, label, block_rows=2048,
                               ignore_index=-100):
    """LM-head projection + softmax cross-entropy without the (N, vocab)
    logits tensor (``ops/fused_ce.py``). x (..., d); weight (V, d); label
    int (...). Returns the mean loss over non-ignored rows."""
    d = x.shape[-1]
    return _fce(x.reshape(-1, d), weight, label.reshape(-1), block_rows,
                ignore_index)


__all__ = ["cross_entropy", "fused_linear_cross_entropy"]
