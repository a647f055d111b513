"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``): hard-label
``cross_entropy`` and the fused LM-head cross-entropy."""
from __future__ import annotations

import torch

from ...core.dispatch import amp_cast
from ...ops.fused_ce import fused_linear_cross_entropy as _fce
from ...ops.valid_mean import denominator


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Softmax cross-entropy over the last axis with integer labels. Rows
    labelled ``ignore_index`` count 0 and leave the mean's denominator
    (``ops/valid_mean.py``: global over the ranks inside an engine's
    step)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got {reduction!r}")
    input, = amp_cast("cross_entropy", (input,))
    logp = torch.log_softmax(input, dim=-1)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    loss = torch.where(valid, -picked, 0.0)
    if reduction == "mean":
        return loss.sum() / denominator(valid, loss.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss


def fused_linear_cross_entropy(x, weight, label, block_rows=None,
                               ignore_index=-100, group=None):
    """LM-head projection + softmax cross-entropy without the (N, vocab)
    logits tensor (``ops/fused_ce.py``). x (..., d); weight (V, d); label
    int (...). Returns the mean loss over non-ignored rows.
    ``block_rows=None`` resolves the row block through the kernel registry
    (2048 with autotune off). ``group``: the mp group whose ranks hold the
    weight's rows (the vocab-parallel form)."""
    d = x.shape[-1]
    return _fce(x.reshape(-1, d), weight, label.reshape(-1), block_rows,
                ignore_index, group)


__all__ = ["cross_entropy", "fused_linear_cross_entropy"]
