"""One-batch metric ops (port of ``paddle_tpu/ops/metrics_ops.py``): pure
functions over a batch, no state.

``edit_distance`` computes the Levenshtein table a row at a time for the
whole batch at once: row i + 1 takes deletions and substitutions from row
i, and the chain of insertions along the row is ``j + cummin(v[k] - k)``
(``torch.cummin``), so a batch costs ``Th`` steps of a few batched ops,
not ``B * Th * Tr`` scalar updates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .creation import _as

__all__ = ["auc", "edit_distance", "mean_iou", "precision_recall",
           "positive_negative_pair"]


def auc(pred, label, name=None):
    """ROC-AUC of the scores ``pred`` (N,) against {0, 1} ``label`` by the
    rank statistic, ties at half weight; 0.5 when a class is empty."""
    p = _as(pred).reshape(-1).float()
    y = _as(label).reshape(-1)
    sp = torch.sort(p).values
    less = torch.searchsorted(sp, p).float()
    leq = torch.searchsorted(sp, p, right=True).float()
    ranks = (less + leq + 1.0) / 2.0
    pos = (y > 0).float()
    npos = pos.sum()
    nneg = p.numel() - npos
    s = (ranks * pos).sum() - npos * (npos + 1) / 2.0
    return torch.where(npos * nneg > 0,
                       s / torch.clamp(npos * nneg, min=1.0),
                       torch.full_like(s, 0.5))


def edit_distance(hyp, hyp_length, ref, ref_length, normalized=True,
                  name=None):
    """Levenshtein distance of each padded id row ``hyp`` (B, Th) to ``ref``
    (B, Tr), over their first ``hyp_length``/``ref_length`` entries, as
    float32; divided by the reference length (at least 1) when
    ``normalized``."""
    h, hl = _as(hyp), _as(hyp_length).reshape(-1)
    r, rl = _as(ref), _as(ref_length).reshape(-1)
    b, th = h.shape
    tr = r.shape[1]
    dev = h.device
    cols = torch.arange(tr + 1, device=dev, dtype=torch.float32)
    row = cols.expand(b, tr + 1)
    for i in range(th):
        cost = (h[:, i:i + 1] != r).float()               # (B, Tr)
        dele = row[:, 1:] + 1.0
        sub = row[:, :-1] + cost
        c = torch.cat([row[:, :1] + 1.0, torch.minimum(dele, sub)], 1)
        new = cols + torch.cummin(c - cols, 1).values     # insertions
        row = torch.where((i < hl)[:, None], new, row)
    d = torch.gather(row, 1, torch.clamp(rl, 0, tr)[:, None].long())[:, 0]
    if normalized:
        d = d / torch.clamp(rl, min=1).float()
    return d


def _one_hots(pred, label, num_classes):
    p = F.one_hot(_as(pred).reshape(-1).long(), num_classes).float()
    y = F.one_hot(_as(label).reshape(-1).long(), num_classes).float()
    return p, y


def mean_iou(pred, label, num_classes, name=None):
    """The mean over the classes present in ``pred`` or ``label`` of their
    intersection over union."""
    p, y = _one_hots(pred, label, int(num_classes))
    inter = (p * y).sum(0)
    union = p.sum(0) + y.sum(0) - inter
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0), 0.0)
    return iou.sum() / torch.clamp(present.sum(), min=1)


def precision_recall(pred, label, num_classes, name=None):
    """Macro ``(precision, recall, f1)`` over the classes present in
    ``label``."""
    p, y = _one_hots(pred, label, int(num_classes))
    tp = (p * y).sum(0)
    fp = p.sum(0) - tp
    fn = y.sum(0) - tp
    present = y.sum(0) > 0
    prec = torch.where(present, tp / torch.clamp(tp + fp, min=1.0), 0.0)
    rec = torch.where(present, tp / torch.clamp(tp + fn, min=1.0), 0.0)
    npres = torch.clamp(present.sum(), min=1)
    mp, mr = prec.sum() / npres, rec.sum() / npres
    f1 = torch.where(mp + mr > 0,
                     2 * mp * mr / torch.clamp(mp + mr, min=1e-12), 0.0)
    return mp, mr, f1


def positive_negative_pair(score, label, query_id, name=None):
    """``(positive, negative, neutral)`` pair counts (int64) within each
    query: pairs of unequal labels whose scores are ordered as their labels,
    the other way, or tied."""
    s = _as(score).reshape(-1).float()
    y = _as(label).reshape(-1).float()
    q = _as(query_id).reshape(-1)
    n = s.numel()
    same_q = q[:, None] == q[None, :]
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                  device=s.device), 1)
    pair = same_q & upper & (y[:, None] != y[None, :])
    better = y[:, None] > y[None, :]
    s_diff = s[:, None] - s[None, :]
    want = torch.where(better, 1.0, -1.0)
    pos = (pair & (torch.sign(s_diff) == want)).sum()
    neu = (pair & (s_diff == 0)).sum()
    neg = pair.sum() - pos - neu
    return pos, neg, neu
