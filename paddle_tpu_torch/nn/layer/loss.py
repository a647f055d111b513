"""Loss layers (port of ``paddle_tpu/nn/layer/loss.py``): each stores its
arguments and calls its functional."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Loss(Layer):
    def __init__(self, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)


class CrossEntropyLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None, **kw):
        super().__init__(**kw)
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label = reduction, soft_label
        self.axis, self.use_softmax = axis, use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self.weight, ignore_index=self.ignore_index,
            reduction=self.reduction, soft_label=self.soft_label,
            axis=self.axis, use_softmax=self.use_softmax,
            label_smoothing=self.label_smoothing)


class MSELoss(_Loss):
    def __init__(self, reduction="mean", **kw):
        super().__init__(**kw)
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Loss):
    def __init__(self, reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None, **kw):
        super().__init__(**kw)
        self.weight, self.ignore_index, self.reduction = weight, \
            ignore_index, reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None, **kw):
        super().__init__(**kw)
        self.weight, self.reduction, self.pos_weight = weight, reduction, \
            pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction="mean", delta=1.0, name=None, **kw):
        super().__init__(**kw)
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class KLDivLoss(_Loss):
    def __init__(self, reduction="mean", **kw):
        super().__init__(**kw)
        self.reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self.reduction)


class MarginRankingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(_Loss):
    def __init__(self, margin=1.0, reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(_Loss):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-06, swap=False,
                 reduction="mean", name=None, **kw):
        super().__init__(**kw)
        self.args = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        return F.triplet_margin_loss(input, positive, negative, *self.args)


class CTCLoss(_Loss):
    def __init__(self, blank=0, reduction="mean", **kw):
        super().__init__(**kw)
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "SmoothL1Loss", "KLDivLoss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss", "TripletMarginLoss",
    "CTCLoss",
]
