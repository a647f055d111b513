"""Loss functionals (port of ``paddle_tpu/nn/functional/loss.py``), each the
reference's formula, with its quirks:

- ``cross_entropy``'s hard-label ``mean`` divides by the count of rows not
  labelled ``ignore_index`` (``ops/valid_mean.py``: global over the ranks
  inside an engine's step), or with ``weight`` by the sum of the picked
  weights; a soft label's ``mean`` is the plain mean;
- ``ctc_loss`` applies ``log_softmax`` to its input (as warpctc does), runs
  the alpha recursion with -1e30 for an impossible state (so an infeasible
  alignment costs about 1e30, not inf), reads the end as
  ``logaddexp(alpha[2L], alpha[2L - 1])`` with the index clamped at 0 (a
  label length of 0 adds log 2), and its ``mean`` is the plain batch mean;
  ``norm_by_times`` is not used;
- ``hsigmoid_loss`` takes the default complete tree only;
- ``margin_cross_entropy`` clamps cos theta to +-(1 - 1e-7); its ``group``
  is the mp group over whose ranks the class axis is split.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dispatch import amp_cast
from ...ops.fused_ce import fused_linear_cross_entropy as _fce
from ...ops.valid_mean import denominator


def _reduce(val, reduction):
    if reduction == "mean":
        return val.mean()
    if reduction == "sum":
        return val.sum()
    return val


def _softplus_neg_abs(x):
    """``log(1 + exp(-|x|))``."""
    return torch.log1p(torch.exp(-x.abs()))


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy along ``axis`` with the reference's signature:
    integer labels (a trailing axis of 1 is squeezed; ``ignore_index`` rows
    count 0) or, with ``soft_label``, a distribution; ``weight`` per class;
    ``use_softmax=False`` takes probabilities; ``label_smoothing`` mixes in
    the uniform distribution."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean|sum|none, got {reduction!r}")
    soft_in = label if soft_label else None
    input, soft_in, weight = amp_cast("cross_entropy",
                                      (input, soft_in, weight))
    if use_softmax:
        logp = torch.log_softmax(input, axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    n_classes = input.shape[axis]
    if soft_label:
        soft = soft_in
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / n_classes
        return _reduce(-(soft * logp).sum(axis), reduction)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    picked = logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        loss = -(1 - label_smoothing) * picked + \
            label_smoothing * -logp.mean(axis)
    else:
        loss = -picked
    if weight is not None:
        w = weight[safe]
        loss = loss * w
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            return loss.sum() / torch.where(valid, w, torch.zeros_like(w)).sum()
        return loss.sum() / denominator(valid, loss.dtype)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced cross-entropy with ``axis`` kept (size 1), and the
    softmax when ``return_softmax``."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n], ...]`` (classes on axis 1), weighted; the mean
    divides by the valid rows' weight sum."""
    input, weight = amp_cast("nll_loss", (input, weight))
    lab = label.long()
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0)
    loss = -input.gather(1, safe.unsqueeze(1)).squeeze(1)
    wts = weight[safe] if weight is not None else torch.ones_like(loss)
    zero = torch.zeros_like(loss)
    loss = torch.where(valid, loss * wts, zero)
    if reduction == "mean":
        return loss.sum() / torch.clamp(torch.where(valid, wts, zero).sum(),
                                        min=1e-12)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast("mse_loss", (input, label))
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast("l1_loss", (input, label))
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    input, label = amp_cast("smooth_l1_loss", (input, label))
    diff = (input - label).abs()
    loss = torch.where(diff < delta, 0.5 * diff * diff / delta,
                       diff - 0.5 * delta)
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """On probabilities clipped to [1e-12, 1 - 1e-12]."""
    input, label, weight = amp_cast("bce", (input, label, weight))
    p = torch.clamp(input, 1e-12, 1.0 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable form ``max(x, 0) - x * y + log(1 + exp(-|x|))``;
    ``pos_weight`` weighs the positive term."""
    logit, label, weight, pos_weight = amp_cast(
        "bce_with_logits", (logit, label, weight, pos_weight))
    x, y = logit, label
    if pos_weight is not None:
        log_weight = (pos_weight - 1) * y + 1
        loss = (1 - y) * x + log_weight * (_softplus_neg_abs(x)
                                           + torch.clamp(-x, min=0.0))
    else:
        loss = torch.clamp(x, min=0) - x * y + _softplus_neg_abs(x)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)`` (``input`` is log-probabilities);
    ``batchmean`` divides the sum by the batch size."""
    input, label = amp_cast("kl_div", (input, label))
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    input, other, label = amp_cast("margin_ranking_loss",
                                   (input, other, label))
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    input, label = amp_cast("hinge_embedding_loss", (input, label))
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    input1, input2 = amp_cast("cosine_embedding_loss", (input1, input2))
    cos = (input1 * input2).sum(-1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    input, positive, negative = amp_cast("triplet_margin_loss",
                                         (input, positive, negative))

    def dist(a, b):
        return torch.linalg.vector_norm(a - b + epsilon, ord=p, dim=-1)

    d_pos, d_neg = dist(input, positive), dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def log_loss(input, label, epsilon=0.0001, name=None):
    input, label = amp_cast("log_loss", (input, label))
    return -label * torch.log(input + epsilon) - \
        (1 - label) * torch.log(1 - input + epsilon)


def square_error_cost(input, label):
    input, label = amp_cast("square_error_cost", (input, label))
    return torch.square(input - label)


class _LogAddExp(torch.autograd.Function):
    """``logaddexp`` whose gradients are ``exp(x - out)``, as JAX's: two
    equal impossible (-1e30) states pass a gradient of 1 each, where
    torch's rule gives 1/2."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC over (T, N, C) logits and (N, S) padded labels, as the reference
    computes it (see the module docstring)."""
    log_probs, = amp_cast("ctc_loss", (log_probs,))
    logp = torch.log_softmax(log_probs, -1)
    T, N, _ = logp.shape
    S = labels.shape[1]
    dev = logp.device
    ext = torch.full((N, 2 * S + 1), int(blank), dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    neg = torch.full((), -1e30, dtype=logp.dtype, device=dev)
    same2 = torch.cat([torch.ones(N, 2, dtype=torch.bool, device=dev),
                       ext[:, 2:] == ext[:, :-2]], 1)
    emit = logp.gather(2, ext.unsqueeze(0).expand(T, -1, -1))  # (T, N, 2S+1)
    alpha = torch.full_like(emit[0], -1e30)
    alpha = torch.cat([emit[0, :, :2], alpha[:, 2:]], 1)
    alphas = [alpha]
    lae = _LogAddExp.apply
    pad1 = neg.expand(N, 1)
    pad2 = neg.expand(N, 2)
    for t in range(1, T):
        s1 = torch.cat([pad1, alpha[:, :-1]], 1)
        s2 = torch.where(same2, neg, torch.cat([pad2, alpha[:, :-2]], 1))
        alpha = lae(lae(alpha, s1), s2) + emit[t]
        alphas.append(alpha)
    alphas = torch.stack(alphas)  # (T, N, 2S+1)
    t_last = (input_lengths.long().to(dev) - 1).reshape(1, N, 1)
    final = alphas.gather(0, t_last.expand(1, N, 2 * S + 1))[0]
    last = (2 * label_lengths.long().to(dev)).reshape(N, 1)
    p_last = final.gather(1, last)[:, 0]
    p_prev = final.gather(1, torch.clamp(last - 1, min=0))[:, 0]
    return _reduce(-lae(p_last, p_prev), reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    logit, label, normalizer = amp_cast("sigmoid_focal_loss",
                                        (logit, label, normalizer))
    x, y = logit, label
    p = torch.sigmoid(x)
    ce = torch.clamp(x, min=0) - x * y + _softplus_neg_abs(x)
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid over the default complete binary tree: each
    sample's (N, 1) loss sums a binary cross-entropy per node on its
    class's path. Custom trees (``path_table``/``path_code``) raise
    ``NotImplementedError``, as in the reference."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError("custom-tree hsigmoid: pass num_classes tree")
    input, weight, bias = amp_cast("hsigmoid_loss", (input, weight, bias))
    depth = int(np.ceil(np.log2(max(num_classes, 2))))
    lab = label.reshape(-1).long() + int(num_classes)
    ks = torch.arange(depth, device=input.device)
    nodes = (lab[:, None] >> (ks + 1)[None, :]) - 1
    codes = ((lab[:, None] >> ks[None, :]) & 1).to(input.dtype)
    valid = nodes >= 0
    nodes = torch.clamp(nodes, 0, weight.shape[0] - 1)
    logits = torch.einsum("bd,bkd->bk", input, weight[nodes])
    if bias is not None:
        logits = logits + bias.reshape(-1)[nodes]
    losses = torch.clamp(logits, min=0) - logits * codes + \
        torch.log1p(torch.exp(-logits.abs()))
    return (losses * valid).sum(-1, keepdim=True)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace/CosFace: the target class's cosine becomes
    ``cos(m1 * theta + m2) - m3``, all are scaled by ``scale``, then
    softmax cross-entropy. With an mp ``group`` of more than one rank,
    ``logits`` is this rank's contiguous shard of the class axis and the
    softmax runs over every rank's (the softmax returned is this rank's
    shard)."""
    from ...distributed.collective import _c_softmax_with_cross_entropy, _mp

    logits, = amp_cast("margin_cross_entropy", (logits,))
    lab = label.reshape(-1).long()
    m = _mp(group, "margin_cross_entropy")
    shard = logits.shape[-1]
    local = lab - (m[2] * shard if m is not None else 0)
    in_range = (local >= 0) & (local < shard)
    onehot = torch.zeros_like(logits).scatter(
        -1, local.clamp(0, shard - 1).unsqueeze(-1),
        in_range.unsqueeze(-1).to(logits.dtype))
    theta = torch.arccos(torch.clamp(logits, -1 + 1e-7, 1 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    adj = torch.where(onehot > 0, target, logits) * scale
    if m is None:
        loss = -(onehot * torch.log_softmax(adj, -1)).sum(-1)
        soft = torch.softmax(adj, -1)
    else:
        import torch.distributed as dist

        loss = _c_softmax_with_cross_entropy(adj, lab, group)
        with torch.no_grad():
            gmax = adj.amax(-1, keepdim=True)
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=m[0])
            ex = torch.exp(adj - gmax)
            gsum = ex.sum(-1, keepdim=True)
            dist.all_reduce(gsum, group=m[0])
            soft = ex / gsum
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    return (loss, soft) if return_softmax else loss


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


__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "nll_loss", "mse_loss",
    "l1_loss", "smooth_l1_loss", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "log_loss", "square_error_cost", "ctc_loss", "sigmoid_focal_loss",
    "hsigmoid_loss", "margin_cross_entropy", "fused_linear_cross_entropy",
]
