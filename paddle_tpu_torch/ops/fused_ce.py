"""Fused LM-head cross-entropy (port of ``paddle_tpu/ops/fused_ce.py``).

``mean over valid rows of CE(softmax(x @ w.T), labels)`` without the
(N, V) logits tensor: a loop over row blocks computes each block's logits in
f32, reduces them to the logsumexp and the label logit, and drops them, so
the peak extra memory is ``block_rows x V`` f32. The backward recomputes each
block's logits, forms ``softmax - onehot`` and accumulates dW in f32.

The reference's body is a ``lax.scan`` of XLA matmuls, not a Pallas kernel,
so the products here are ``torch.matmul``. Its logits are bf16 x bf16 -> f32
(``preferred_element_type=f32``). ``torch.matmul`` of bf16 rounds its output
to bf16, so the operands are upcast to f32; bf16 values are exact in TF32,
so on the card those f32 products may run on the TF32 tensor cores
(``_mm``) and still equal bf16 x bf16 -> f32. An f32 model keeps full f32.
The row block resolves through the kernel registry (``fused_ce``: 2048 with
``FLAGS_kernel_autotune=off``, as the reference's).

Under tensor parallelism the tied head is the vocab-sharded embedding: each
rank holds V/mp rows of ``w`` (``group`` is the mp group). The vocab-parallel
form keeps the block loop and the products: each block's row max and sum of
exponentials are all-reduced over the group (max, then sum), the target
logit comes from the rank whose rows hold the label (a sum of one non-zero
term), and the backward's dX is summed over the group while each rank keeps
the dW of its own rows. One autograd Function holds both forms; without a
group it runs no exchange.

The mean's divisor comes from ``valid_mean.denominator``: the rank's valid
rows, or under an engine's ``mean_over`` the data x sequence group's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .kernels.builtin import fused_ce_key
from .kernels.registry import launch_config
from .valid_mean import denominator

__all__ = ["fused_linear_cross_entropy"]

_HALF = (torch.bfloat16, torch.float16)


def _mm(a, b, tf32_exact: bool):
    """a @ b in f32. ``tf32_exact``: both operands hold 16-bit values, so a
    TF32 product loses nothing and is allowed for this call only."""
    a, b = a.float(), b.float()
    if not (tf32_exact and a.is_cuda):
        return a @ b
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _valid(labels, ignore_index):
    return (labels != ignore_index) & (labels >= 0)


class _FusedLinearCE(torch.autograd.Function):
    """The block loop, forward and backward. ``denom`` is the mean's
    divisor (``valid_mean.denominator``). With ``pg`` a process group,
    ``w`` is this rank's rows ``[start, start + V)`` of the vocabulary: the
    row max, the sum of exponentials and the target logit are all-reduced
    over ``pg`` and dX is summed; with ``pg`` None no exchange runs and the
    block's log-sum-exp and softmax are computed whole."""

    @staticmethod
    def forward(ctx, x, w, labels, block_rows, ignore_index, denom, pg,
                start):
        N = x.shape[0]
        V = w.shape[0]
        exact = x.dtype in _HALF and w.dtype in _HALF
        wt = w.float().T
        valid = _valid(labels, ignore_index)
        local = labels - start
        mine = valid & (local >= 0) & (local < V)
        li = local.clamp(0, V - 1)
        lse_all = torch.empty(N, dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, N, block_rows):
            sl = slice(s, s + block_rows)
            logits = _mm(x[sl], wt, exact)
            if pg is None:
                lse = torch.logsumexp(logits, dim=-1)
                corr = logits.gather(1, li[sl, None])[:, 0]
            else:
                gmax = logits.amax(dim=-1)
                dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=pg)
                sumexp = torch.exp(logits - gmax[:, None]).sum(dim=-1)
                red = torch.stack([sumexp, torch.where(
                    mine[sl], logits.gather(1, li[sl, None])[:, 0], 0.0)])
                dist.all_reduce(red, group=pg)
                lse, corr = gmax + torch.log(red[0]), red[1]
            lse_all[sl] = lse
            nll = torch.where(valid[sl], lse - corr, 0.0)
            total = total + nll.sum()
        ctx.save_for_backward(x, w, labels, denom, lse_all)
        ctx.args = (block_rows, ignore_index, pg, start)
        return total / denom

    @staticmethod
    def backward(ctx, ct):
        x, w, labels, denom, lse_all = ctx.saved_tensors
        br, ignore_index, pg, start = ctx.args
        N = x.shape[0]
        V = w.shape[0]
        exact = x.dtype in _HALF and w.dtype in _HALF
        valid = _valid(labels, ignore_index)
        local = labels - start
        mine = valid & (local >= 0) & (local < V)
        li = local.clamp(0, V - 1)
        scale = ct.float() / denom
        wf = w.float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        for s in range(0, N, br):
            sl = slice(s, s + br)
            xs = x[sl]
            logits = _mm(xs, wf.T, exact)
            g = torch.softmax(logits, dim=-1) if pg is None \
                else torch.exp(logits - lse_all[sl, None])
            g[torch.arange(g.shape[0], device=g.device), li[sl]] -= \
                mine[sl].float()
            g *= (valid[sl].float() * scale)[:, None]
            gb = g.to(w.dtype)
            dx[sl] = _mm(gb, wf, exact)
            dw += _mm(gb.T, xs, exact)
        if pg is not None:
            dist.all_reduce(dx, group=pg)
        return (dx.to(x.dtype), dw.to(w.dtype), None, None, None, None, None,
                None)


def fused_linear_cross_entropy(x, w, labels, block_rows=None,
                               ignore_index=-100, group=None):
    """x (N, d); w (V, d), the tied LM-head weight; labels (N,) int. Rows
    whose label is ``ignore_index`` (or negative) are left out of the sum
    and of the mean's denominator. ``block_rows=None`` resolves through the
    kernel registry (``fused_ce``); an explicit value bypasses it.
    ``group``: the mp group over whose ranks ``w`` is sharded by rows
    (rank r holds rows ``r * V_r .. (r + 1) * V_r``); x is replicated over
    it and the loss is the full vocabulary's."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1] \
            or labels.shape != (x.shape[0],):
        raise ValueError(f"fused_linear_cross_entropy: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} labels{tuple(labels.shape)}")
    if block_rows is None:
        block_rows = launch_config("fused_ce", fused_ce_key, x.shape[0],
                                   x.shape[1], w.shape[0],
                                   x.dtype)["block_rows"]
    if int(block_rows) <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    pg, start = None, 0
    if group is not None and group.nranks > 1:
        from ..distributed.collective import _resolve

        pg, _ = _resolve(group, "fused_linear_cross_entropy")
        start = max(group.rank, 0) * w.shape[0]
    labels = labels.long()
    denom = denominator(_valid(labels, int(ignore_index)))
    return _FusedLinearCE.apply(x, w, labels, int(block_rows),
                                int(ignore_index), denom, pg, start)
