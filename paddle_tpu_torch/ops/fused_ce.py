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
"""
from __future__ import annotations

import torch

from .kernels.builtin import fused_ce_key
from .kernels.registry import launch_config

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

    @staticmethod
    def forward(ctx, x, w, labels, block_rows, ignore_index):
        N = x.shape[0]
        V = w.shape[0]
        exact = x.dtype in _HALF and w.dtype in _HALF
        wt = w.float().T
        valid = _valid(labels, ignore_index)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(0, N, block_rows):
            logits = _mm(x[s:s + block_rows], wt, exact)
            lse = torch.logsumexp(logits, dim=-1)
            li = labels[s:s + block_rows].clamp(0, V - 1)
            corr = logits.gather(1, li[:, None])[:, 0]
            nll = torch.where(valid[s:s + block_rows], lse - corr, 0.0)
            total = total + nll.sum()
        ctx.save_for_backward(x, w, labels)
        ctx.block_rows, ctx.ignore_index = block_rows, ignore_index
        return total / valid.sum().clamp_min(1).float()

    @staticmethod
    def backward(ctx, ct):
        x, w, labels = ctx.saved_tensors
        br = ctx.block_rows
        N = x.shape[0]
        V = w.shape[0]
        exact = x.dtype in _HALF and w.dtype in _HALF
        valid = _valid(labels, ctx.ignore_index)
        scale = ct.float() / valid.sum().clamp_min(1).float()
        wf = w.float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty_like(x)
        for s in range(0, N, br):
            xs = x[s:s + br]
            g = torch.softmax(_mm(xs, wf.T, exact), dim=-1)
            li = labels[s:s + br].clamp(0, V - 1)
            g[torch.arange(g.shape[0], device=g.device), li] -= 1.0
            g *= (valid[s:s + br].float() * scale)[:, None]
            gb = g.to(w.dtype)
            dx[s:s + br] = _mm(gb, wf, exact).to(x.dtype)
            dw += _mm(gb.T, xs, exact)
        return dx, dw.to(w.dtype), None, None, None


def fused_linear_cross_entropy(x, w, labels, block_rows=None,
                               ignore_index=-100):
    """x (N, d); w (V, d), the tied LM-head weight; labels (N,) int. Rows
    whose label is ``ignore_index`` (or negative) are left out of the sum
    and of the mean's denominator. ``block_rows=None`` resolves through the
    kernel registry (``fused_ce``); an explicit value bypasses it."""
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
    return _FusedLinearCE.apply(x, w, labels.long(), int(block_rows),
                                int(ignore_index))
