"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

``scaled_dot_product_attention`` takes (B, T, H, D) q, k, v, as the
reference does, and either runs the exact formula or the flash kernels
(``ops/kernels/flash_attention.py``). An eligible call runs the kernel or
raises: there is no quiet fallback to the exact path.
"""
from __future__ import annotations

import math

import torch

from ...core.dispatch import amp_cast
from ...ops.kernels.flash_attention import flash_attention_array
from .common import _keep_mask

_FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _flash_eligible(q, is_causal, attn_mask, dropout_p, training):
    """Whether ``impl=None`` takes the flash kernels. The reference's further
    bounds (T >= 512, the K/V VMEM size) are measurements and limits of the
    TPU; the Hopper kernels stream K/V tiles through shared memory at any T,
    so they are dropped."""
    if not is_causal or attn_mask is not None or (dropout_p and training):
        return False
    d = q.shape[-1]
    return (d % 8 == 0 and d <= 256 and q.dtype in _FLASH_DTYPES
            and q.device.type == "cuda")


def _exact(q, k, v, attn_mask, dropout_p, is_causal):
    """Scores scaled in the input dtype, additive mask, causal -1e30 fill
    (top-left; -inf in float16, as the reference's cast of -1e30), softmax,
    optional dropout keep-mask. The AMP cast applies here, to q, k, v and
    the mask, and never on the flash route, whose reference counterpart
    (``flash_attention``) is on neither list."""
    q, k, v, attn_mask = amp_cast("scaled_dot_product_attention",
                                  (q, k, v, attn_mask))
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, T, D)
    scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * (1.0 / math.sqrt(qh.shape[-1]))
    if attn_mask is not None:
        scores = scores + attn_mask
    if is_causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(
            ~keep, float("-inf") if scores.dtype == torch.float16 else -1e30)
    probs = torch.softmax(scores, dim=-1)
    if dropout_p:
        keep = _keep_mask(probs.shape, float(dropout_p), q.device)
        probs = probs * keep.to(probs.dtype) / (1.0 - dropout_p)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
    return out.transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, impl=None):
    """q, k, v (B, T, H, D) → (B, T, H, D). ``impl``: None (flash when
    eligible, else exact) | "exact" | "flash" (raises on an ineligible
    call)."""
    if impl not in (None, "exact", "flash"):
        raise ValueError(f"impl must be None|'exact'|'flash', got {impl!r}")
    if impl == "flash":
        if not is_causal or attn_mask is not None or (dropout_p and training):
            raise ValueError(
                "impl='flash' requires is_causal=True, no attn_mask, no dropout")
        return flash_attention_array(query, key, value, causal=True)
    if impl is None and _flash_eligible(query, is_causal, attn_mask,
                                        dropout_p, training):
        return flash_attention_array(query, key, value, causal=True)
    return _exact(query, key, value, attn_mask,
                  dropout_p if training else 0.0, is_causal)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False):
    """Same routing as ``scaled_dot_product_attention``; returns (out, None)."""
    return scaled_dot_product_attention(query, key, value, is_causal=causal,
                                        dropout_p=dropout), None


__all__ = ["scaled_dot_product_attention", "flash_attention"]
