"""Registry specs of the flash-attention kernels and the fused LM-head
cross-entropy (port of ``paddle_tpu/ops/kernels/builtin.py``).

The defaults are what the call sites launched before the registry existed:
the flash forward's compile-time tile (``FwdWg``, 128 x 128, in
``csrc/flash_attention.cu``; the ``wgmma`` design fixes it, so the space is
that one choice) and the fused CE's 2048-row block. The implementations stay
where they are (``flash_attention.py``, ``ops/fused_ce.py``); the runners
import them when they run.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import dtype_name, pow2, register_kernel

__all__ = ["flash_attention_key", "fused_ce_key"]


def flash_attention_key(b, h, t, t_kv, d, dtype, causal) -> tuple:
    """(batch*heads pow2-bucketed, heads, q len, kv len, head dim, dtype,
    causal); the lengths stay exact."""
    return (pow2(int(b) * int(h)), int(h), int(t), int(t_kv), int(d),
            dtype_name(dtype), bool(causal))


def _flash_runner(key):
    from .flash_attention import flash_attention_array

    bh, h, t, t_kv, d, dtype, causal = key
    b = max(bh // h, 1)
    rng = np.random.RandomState(0)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            "cuda", dt)

    # (B, T, H, D), the layout flash_attention_array takes
    q, k, v = rnd(b, t, h, d), rnd(b, t_kv, h, d), rnd(b, t_kv, h, d)

    def make(config):
        bq, bk = int(config["block_q"]), int(config["block_k"])
        return lambda: flash_attention_array(q, k, v, causal, block_q=bq,
                                             block_k=bk)

    return make


register_kernel(
    "flash_attention",
    defaults={"block_q": 128, "block_k": 128},
    space={"block_q": (128,), "block_k": (128,)},
    runner=_flash_runner,
    valid=None,
    source="flash_attention",
)


def fused_ce_key(n, d, v, dtype) -> tuple:
    """(rows pow2-bucketed, hidden, vocab, dtype). d and V set the block
    logits' footprint and stay exact."""
    return (pow2(int(n)), int(d), int(v), dtype_name(dtype))


def _fce_runner(key):
    from ..fused_ce import fused_linear_cross_entropy

    n, d, v, dtype = key
    rng = np.random.RandomState(0)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev, dt)
    w = torch.from_numpy(rng.randn(v, d).astype(np.float32)).to(dev, dt)
    labels = torch.from_numpy(rng.randint(0, v, size=(n,))).to(dev)

    def make(config):
        br = int(config["block_rows"])

        def step():
            # the train step's shape: forward and both gradients (the
            # backward recomputes the block logits, so block_rows counts
            # twice)
            xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
            loss = fused_linear_cross_entropy(xx, ww, labels, br)
            return (loss.detach(), *torch.autograd.grad(loss, (xx, ww)))

        return step

    return make


register_kernel(
    "fused_ce",
    defaults={"block_rows": 2048},
    space={"block_rows": (512, 1024, 2048, 4096, 8192)},
    runner=_fce_runner,
    valid=None,
)
