"""Port parity: ``paddle_tpu_torch`` flash attention against the JAX package.

On the CPU the port's ``flash_attention_array`` runs its plain version (the
exact masked softmax in f32, autograd for the backward); the reference runs
its Pallas kernels in interpret mode with 128-blocks, as
``tests/test_flash_attention.py`` does. Inputs are numpy arrays made from a
seed. The CUDA kernels are held against the same plain version on the card
by ``chip_smoke.py``.

Tolerances: f32 values differ only by summation order and the online vs
direct softmax (atol/rtol 2e-5 for O, as the reference's own parity test;
5e-4/1e-3 for the gradients, which sum T products more).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas.flash_attention import flash_attention_array as jflash
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.kernels import (flash_attention_array,
                                          flash_attention_plain)

# (B, T, T_kv, H, D, causal): the reference's own parity shapes, the T=200
# causal tail (padded to a block by the reference), a D=128 head that routes
# the reference through its native-layout `_flash_hd`, T != T_kv, and the
# two shapes the card's checks add for the TMA-fed kernels: a D=40 head
# (zero-filled to a 64-column panel) and a ragged non-causal T != T_kv
CASES = [
    (2, 256, 256, 4, 64, True),
    (2, 256, 256, 4, 64, False),
    (1, 384, 384, 2, 32, True),
    (1, 200, 200, 2, 64, True),
    (1, 256, 256, 2, 128, True),
    (1, 128, 256, 2, 64, False),
    (1, 192, 192, 1, 40, True),
    (1, 136, 200, 1, 64, False),
]
IDS = ["b2t256h4d64_causal", "b2t256h4d64", "t384d32_causal", "t200_tail",
       "hd_route_d128", "t128_tkv256", "d40_causal", "t136_tkv200"]


def _inputs(B, T, Tk, H, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, Tk, H, D).astype(np.float32)
    v = rng.randn(B, Tk, H, D).astype(np.float32)
    co = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, co


def _ref(q, k, v, co, causal):
    def loss(q, k, v):
        out = jflash(q, k, v, causal=causal, block_q=128, block_k=128,
                     interpret=True)
        return (out * co).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,T,Tk,H,D,causal", CASES, ids=IDS)
def test_forward_and_grads_match_reference(B, T, Tk, H, D, causal):
    q, k, v, co = _inputs(B, T, Tk, H, D)
    ref_out, ref_grads = _ref(q, k, v, co, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_array(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(co)).sum().backward()
    assert out.shape == (B, T, H, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref_out,
                               atol=2e-5, rtol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_matches_numpy_logsumexp(causal):
    q, k, v, _ = _inputs(1, 96, 160, 2, 32, seed=3)
    _, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / math.sqrt(32)
    if causal:  # top-left aligned, also for T != T_kv
        s = np.where(np.tri(96, 160, dtype=bool), s, -1e30)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (1, 2, 96) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-5)


def test_exact_sdpa_with_additive_mask_matches_reference():
    q, k, v, _ = _inputs(2, 24, 24, 2, 16, seed=5)
    rng = np.random.RandomState(6)
    mask = np.where(rng.rand(2, 2, 24, 24) < 0.2, -1e4, 0.0).astype(np.float32)
    ref = JF.scaled_dot_product_attention(
        *map(paddle.to_tensor, (q, k, v)), attn_mask=paddle.to_tensor(mask),
        training=False)
    out = TF.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)), attn_mask=torch.from_numpy(mask),
        training=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()),
                               atol=1e-5, rtol=1e-5)


def test_exact_sdpa_causal_matches_flash_plain():
    q, k, v, _ = _inputs(1, 40, 40, 2, 16, seed=7)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    exact = TF.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                            impl="exact")
    flash = TF.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                            impl="flash")
    np.testing.assert_allclose(exact.numpy(), flash.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("call", ["mask", "not_causal", "dropout"])
def test_impl_flash_raises_on_ineligible_call(call):
    q = torch.zeros(1, 8, 2, 16)
    kw = {"is_causal": True}
    if call == "mask":
        kw["attn_mask"] = torch.zeros(1, 2, 8, 8)
    elif call == "not_causal":
        kw["is_causal"] = False
    else:
        kw.update(dropout_p=0.1, training=True)
    with pytest.raises(ValueError, match="impl='flash'"):
        TF.scaled_dot_product_attention(q, q, q, impl="flash", **kw)


def test_auto_route_on_cpu_is_exact_and_counts_no_launch():
    from paddle_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    q = torch.randn(1, 16, 2, 16, generator=torch.Generator().manual_seed(0))
    TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert all(v == 0 for v in K.launch_counts().values())
    assert set(K.launch_counts()) >= {"flash_attention_fwd",
                                      "flash_attention_dq",
                                      "flash_attention_dkv"}
