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

In bf16 the plain versions round where the reference's kernels round (P
before P V; P before dV, dS before dQ and dK), so O matches the reference
bit for bit but for the bf16 roundings that the scores' f32 summation order
flips (measured 99.88% to 99.98% of O bitwise equal at the four shapes
below, max abs 1.95e-3) and the gradients within 2.4e-4 by relative norm,
about ten times closer than a form that rounds only the outputs (2.5e-3 to
3.0e-3, computed beside it).
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
                                          flash_attention_bwd_plain,
                                          flash_attention_plain)

# (B, T, T_kv, H, D, causal): the reference's own parity shapes, the T=200
# causal tail (padded to a block by the reference), a D=128 head that routes
# the reference through its native-layout `_flash_hd`, T != T_kv, and the
# shapes the card's checks add for the TMA-fed kernels: a D=40 head
# (zero-filled to a 64-column panel), a ragged non-causal T != T_kv, and the
# two edges of a 128-row q tile over 64-row K/V tiles: causal T != T_kv (top
# left aligned, as the reference) and T=130 at D=128, one row past a tile
CASES = [
    (2, 256, 256, 4, 64, True),
    (2, 256, 256, 4, 64, False),
    (1, 384, 384, 2, 32, True),
    (1, 200, 200, 2, 64, True),
    (1, 256, 256, 2, 128, True),
    (1, 128, 256, 2, 64, False),
    (1, 192, 192, 1, 40, True),
    (1, 136, 200, 1, 64, False),
    (1, 136, 200, 1, 64, True),
    (1, 130, 130, 1, 128, True),
]
IDS = ["b2t256h4d64_causal", "b2t256h4d64", "t384d32_causal", "t200_tail",
       "hd_route_d128", "t128_tkv256", "d40_causal", "t136_tkv200",
       "t136_tkv200_causal", "t130_d128_causal"]


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


def _outputs_rounded_once(q, k, v, causal):
    """The exact formula in f32 with O rounded once to q's dtype (no bf16
    rounding of P or dS): the form the bf16 plain versions replace."""
    D, T, Tk = q.shape[-1], q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        s = s.masked_fill(~torch.ones(T, Tk, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _bf16_run(fn, q, k, v, co, causal):
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = fn(tq, tk, tv, causal)
    (out.float() * torch.from_numpy(co).bfloat16().float()).sum().backward()
    return out.detach().float().numpy(), [x.grad.float().numpy()
                                          for x in (tq, tk, tv)]


# the measured bounds of the bf16 plain versions against the reference (see
# the module docstring): O bitwise share and max abs, gradients' relative norm
BF16_O_BITWISE = 0.998
BF16_O_ATOL = 4e-3
BF16_GRAD_REL = 1e-3


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_plain_keeps_reference_rounding(D, causal):
    """bf16 B=1, T=256, H=2 through the reference (interpret mode, blocks of
    128) and the port's CPU route: O within the bitwise share and max abs
    above; dQ, dK, dV within ``BF16_GRAD_REL`` by relative norm, and each
    closer to the reference than the outputs-rounded-once form."""
    q, k, v, co = _inputs(1, 256, 256, 2, D)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, co)]

    def loss(q, k, v):
        out = jflash(q, k, v, causal=causal, block_q=128, block_k=128,
                     interpret=True)
        return (out.astype(jnp.float32) * jb[3].astype(jnp.float32)).sum(), out

    (_, ref), ref_grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(*jb[:3])
    ref = np.asarray(ref.astype(jnp.float32))
    ref_grads = [np.asarray(g.astype(jnp.float32)) for g in ref_grads]
    out, grads = _bf16_run(flash_attention_array, q, k, v, co, causal)
    _, once_grads = _bf16_run(_outputs_rounded_once, q, k, v, co, causal)
    assert (out == ref).mean() >= BF16_O_BITWISE
    assert np.abs(out - ref).max() <= BF16_O_ATOL

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for got, once, want in zip(grads, once_grads, ref_grads):
        assert rel(got, want) <= BF16_GRAD_REL
        assert rel(got, want) < rel(once, want)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_f32_plain_backward_matches_autograd(causal):
    """In f32 the plain backward is the exact gradient of the plain forward
    (autograd through it on the same inputs)."""
    q, k, v, co = _inputs(1, 96, 160 if not causal else 96, 2, 32, seed=4)
    tq, tk, tv = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / math.sqrt(32)
    if causal:
        s = s.masked_fill(~torch.ones(96, 96, dtype=torch.bool).tril(), -1e30)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), tv)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(co).double())
    fq, fk, fv, fco = map(torch.from_numpy, (q, k, v, co))
    o, lse = flash_attention_plain(fq, fk, fv, causal)
    got = flash_attention_bwd_plain(fq, fk, fv, fco, o, lse, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=1e-4)


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
