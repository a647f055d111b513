"""Port parity: the kernels' plain PyTorch versions against the JAX kernels.

On the CPU each wrapper of ``paddle_tpu_torch.ops.kernels`` runs its plain
version; the JAX kernels run in Pallas interpret mode, as
``tests/test_paged_kernel.py`` runs them. Every input is made with numpy
from a seed and handed to both packages. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.

Tolerances: f32 attention and matmul differ only by summation order
(atol/rtol 1e-5); the int8 rounding must be bit-equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.ops import kernels as JK
from paddle_tpu.serving import int8 as jint8
from paddle_tpu_torch.ops import kernels as TK
from paddle_tpu_torch.serving import int8 as tint8


def _paged_inputs(rep, seed=1):
    """Pool, disjoint tables with trash-padded dead columns, and positions
    on and across block edges (BS=8)."""
    B, KV, D, BS, MB, NB = 5, 2, 16, 8, 4, 40
    rng = np.random.RandomState(seed)
    kpool = rng.randn(NB, BS, KV, D).astype(np.float32)
    vpool = rng.randn(NB, BS, KV, D).astype(np.float32)
    q = rng.randn(B, KV * rep, D).astype(np.float32)
    pos = np.array([0, 7, 8, 15, 27], np.int32)
    perm = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    tables = np.zeros((B, MB), np.int32)  # dead columns at trash block 0
    for b in range(B):
        n_live = pos[b] // BS + 1
        tables[b, :n_live] = perm[b, :n_live]
    return q, kpool, vpool, tables, pos


@pytest.mark.parametrize("rep", [1, 2], ids=["mha", "gqa_rep2"])
def test_paged_attention_plain_matches_jax(rep):
    q, kpool, vpool, tables, pos = _paged_inputs(rep)
    ref = np.asarray(JK.paged_attention_rows(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(tables), jnp.asarray(pos)))
    out = TK.paged_attention_rows(*map(torch.from_numpy,
                                       (q, kpool, vpool, tables, pos)))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("transpose_w", [True, False], ids=["nk", "kn"])
def test_int8_matmul_plain_matches_jax(transpose_w):
    rng = np.random.RandomState(2)
    M, K, N = 3, 32, 64
    w = rng.randn(N, K).astype(np.float32)
    scale = np.float32(np.abs(w).max())
    qw = np.clip(np.round(w / (scale / 127.0)), -127, 127).astype(np.int8)
    if not transpose_w:
        qw = np.ascontiguousarray(qw.T)
    x = rng.randn(M, K).astype(np.float32)
    ref = np.asarray(JK.int8_matmul(jnp.asarray(x), jnp.asarray(qw),
                                    jnp.asarray(scale, jnp.float32),
                                    transpose_w=transpose_w))
    out = TK.int8_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                         torch.tensor(scale), transpose_w=transpose_w)
    assert out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_matches_jax(dtype):
    rng = np.random.RandomState(5)
    tree = {"w": (rng.randn(48, 40) * 0.05).astype(np.float32),
            "layers": [{"m": rng.randn(16, 8).astype(np.float32),
                        "b": rng.randn(8).astype(np.float32)}]}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jtree = {"w": jnp.asarray(tree["w"], jd),
             "layers": [{k: jnp.asarray(v, jd)
                         for k, v in tree["layers"][0].items()}]}
    ttree = {"w": torch.from_numpy(tree["w"]).to(td),
             "layers": [{k: torch.from_numpy(v).to(td)
                         for k, v in tree["layers"][0].items()}]}
    jq, tq = jint8.quantize_params(jtree), tint8.quantize_params(ttree)
    for jl, tl in ((jq["w"], tq["w"]), (jq["layers"][0]["m"],
                                        tq["layers"][0]["m"])):
        assert tl[tint8._TAG].dtype == torch.int8
        np.testing.assert_array_equal(tl[tint8._TAG].numpy(),
                                      np.asarray(jl[jint8._TAG]))
        assert float(tl["scale"]) == float(jl["scale"])
    # 1-D params stay float, untouched
    assert tq["layers"][0]["b"].dtype == td
    # the lazy dequant view gives the reference's dense values
    jdense = jint8.dequantize_tree(jq, jd)
    tdense = tint8.dequantize_tree(tq, td)
    np.testing.assert_array_equal(
        tdense["layers"][0]["m"].float().numpy(),
        np.asarray(jdense["layers"][0]["m"].astype(jnp.float32)))


def test_cpu_wrappers_run_plain_and_count_no_launch():
    TK.reset_launch_counts()
    q, kpool, vpool, tables, pos = map(torch.from_numpy, _paged_inputs(1))
    out = TK.paged_attention_rows(q, kpool, vpool, tables, pos)
    assert torch.equal(out, TK.paged_attention_rows_plain(
        q, kpool, vpool, tables, pos))
    x = torch.randn(2, 16)
    qw = torch.randint(-127, 128, (24, 16), dtype=torch.int8)
    TK.int8_matmul(x, qw, torch.tensor(0.5), transpose_w=True)
    qkv = torch.randn(1, 8, 2, 16)
    TK.flash_attention_array(qkv, qkv, qkv, causal=True).sum()
    assert TK.launch_counts() == {
        "paged_attention_rows": 0, "int8_matmul": 0, "flash_attention_fwd": 0,
        "flash_attention_dq": 0, "flash_attention_dkv": 0}


def test_attach_int8_head_grafts_quantized_head():
    w = {"wte": torch.randn(12, 8), "lnf_w": torch.ones(8)}
    tagged = tint8.quantize_params(w)
    dense = tint8.dequantize_tree(tagged, torch.float32)
    grafted = tint8.attach_int8_head(dense, tagged)
    assert grafted["head_q"]["q"].dtype == torch.int8
    assert "head_q" not in dense  # the original view is untouched
    assert tint8.attach_int8_head(w, w) is w  # nothing quantized: unchanged
    # take() dequantizes only the gathered rows, to the same values
    idx = torch.tensor([3, 0, 3])
    assert torch.equal(dense.take("wte", idx), dense["wte"][idx])
