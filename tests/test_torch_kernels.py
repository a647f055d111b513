"""Port parity: the kernels' plain PyTorch versions against the JAX kernels.

On the CPU each wrapper of ``paddle_tpu_torch.ops.kernels`` runs its plain
version; the JAX kernels run in Pallas interpret mode, as
``tests/test_paged_kernel.py`` runs them. Every input is made with numpy
from a seed and handed to both packages. The CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``; the
paged kernel's cluster-split rule and the shapes that script checks it at
are plain Python there, and are tested here.

Tolerances: f32 attention and matmul differ only by summation order
(atol/rtol 1e-5); the int8 rounding must be bit-equal, and so must the
bf16 dequantized weight that one-hot rows read out and the once-rounded sums
of two of its columns that two-hot rows read out.
"""
import numpy as np
import pytest
import torch

import chip_smoke
import jax.numpy as jnp
from paddle_tpu.ops import kernels as JK
from paddle_tpu.serving import int8 as jint8
from paddle_tpu_torch.ops import kernels as TK
from paddle_tpu_torch.serving import int8 as tint8


def _paged_inputs(rep, seed=1, MB=4, pos=(0, 7, 8, 15, 27), KV=2, D=16):
    """Pool, disjoint tables with trash-padded dead columns, and positions
    on and across block edges (BS=8)."""
    B, BS = len(pos), 8
    NB = B * MB + 1
    rng = np.random.RandomState(seed)
    kpool = rng.randn(NB, BS, KV, D).astype(np.float32)
    vpool = rng.randn(NB, BS, KV, D).astype(np.float32)
    q = rng.randn(B, KV * rep, D).astype(np.float32)
    pos = np.array(pos, np.int32)
    perm = rng.permutation(np.arange(1, NB)).reshape(B, MB)
    tables = np.zeros((B, MB), np.int32)  # dead columns at trash block 0
    for b in range(B):
        n_live = pos[b] // BS + 1
        tables[b, :n_live] = perm[b, :n_live]
    return q, kpool, vpool, tables, pos


# (rep, MB, positions, KV, D): every grouping the kernel instantiates, a
# 24-block table whose positions sit on block edges (first and last token of
# a block, the table's last position), and Llama-7B's heads (KV = 32 heads of
# D = 128, rep 1)
PAGED_CASES = [(rep, 4, (0, 7, 8, 15, 27), 2, 16) for rep in (1, 2, 4, 8)] + [
    (2, 24, (63, 64, 127, 128, 191), 2, 16),
    (1, 8, (0, 15, 16, 40, 63), 32, 128)]
PAGED_IDS = ["mha", "gqa_rep2", "gqa_rep4", "gqa_rep8",
             "long_table_block_edges", "kv32_d128"]
# bf16: the reference kernel and the plain version round at different points
# (the plain version rounds the scores and probabilities to bf16, the kernel
# sums in f32), so they agree within one bf16 ulp of the output's scale
# (2^(floor(log2 max|out|) - 7)); bit-equal shares measured on these inputs,
# in PAGED_IDS order: 53.8%, 55.6%, 57.7%, 55.7%, 39.1%, 53.9%
PAGED_PARAMS = [pytest.param(*c, "float32", id=i)
                for c, i in zip(PAGED_CASES, PAGED_IDS)] + [
    pytest.param(*c, "bfloat16", id=f"bf16-{i}")
    for c, i in zip(PAGED_CASES, PAGED_IDS)]


@pytest.mark.parametrize("rep,MB,pos,KV,D,dtype", PAGED_PARAMS)
def test_paged_attention_plain_matches_jax(rep, MB, pos, KV, D, dtype):
    q, kpool, vpool, tables, pos = _paged_inputs(rep, MB=MB, pos=pos, KV=KV,
                                                 D=D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(JK.paged_attention_rows(
        *(jnp.asarray(a, jd) for a in (q, kpool, vpool)),
        jnp.asarray(tables), jnp.asarray(pos)).astype(jnp.float32))
    out = TK.paged_attention_rows(
        *(torch.from_numpy(a).to(td) for a in (q, kpool, vpool)),
        torch.from_numpy(tables), torch.from_numpy(pos))
    assert out.dtype == td and out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        np.testing.assert_allclose(out.float().numpy(), ref, atol=ulp, rtol=0)


@pytest.mark.parametrize("B,KV,BS,MB,n_sm,want", [
    (32, 16, 16, 64, 132, 2),    # the engine's decode shape: 1024 blocks
    (32, 16, 16, 128, 132, 2),   # contexts near 2000
    (2, 16, 16, 128, 132, 8),    # two rows of 2048: the most a cluster takes
    (48, 16, 16, 64, 132, 1),    # 768 pairs already fill 132 SMs
    (5, 2, 8, 4, 132, 1),        # a 32-position table is never split
    (1, 1, 16, 16, 132, 4),      # 256 positions: each block keeps >= 64
    (1, 1, 16, 8, 132, 2),       # 128 positions: two blocks of 64
    (32, 32, 16, 64, 132, 1),    # Llama-7B's decode shape: 1024 pairs
    (16, 32, 16, 128, 132, 2),   # Llama, 16 rows: 512 pairs, GPT's get 4
    (1, 32, 16, 128, 132, 8),    # Llama, one row of 2048
])
def test_paged_split_rule(B, KV, BS, MB, n_sm, want):
    assert chip_smoke.paged_split_rule(B, KV, BS, MB, n_sm) == want


def test_paged_split_rule_bounds():
    for B in (1, 2, 3, 8, 33, 512):
        for MB in (1, 4, 64, 128, 4096):
            split = chip_smoke.paged_split_rule(B, 16, 16, MB, 132)
            assert split in (1, 2, 4, 8)
            # every block of a split row keeps at least 64 positions, and a
            # split only happens while the pairs would not fill the card
            assert split == 1 or (MB * 16 // split >= 64
                                  and B * 16 * (split // 2) < 4 * 132)


@pytest.mark.parametrize("n_sm", [132, 114], ids=["h100_sxm", "h100_pcie"])
def test_paged_checks_cover_every_engine_launch_and_split(n_sm):
    grid = chip_smoke.engine_paged_shapes()
    # each engine's decode buckets 1..32 by gather widths 1..128 blocks, at
    # GPT-3 1.3B's 16 KV heads and Llama-7B's 32
    by_kv = {kv: {(B, MB) for B, MB, k in grid if k == kv} for kv in (16, 32)}
    assert len(grid) == 2 * 6 * 8 and {kv for _, _, kv in grid} == {16, 32}
    assert by_kv[16] == by_kv[32]
    assert (16, 64) in by_kv[32] and (32, 128) in by_kv[32]
    shapes = chip_smoke.paged_check_shapes()
    assert {(B, MB, kv) for rep, B, MB, kv in shapes if rep == 1} >= set(grid)
    assert {rep for rep, _, _, _ in shapes} == {1, 2, 4, 8}
    splits = {chip_smoke.paged_split_rule(B, kv, 16, MB, n_sm)
              for _, B, MB, kv in shapes}
    assert splits == {1, 2, 4, 8}
    # the rule at KV = 32 is its own: fewer (row, head) pairs are needed to
    # fill the card, so some launches split less than GPT's at the same
    # (B, MB), and the Llama launches alone still run more than one size
    llama = {(B, MB): chip_smoke.paged_split_rule(B, 32, 16, MB, n_sm)
             for B, MB in by_kv[32]}
    assert len(set(llama.values())) > 1
    assert any(s < chip_smoke.paged_split_rule(B, 16, 16, MB, n_sm)
               for (B, MB), s in llama.items())
    # the timing shapes include Llama's decode shape
    assert ("llama_decode", 32, 64, None, 32) in chip_smoke.PAGED_SHAPES


def _int8_inputs(M, K, N, transpose_w, seed=2):
    """x (M, K) f32 and the quantized weight, (N, K) or (K, N), with its
    f32 scale, rounded as the reference's quantizer rounds."""
    rng = np.random.RandomState(seed)
    w = rng.randn(N, K).astype(np.float32)
    scale = np.float32(np.abs(w).max())
    qw = np.clip(np.round(w / (scale / 127.0)), -127, 127).astype(np.int8)
    if not transpose_w:
        qw = np.ascontiguousarray(qw.T)
    return rng.randn(M, K).astype(np.float32), qw, scale


# (transpose_w, M, K, N, atol): the first two are the original cases; then
# the row counts the serving engine launches (1, 4, 32) and two passes of
# the CUDA kernel (48), at N that is no multiple of 8 or of its 128-row
# blocks and K that is no multiple of 16 or of its 128-byte chunks. atol:
# the f32 sums differ only in order, by up to ~K * 2^-24 * sum|x w| (~3e-6
# at K = 48 with unit-scale x and w), so the wider cases take the 1e-5 this
# file states for f32 matmuls; the original K = 32 cases keep 1e-6
INT8_CASES = [(True, 3, 32, 64, 1e-6), (False, 3, 32, 64, 1e-6)] + [
    (tw, M, K, N, 1e-5) for tw in (True, False)
    for M, K, N in ((1, 64, 130), (4, 40, 128), (32, 48, 72), (48, 40, 130))]


@pytest.mark.parametrize(
    "transpose_w,M,K,N,atol", INT8_CASES,
    ids=["nk", "kn"] + [f"{'nk' if c[0] else 'kn'}-M{c[1]}-K{c[2]}-N{c[3]}"
                        for c in INT8_CASES[2:]])
def test_int8_matmul_plain_matches_jax(transpose_w, M, K, N, atol):
    x, qw, scale = _int8_inputs(M, K, N, transpose_w)
    ref = np.asarray(JK.int8_matmul(jnp.asarray(x), jnp.asarray(qw),
                                    jnp.asarray(scale, jnp.float32),
                                    transpose_w=transpose_w))
    out = TK.int8_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                         torch.tensor(scale), transpose_w=transpose_w)
    assert out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("transpose_w", [True, False], ids=["nk", "kn"])
def test_int8_matmul_plain_matches_jax_bf16(transpose_w):
    """bf16 activations: both dequantize to bf16 with the same rounding and
    round the f32 sums once to bf16, so they differ by at most the output's
    rounding (2^-8 relative) where the sums are taken in another order."""
    x, qw, scale = _int8_inputs(32, 72, 130, transpose_w, seed=3)
    jx = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(JK.int8_matmul(jx, jnp.asarray(qw),
                                    jnp.asarray(scale, jnp.float32),
                                    transpose_w=transpose_w).astype(jnp.float32))
    out = TK.int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(qw), torch.tensor(scale),
                         transpose_w=transpose_w)
    assert out.dtype == torch.bfloat16 and out.shape == (32, 130)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("transpose_w", [True, False], ids=["nk", "kn"])
def test_int8_matmul_onehot_rows_are_reference_dequant_bits(transpose_w):
    """One-hot bf16 rows pick single columns of the dequantized weight: the
    port's output must be the reference's ``dequantize_tree`` values bit for
    bit (the check ``chip_smoke.py`` makes of the CUDA kernel against this
    plain version). One-hot rows cannot tell a scale folded in after the
    sum from the reference's rounding; the two-hot test below can."""
    K, N = 72, 130
    _, qw, scale = _int8_inputs(1, K, N, transpose_w, seed=4)
    ks = np.round(np.linspace(0, K - 1, 32)).astype(np.int64)
    x = np.zeros((32, K), np.float32)
    x[np.arange(32), ks] = 1.0
    out = TK.int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(qw), torch.tensor(scale),
                         transpose_w=transpose_w)
    wd = jint8.dequantize_tree(
        {jint8._TAG: jnp.asarray(qw), "scale": jnp.asarray(scale, jnp.float32)},
        jnp.bfloat16)
    want = np.asarray(wd.T if transpose_w else wd)[ks]
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  want.view(np.int16))


@pytest.mark.parametrize("transpose_w", [True, False], ids=["nk", "kn"])
def test_int8_matmul_twohot_rows_are_reference_dequant_sums(transpose_w):
    """Two-hot bf16 rows e_a + e_b (the pairs ``chip_smoke.py``'s exact check
    uses) give the sum of two columns of the reference's ``dequantize_tree``
    values, exact in f32 and rounded once to bf16: the port's output must
    equal it bit for bit, and a scale folded in after the sum,
    bf16(s127 * (q_a + q_b)), must differ from it on these rows, or the
    check could not tell the two apart."""
    K, N = 72, 130
    _, qw, scale = _int8_inputs(1, K, N, transpose_w, seed=5)
    _, pairs = chip_smoke.int8_exact_rows(K)
    a, b = pairs[:, 0], pairs[:, 1]
    assert (a != b).all()
    x = np.zeros((32, K), np.float32)
    x[np.arange(32), a] = 1.0
    x[np.arange(32), b] = 1.0
    out = TK.int8_matmul(torch.from_numpy(x).to(torch.bfloat16),
                         torch.from_numpy(qw), torch.tensor(scale),
                         transpose_w=transpose_w)
    wd = jint8.dequantize_tree(
        {jint8._TAG: jnp.asarray(qw), "scale": jnp.asarray(scale, jnp.float32)},
        jnp.bfloat16)
    wd = np.asarray(wd.T if transpose_w else wd).astype(np.float32)  # (K, N)
    want = torch.from_numpy(wd[a] + wd[b]).to(torch.bfloat16)
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  want.view(torch.int16).numpy())
    q = (qw.T if transpose_w else qw).astype(np.float32)
    s127 = np.float32(scale) / np.float32(127.0)
    folded = torch.from_numpy((q[a] + q[b]) * s127).to(torch.bfloat16)
    assert (folded.view(torch.int16) != want.view(torch.int16)).any()


def test_int8_checks_cover_every_engine_launch():
    """``chip_smoke.py`` checks the int8 head at every row count the engine
    phase's engine launches it with (decode buckets, prefill width), and at
    two passes, a ragged N and a ragged K."""
    rows = chip_smoke.engine_int8_rows()
    assert rows == [1, 2, 4, 8, 16, 32]
    assert chip_smoke.ENGINE_KW["prefill_batch"] in rows
    shapes = chip_smoke.int8_check_shapes()
    K, N = chip_smoke.INT8_HEAD
    assert {(M, K, N) for M in rows} <= set(shapes)
    # Llama-7B's untied head (hidden 4096, vocab 32000), stored (K, N): every
    # row count at its shape, and every check runs the (K, N) layout
    # (transpose_w=False) as well as (N, K)
    models = {name: (cfg, head) for name, cfg, _, head in
              chip_smoke.engine_models()}
    cfg, head = models["llama_7b"]
    assert head == chip_smoke.LLAMA_HEAD == (cfg.hidden_size,
                                             cfg.vocab_size) == (4096, 32000)
    assert {(M, 4096, 32000) for M in rows} <= set(shapes)
    assert set(chip_smoke.INT8_LAYOUTS) == {True, False}
    assert any(M > 32 for M, _, _ in shapes)
    assert any(n % 8 for _, _, n in shapes)
    assert any(k % 128 for _, k, _ in shapes)
    assert 32 in chip_smoke.INT8_TIMING_ROWS


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
