"""Port parity: Llama through the paged serving path of ``paddle_tpu_torch``
against JAX.

GQA ``llama_tiny(num_kv_heads=2)`` (4 query heads over 2 KV heads, rep 2):
the JAX model's ``state_dict()`` is loaded by name into the port, and the
same numpy-made ids, tables, positions and pools go into both packages, f32
on the CPU. The JAX paged-attention kernel runs in Pallas interpret mode;
the port's wrappers run their plain versions. Logits within atol 1e-4, pools
within 1e-5 (summation order); greedy tokens must be equal. The port
updates its pools in place, so it gets its own copies of the inputs.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import int8 as tint8
from serving_util import ENGINE_KW, make_prompts
from torch_port_util import port_of_llama

BS, MB, V = 8, 4, 1024


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_kv_heads=2))
    jm.eval()
    return jm, port_of_llama(jm)


def _states(models):
    jm, tm = models
    _, jarch, jparams, _ = JG.llama_decode_state(jm)
    _, tarch, tparams, _ = TG.llama_decode_state(tm, "cpu")
    return jarch, jparams, tarch, tparams


def test_decode_state_keeps_kv_heads_and_untied_head(models):
    jm, tm = models
    jkey, jarch, _, jmax = JG.llama_decode_state(jm)
    tkey, tarch, tparams, tmax = TG.llama_decode_state(tm, "cpu")
    assert tkey == jkey == ("llama", 4, 2, 32, 4, 10000.0, 1e-6)
    assert (tarch["kv_heads"], tarch["head_dim"], tmax) == (
        jarch["kv_heads"], jarch["head_dim"], jmax) == (2, 32, 256)
    assert tuple(tparams["head_w"].shape) == (128, V)  # (K, N)
    assert set(tparams["layers"][0]) == {
        "ln1_w", "q_w", "k_w", "v_w", "o_w", "ln2_w", "gate_w", "up_w",
        "down_w"}


def test_paged_prefill_logits_and_pool_blocks(models):
    jarch, jparams, tarch, tparams = _states(models)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    B, T = 2, 16
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    lens = np.array([13, 5], np.int32)
    tables = np.zeros((B, 16), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :1] = [5]
    shape = (L, 12, BS, KV, D)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    jk, jv, jl = jax.jit(JG.build_paged_prefill(jarch, B, T, BS, 16))(
        jparams, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(tables),
        jnp.asarray(kp), jnp.asarray(vp))
    with torch.inference_mode():
        tk, tv, tl = TG.build_paged_prefill(tarch, B, T, BS, 16)(
            tparams, *map(torch.from_numpy, (ids, lens, tables, kp.copy(),
                                             vp.copy())))
    assert tl.shape == (B, V)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    live = [3, 7, 5]  # the trash block 0 takes the padding rows' writes
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_paged_decode_steps_tokens_and_pools(models, kernel):
    jarch, jparams, tarch, tparams = _states(models)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    B, NB = 4, 24
    rng = np.random.RandomState(1)
    shape = (L, NB, BS, KV, D)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB) \
        .astype(np.int32)
    pos = np.array([3, 8, 17, 27], np.int32)  # RoPE at each row's own pos
    toks = rng.randint(0, V, (B,)).astype(np.int32)
    temps = np.zeros((B,), np.float32)
    jbuild = JG.build_paged_decode_kernel if kernel else JG.build_paged_decode
    tbuild = TG.build_paged_decode_kernel if kernel else TG.build_paged_decode
    jstep = jax.jit(jbuild(jarch, B, BS, MB))
    tstep = tbuild(tarch, B, BS, MB)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jt = tt = toks
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        p = pos + step
        jk, jv, jn = jstep(jparams, jk, jv, jnp.asarray(tables),
                           jnp.asarray(p), jnp.asarray(jt), jnp.asarray(temps),
                           jax.random.PRNGKey(step))
        with torch.inference_mode():
            tk, tv, tn = tstep(tparams, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(p), torch.from_numpy(tt),
                               torch.from_numpy(temps), gen)
        jt, tt = np.asarray(jn), tn.numpy()
        assert tt.tolist() == jt.tolist(), step
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf", "int8"])
def test_engine_greedy_tokens_match_reference_engine(models, int8):
    jm, tm = models
    fl = {"FLAGS_serve_paged_kernel": True, "FLAGS_serve_int8_kernel": int8}
    old_j = {k: jflags._FLAGS.get(k) for k in fl}
    old_t = tflags.get_flags(list(fl))
    jflags._FLAGS.update(fl)
    tflags.set_flags(fl)
    prompts = make_prompts(4, np.random.RandomState(3))
    try:
        with JEngine(jm, int8=int8, **ENGINE_KW) as je:
            ref = [h.result(timeout=300) for h in
                   [je.submit(p, max_new_tokens=8) for p in prompts]]
        with Engine(tm, device="cpu", int8=int8, **ENGINE_KW) as te:
            out = [h.result(timeout=300) for h in
                   [te.submit(p, max_new_tokens=8) for p in prompts]]
            assert te.stats()["decode_steps"] > 0
            assert te.config.max_seq_len == 128
            assert ("head_q" in te._params) == int8
    finally:
        jflags._FLAGS.update(old_j)
        tflags.set_flags(old_t)
    assert out == ref
    assert all(len(o) == len(p) + 8 for o, p in zip(out, prompts))


def test_int8_tree_heads_untied_kn_and_gathers_wte_rows(models, monkeypatch):
    """The int8 Llama tree carries ``head_q`` quantized from ``head_w``, laid
    out (K, N), and the head runs ``int8_matmul(..., transpose_w=False)``;
    ``wte`` is quantized too and the embedding gathers its int8 rows through
    ``take`` before dequantizing them."""
    _, _, tarch, tparams = _states(models)
    tagged = tint8.quantize_params(tparams)
    dense = tint8.dequantize_tree(tagged, torch.float32)
    tree = tint8.attach_int8_head(dense, tagged)
    hq = tree["head_q"]
    assert torch.equal(hq["q"], tagged["head_w"][tint8._TAG])
    assert tuple(hq["q"].shape) == (128, V) and hq["q"].dtype == torch.int8
    assert torch.equal(hq["scale"], tagged["head_w"]["scale"])
    assert tagged["wte"][tint8._TAG].dtype == torch.int8

    calls = []
    real_mm = TG.int8_matmul

    def spy_mm(x, q, scale, transpose_w=True):
        calls.append((tuple(q.shape), transpose_w))
        return real_mm(x, q, scale, transpose_w=transpose_w)

    takes = []
    real_take = type(tree).take

    def spy_take(self, key, idx):
        takes.append(key)
        return real_take(self, key, idx)

    monkeypatch.setattr(TG, "int8_matmul", spy_mm)
    monkeypatch.setattr(type(tree), "take", spy_take)
    x = torch.from_numpy(np.random.RandomState(2).randn(3, 1, 128)
                         .astype(np.float32))
    logits = tarch["head"](tree, x)
    assert calls == [((128, V), False)]
    h = TG._rms(x[:, -1], tree["lnf_w"], 1e-6)
    np.testing.assert_allclose(logits.numpy(), (h @ dense["head_w"]).numpy(),
                               atol=1e-5, rtol=1e-5)
    toks = torch.tensor([5, 0, 1023])
    emb = tarch["embed_rows"](tree, toks, toks)
    assert takes == ["wte"]
    assert torch.equal(emb[:, 0], dense["wte"][toks])


def test_engine_rejects_other_models_naming_both():
    with pytest.raises(TypeError, match="GPTForPretraining or "
                                        "LlamaForCausalLM"):
        Engine(torch.nn.Linear(2, 2), device="cpu")
