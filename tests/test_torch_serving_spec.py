"""Port parity: speculative decoding in the serving engine of
``paddle_tpu_torch``, against JAX.

The builders (``build_paged_spec_decode``, ``build_window_draft``) take the
same numpy-made tokens, tables, positions and pools in both packages, f32 on
the CPU: the verify logits at every fed position within 1e-5 and the written
pool blocks within 1e-6 by relative norm (elementwise within atol 1e-5, the
serving tests' pool tolerance: summation order), every other block
bit-equal, greedy tokens and draft proposals exact. ``_ngram_propose`` must
return the reference's proposals. The engines must give the JAX engine's
greedy tokens with the n-gram drafter, with a model drafter, and (on Llama)
with the prefix cache, speculation and chunked prefill all on. The
reference's speculative behaviours (``tests/test_serving_prefix.py``) are
cases of ``test_spec_behaviour``, each against the port's own engine with
speculation off.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import engine as JE
from paddle_tpu_torch import profiler
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import Engine
from paddle_tpu_torch.serving import engine as E
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import drained, port_of, port_of_llama, serve_waves

BS = 8


@pytest.fixture(scope="module")
def gpt():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def llama():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_kv_heads=2))
    jm.eval()
    return jm, port_of_llama(jm)


@pytest.fixture(scope="module")
def drafter():
    """A 1-layer GPT at a quarter of the tiny GPT's width, same vocabulary."""
    paddle.seed(7)
    jd = JGPT(JGPTConfig(vocab_size=211, hidden_size=16, num_layers=1,
                         num_heads=2, max_position_embeddings=128,
                         hidden_dropout=0.0, attention_dropout=0.0))
    jd.eval()
    return jd, port_of(jd)


def _delta(c0):
    c1 = profiler.counters()
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _states(models, kind):
    jm, tm = models
    jstate = JG.gpt_decode_state if kind == "gpt" else JG.llama_decode_state
    tstate = TG.gpt_decode_state if kind == "gpt" else TG.llama_decode_state
    _, jarch, jparams, _ = jstate(jm)
    _, tarch, tparams, _ = tstate(tm, "cpu")
    return jarch, jparams, tarch, tparams


def _motif_prompts(rng, n, vocab=211):
    """Prompts that repeat a short motif, so the n-gram drafter proposes."""
    out = []
    for _ in range(n):
        motif = rng.randint(0, vocab, (int(rng.randint(2, 6)),)).tolist()
        out.append(motif * int(rng.randint(2, 5))
                   + rng.randint(0, vocab, (int(rng.randint(1, 4)),)).tolist())
    return out


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_spec_decode_builder_matches_jax(gpt, llama, kind):
    """Four rows, k = 3: full drafts, a row with unproposed (-1) slots, a
    row whose feeds cross a block edge, and a row whose last feed lands on
    the table's last slot."""
    jarch, jparams, tarch, tparams = _states(gpt if kind == "gpt" else llama,
                                             kind)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    V = tparams["wte"].shape[0]
    B, k, MB, NB = 4, 3, 4, 24
    rng = np.random.RandomState(2)
    kp = rng.randn(L, NB, BS, KV, D).astype(np.float32)
    vp = rng.randn(L, NB, BS, KV, D).astype(np.float32)
    tables = np.arange(1, 1 + B * MB, dtype=np.int32).reshape(B, MB)
    pos = np.array([3, 9, 14, 28], np.int32)
    toks = rng.randint(0, V, (B, k + 1)).astype(np.int32)
    toks[1, 2:] = -1
    temps = np.zeros((B,), np.float32)

    def jstep(*args):
        box = []
        arch = dict(jarch, head_all=lambda p, x: box.append(
            jarch["head_all"](p, x)) or box[0])
        return JG.build_paged_spec_decode(arch, B, k, BS, MB)(*args) \
            + (box[0],)

    jk, jv, jg, _, jl = jax.jit(jstep)(
        jparams, *map(jnp.asarray, (kp, vp, tables, pos, toks, temps)),
        jax.random.PRNGKey(0))
    step = TG.build_paged_spec_decode(tarch, B, k, BS, MB)
    with torch.inference_mode():
        tl = step.logits(tparams, *map(torch.from_numpy, (
            kp.copy(), vp.copy(), tables, pos, toks)))
        tk, tv, tg, ts = step(tparams, *map(torch.from_numpy, (
            kp.copy(), vp.copy(), tables, pos, toks, temps)),
            torch.Generator().manual_seed(0))
    assert tl.shape == (B, k + 1, V)
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-5
    assert tg.tolist() == np.asarray(jg).tolist()
    assert ts.tolist() == tg[:, 0].tolist()  # greedy rows sample greedily
    # feeds at pos + [0..3]: blocks of each row's columns pos // 8 ..
    written = sorted({int(tables[r, (p + j) // BS]) for r, p in enumerate(pos)
                      for j in range(k + 1)})
    kept = [b for b in range(1, NB) if b not in written]
    for t, j, p in ((tk, jk, kp), (tv, jv, vp)):
        t, j = t.numpy(), np.asarray(j)
        assert _rel(t[:, written], j[:, written]) <= 1e-6
        np.testing.assert_allclose(t[:, written], j[:, written], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(t[:, kept], p[:, kept])


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_window_draft_builder_matches_jax(gpt, llama, kind):
    jarch, jparams, tarch, tparams = _states(gpt if kind == "gpt" else llama,
                                             kind)
    V = tparams["wte"].shape[0]
    B, W, k = 3, 12, 4
    rng = np.random.RandomState(3)
    ids = rng.randint(0, V, (B, W)).astype(np.int32)
    lens = np.array([12, 5, 1], np.int32)
    want = jax.jit(JG.build_window_draft(jarch, B, W, k))(
        jparams, jnp.asarray(ids), jnp.asarray(lens))
    with torch.inference_mode():
        got = TG.build_window_draft(tarch, B, W, k)(
            tparams, torch.from_numpy(ids), torch.from_numpy(lens))
    assert got.dtype == torch.int32 and got.shape == (B, k)
    assert got.tolist() == np.asarray(want).tolist()


def test_ngram_propose_matches_reference():
    rng = np.random.RandomState(4)
    lists = _motif_prompts(rng, 40, vocab=9) + make_prompts(20, rng, lo=1,
                                                            hi=30)
    lists += [[], [5], [5, 5], [1, 2, 3, 1, 2, 3, 1, 2]]
    for tokens in lists:
        for k in (1, 3, 5):
            assert E._ngram_propose(tokens, k) == JE._ngram_propose(tokens, k)


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_engine_spec_tokens_match_reference(gpt, drafter, draft):
    """spec_k = 3 over prompts with repeated motifs: the n-gram drafter's
    proposals are accepted in part; the model drafter (random weights)
    proposes for every row at every step.
    Greedy tokens must be the JAX engine's, with the same settings."""
    jm, tm = gpt
    rng = np.random.RandomState(5)
    prompts = _motif_prompts(rng, 6)
    jkw, tkw = dict(ENGINE_KW, spec_k=3), dict(ENGINE_KW, spec_k=3)
    if draft == "model":
        jkw.update(drafter=drafter[0], draft_window=32)
        tkw.update(drafter=drafter[1], draft_window=32)
    with JEngine(jm, **jkw) as je:
        ref = serve_waves(je, [prompts], max_new_tokens=10)
    c0 = profiler.counters()
    with Engine(tm, device="cpu", **tkw) as te:
        out = serve_waves(te, [prompts], max_new_tokens=10)
        st = drained(te)
        assert st["pages_used"] == 0
        assert st["decode_steps"] > 0 and st["decode_step_ms_mean"] > 0
        assert {k[0] for k in te._fns} >= (
            {"spec", "draft"} if draft == "model" else {"spec"})
        assert not any(k[0] == "decode" for k in te._fns)
    assert out == ref
    d = _delta(c0)
    assert 0 < d["serve_draft_proposed"]
    assert d["serve_draft_accepted"] <= d["serve_draft_proposed"]
    if draft == "ngram":  # a random drafter's proposals may all miss
        assert d["serve_draft_accepted"] > 0


def test_engine_llama_all_features_match_reference(llama):
    """Llama (GQA) with the prefix cache, spec_k = 3 and chunks of two
    blocks: prompts of 24 to 40 tokens that share a 24-token prefix, the
    first wave one request, the second all at once."""
    jm, tm = llama
    rng = np.random.RandomState(6)
    shared = rng.randint(0, 1024, (24,)).tolist()
    prompts = [shared + rng.randint(0, 1024, (int(rng.randint(1, 17)),))
               .tolist() for _ in range(5)]
    waves = [prompts[:1], prompts]
    kw = dict(ENGINE_KW, prefix_cache=True, spec_k=3, prefill_chunk=2 * BS)
    with JEngine(jm, **kw) as je:
        ref = serve_waves(je, waves, max_new_tokens=8)
    c0 = profiler.counters()
    with Engine(tm, device="cpu", **kw) as te:
        out = serve_waves(te, waves, max_new_tokens=8)
        st = drained(te)
        assert st["pages_used"] == st["pages_cached"] > 0
    assert out == ref
    d = _delta(c0)
    assert d["serve_prefix_hits"] >= 5 and d["serve_prefill_chunks"] >= 1
    assert d["serve_tail_prefills"] >= 1


def _eos_and_budget_mid_acceptance(tm, rng):
    prompts = _motif_prompts(rng, 8)
    for eos in (7, None):
        with Engine(tm, device="cpu", **ENGINE_KW) as eng:
            base = serve_waves(eng, [[p] for p in prompts], max_new_tokens=12,
                               eos_token_id=eos)
        with Engine(tm, device="cpu", spec_k=4, **ENGINE_KW) as eng:
            out = serve_waves(eng, [[p] for p in prompts], max_new_tokens=12,
                              eos_token_id=eos)
        assert out == base
        assert all(len(o[0]) <= len(p) + 12 for o, p in zip(out, prompts))


def _sampling_rows_one_token_a_step(tm, rng):
    p = rng.randint(0, 211, (9,)).tolist()
    c0 = profiler.counters()
    with Engine(tm, device="cpu", spec_k=3, seed=5, **ENGINE_KW) as eng:
        out = eng.generate(p, max_new_tokens=8, temperature=0.8)
        st = drained(eng)
    assert len(out) == 9 + 8 and out[:9] == p
    assert st["pages_used"] == 0
    d = _delta(c0)
    assert d["serve_draft_proposed"] == 0
    assert st["decode_steps"] == 7  # the first token comes from the prefill


SPEC_BEHAVIOURS = {
    "eos_and_budget_mid_acceptance": _eos_and_budget_mid_acceptance,
    "sampling_rows_one_token_a_step": _sampling_rows_one_token_a_step,
}


@pytest.mark.parametrize("case", sorted(SPEC_BEHAVIOURS))
def test_spec_behaviour(gpt, case):
    SPEC_BEHAVIOURS[case](gpt[1], np.random.RandomState(
        sorted(SPEC_BEHAVIOURS).index(case) + 13))


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_debug_spec_logits_agree(gpt, llama, kind):
    """``Engine._debug_spec_logits`` (the card's verify check): on the CPU
    in f32 the verify step's logits at each j = 0..4 give those of j+1
    sequential decode steps within 1e-5 by relative norm, and every block
    it took is freed."""
    _, tm = gpt if kind == "gpt" else llama
    vocab = 211 if kind == "gpt" else 1024
    prompts = make_prompts(3, np.random.RandomState(8), lo=5, hi=30)
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        ver, seq = eng._debug_spec_logits(prompts, 4)
        assert eng.stats()["pages_used"] == 0
        eng._pool.check()
    assert ver.shape == seq.shape == (3, 5, vocab)
    assert _rel(ver, seq) <= 1e-5
    assert (ver.argmax(-1) == seq.argmax(-1)).all()
