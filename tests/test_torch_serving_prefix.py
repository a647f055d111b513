"""Port parity: prefix-cache KV sharing and chunked prefill in the serving
engine of ``paddle_tpu_torch``, against JAX.

The builders (``build_paged_tail_prefill``, ``_rope_grid``) take the same
numpy-made ids, tables, starts and pools in both packages, f32 on the CPU:
logits within 1e-5 and the written pool blocks within 1e-6 by relative
norm (elementwise within atol 1e-5, the serving tests' pool tolerance:
summation order), every other block bit-equal, tokens exact. The engines (the
tiny GPT of ``serving_util``, block 8) must give the JAX engine's greedy
tokens under the same settings. The reference's prefix-cache behaviours
(``tests/test_serving_prefix.py``) are cases of ``test_prefix_behaviour``,
each against the port's own engine with the feature off. With every feature
off, none of the new paths is reached (``test_inert_tripwire``).
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu_torch import profiler
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import Engine, EngineConfig
from paddle_tpu_torch.serving import engine as E
from paddle_tpu_torch.serving.pool import PagePool
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import (drained, port_of, port_of_llama, serve_flags,
                             serve_waves)

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


def _delta(c0):
    c1 = profiler.counters()
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}


def _shared_prompts(rng, n, shared_len=40, lo=3, hi=10, vocab=211):
    shared = rng.randint(0, vocab, (shared_len,)).tolist()
    return [shared + rng.randint(0, vocab, (int(rng.randint(lo, hi)),))
            .tolist() for _ in range(n)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _states(models, kind):
    jm, tm = models
    jstate = JG.gpt_decode_state if kind == "gpt" else JG.llama_decode_state
    tstate = TG.gpt_decode_state if kind == "gpt" else TG.llama_decode_state
    _, jarch, jparams, _ = jstate(jm)
    _, tarch, tparams, _ = tstate(tm, "cpu")
    return jarch, jparams, tarch, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_grid_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [37, 38, 39, 40, 41]], np.int32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = JG._rope_grid(jnp.asarray(x).astype(jd), jnp.asarray(pos), 10000.0)
    got = TG._rope_grid(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                        10000.0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    else:  # cos/sin cast to bf16 before the products, as the reference does
        assert torch.equal(got, torch.from_numpy(
            np.array(want.astype(jnp.float32))).to(td))


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tail_prefill_builder_matches_jax(gpt, llama, kind):
    """Three rows: a tail after two cached blocks, one after one block, and
    one whose padded bucket runs past the 16-block table (its padding
    writes go to the trash block, its positions past the table read the
    last row of GPT's position table)."""
    jarch, jparams, tarch, tparams = _states(gpt if kind == "gpt" else llama,
                                             kind)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    V = tparams["wte"].shape[0]
    B, T, MB, NB = 3, 16, 16, 40
    rng = np.random.RandomState(1)
    kp = rng.randn(L, NB, BS, KV, D).astype(np.float32)
    vp = rng.randn(L, NB, BS, KV, D).astype(np.float32)
    tables = np.zeros((B, MB), np.int32)
    tables[0, :5] = [3, 4, 5, 6, 7]
    tables[1, :3] = [8, 9, 10]
    tables[2, :16] = np.arange(11, 27)
    starts = np.array([16, 8, 120], np.int32)
    lens = np.array([13, 9, 6], np.int32)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    jk, jv, jl = jax.jit(JG.build_paged_tail_prefill(jarch, B, T, BS, MB))(
        jparams, *map(jnp.asarray, (ids, starts, lens, tables, kp, vp)))
    with torch.inference_mode():
        tk, tv, tl = TG.build_paged_tail_prefill(tarch, B, T, BS, MB)(
            tparams, *map(torch.from_numpy, (ids, starts, lens, tables,
                                             kp.copy(), vp.copy())))
    assert tl.shape == (B, V)
    assert _rel(tl.numpy(), np.asarray(jl)) <= 1e-5
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    # each tail writes table columns start // 8 + [0, 1] (row 2's second
    # column is past the table: the trash block 0 takes it); every other
    # block, the cached heads below each tail among them, is untouched
    written = [5, 6, 9, 10, 26]
    kept = [b for b in range(1, NB) if b not in written]
    for t, j, p in ((tk, jk, kp), (tv, jv, vp)):
        t, j = t.numpy(), np.asarray(j)
        assert _rel(t[:, written], j[:, written]) <= 1e-6
        np.testing.assert_allclose(t[:, written], j[:, written], rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(t[:, kept], p[:, kept])


def test_engine_config_validates_and_takes_flags():
    with pytest.raises(ValueError, match="multiple of block_size"):
        EngineConfig(block_size=8, prefill_chunk=12).resolve(128)
    with pytest.raises(ValueError, match="spec_k"):
        EngineConfig(spec_k=-1).resolve(128)
    with pytest.raises(ValueError, match="draft_window"):
        EngineConfig(spec_k=2, draft_window=1).resolve(128)
    cfg = EngineConfig().resolve(128)
    assert (cfg.prefix_cache, cfg.spec_k, cfg.drafter, cfg.draft_window,
            cfg.prefill_chunk) == (False, 0, "ngram", 64, 0)
    with serve_flags(FLAGS_serve_prefix_cache=True, FLAGS_serve_spec_k=3,
                     FLAGS_serve_prefill_chunk=16):
        cfg = EngineConfig(block_size=8).resolve(128)
    assert (cfg.prefix_cache, cfg.spec_k, cfg.prefill_chunk) == (True, 3, 16)


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["gather", "kernel"])
def test_engine_prefix_cache_tokens_match_reference(gpt, paged_kernel):
    """Two waves over prompts that share a 40-token prefix: the first one
    request at a time (each lands in the cache), the second all at once
    (every row a tail prefill over shared blocks). Decode reads the shared
    blocks through the paged kernel's plain version in the kernel case."""
    jm, tm = gpt
    rng = np.random.RandomState(0)
    prompts = _shared_prompts(rng, 4)
    waves = [[p] for p in prompts] + [prompts]
    kw = dict(ENGINE_KW, prefix_cache=True)
    with serve_flags(FLAGS_serve_paged_kernel=paged_kernel):
        with JEngine(jm, **kw) as je:
            ref = serve_waves(je, waves, max_new_tokens=8)
        c0 = profiler.counters()
        with Engine(tm, device="cpu", **kw) as te:
            out = serve_waves(te, waves, max_new_tokens=8)
            st = drained(te)
    assert out == ref
    d = _delta(c0)
    assert d["serve_prefix_hits"] >= 4 + 3
    assert d["serve_prefix_blocks_shared"] >= 7 * (40 // BS)
    assert d["serve_tail_prefills"] >= 2
    assert st["pages_used"] == st["pages_cached"] > 0
    assert te.stats()["pages_used"] == 0  # close() released the index


def test_engine_chunked_prefill_tokens_match_reference(gpt):
    """Chunks of two blocks: prompts of 20 to 60 tokens prefill over 2 to 4
    scheduler steps while the shorter ones decode."""
    jm, tm = gpt
    rng = np.random.RandomState(1)
    prompts = make_prompts(6, rng, lo=20, hi=60)
    kw = dict(ENGINE_KW, prefill_chunk=2 * BS)
    with JEngine(jm, **kw) as je:
        ref = serve_waves(je, [prompts], max_new_tokens=8)
    c0 = profiler.counters()
    with Engine(tm, device="cpu", **kw) as te:
        out = serve_waves(te, [prompts], max_new_tokens=8)
        assert drained(te)["pages_used"] == 0
    assert out == ref
    assert _delta(c0)["serve_prefill_chunks"] >= 2


def _evict_respects_pins(tm, rng):
    kw = dict(ENGINE_KW, num_blocks=24)
    fills = [rng.randint(0, 211, (32,)).tolist() for _ in range(4)]
    live = make_prompts(6, rng, lo=16, hi=24)
    with Engine(tm, device="cpu", **kw) as eng:
        base = serve_waves(eng, [live], max_new_tokens=6)
    with Engine(tm, device="cpu", prefix_cache=True, **kw) as eng:
        serve_waves(eng, [[p] for p in fills], max_new_tokens=4)
        assert eng.stats()["pages_cached"] > 0
        c0 = profiler.counters()
        out = serve_waves(eng, [live], max_new_tokens=6)
        assert _delta(c0)["serve_prefix_evicted"] > 0
        st = drained(eng)
        assert st["pages_used"] == st["pages_cached"]
    assert out == base


def _preempt_sharer_peer_intact(tm, rng):
    shared = rng.randint(0, 211, (40,)).tolist()
    prompts = [shared + rng.randint(0, 211, (6,)).tolist() for _ in range(4)]
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        base = serve_waves(eng, [[p] for p in prompts], max_new_tokens=24)
    c0 = profiler.counters()
    kw = dict(ENGINE_KW, num_blocks=20)  # four streams and the cache overflow
    with Engine(tm, device="cpu", prefix_cache=True, **kw) as eng:
        out = serve_waves(eng, [prompts], max_new_tokens=24)
        st = drained(eng)
        assert st["pages_used"] == st["pages_cached"]
    assert out[0] == [o[0] for o in base]
    assert _delta(c0)["serve_preempted"] > 0


def _drain_64_streams_no_leak(tm, rng):
    kw = dict(ENGINE_KW, num_blocks=128, max_batch=16)
    prompts = _shared_prompts(rng, 64, shared_len=24, lo=3, hi=12)
    with Engine(tm, device="cpu", prefix_cache=True, **kw) as eng:
        out = serve_waves(eng, [prompts], max_new_tokens=6)
        st = drained(eng)
    assert all(len(o) == len(p) + 6 for o, p in zip(out[0], prompts))
    assert st["pages_used"] == st["pages_cached"] > 0


def _cow_guard_copies_shared_write_block(tm, rng):
    prompt = rng.randint(0, 211, (9,)).tolist()
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        base = eng.generate(prompt, max_new_tokens=16)
    with Engine(tm, device="cpu", prefix_cache=True, **ENGINE_KW) as eng:
        h = eng.submit(prompt, max_new_tokens=16, stream=True)
        next(iter(h))  # admitted and decoding
        for _ in range(500):
            if eng._running:
                break
            time.sleep(0.01)
        seq = eng._running[0]
        wb = seq.blocks[seq.pos // BS]
        eng._pool.share([wb])  # a peer that maps the write block
        c0 = profiler.counters()
        out = h.result(timeout=60)
        assert _delta(c0)["serve_cow_copies"] >= 1
        assert eng._pool.refcount(wb) == 1  # the peer's reference survives
        eng._pool.free([wb])
        drained(eng)
    assert out == base


PREFIX_BEHAVIOURS = {
    "evict_respects_pins": _evict_respects_pins,
    "preempt_sharer_peer_intact": _preempt_sharer_peer_intact,
    "drain_64_streams_no_leak": _drain_64_streams_no_leak,
    "cow_guard_copies_shared_write_block":
        _cow_guard_copies_shared_write_block,
}


@pytest.mark.parametrize("case", sorted(PREFIX_BEHAVIOURS))
def test_prefix_behaviour(gpt, case):
    PREFIX_BEHAVIOURS[case](gpt[1], np.random.RandomState(
        sorted(PREFIX_BEHAVIOURS).index(case) + 2))


def test_inert_tripwire(gpt, monkeypatch):
    """Every feature off (the defaults): the prefix index, the refcount
    share, the tail / speculative / draft builders and the chunk path are
    replaced with bombs, and the engine serves the same tokens."""
    _, tm = gpt
    prompts = make_prompts(6, np.random.RandomState(30))
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        base = serve_waves(eng, [prompts], max_new_tokens=8)

    def boom(*a, **k):
        raise AssertionError("inert path reached while unconfigured")

    monkeypatch.setattr(PagePool, "share", boom)
    for name in ("match", "insert", "evict"):
        monkeypatch.setattr(E._PrefixCache, name, boom)
    for name in ("_decode_spec", "_propose", "_cow_guard", "_match_prefix",
                 "_chunk_divert", "_chunk_step", "_make_drafter"):
        monkeypatch.setattr(E.Engine, name, boom)
    monkeypatch.setattr(E, "_ngram_propose", boom)
    for name in ("build_paged_tail_prefill", "build_paged_spec_decode",
                 "build_window_draft"):
        monkeypatch.setattr(TG, name, boom)
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        assert eng._prefix is None and eng._spec_k == 0
        assert eng._drafter is None and eng._chunk == 0
        out = serve_waves(eng, [prompts], max_new_tokens=8)
        st = drained(eng)
        assert st["pages_used"] == st["pages_cached"] == 0
        assert all(k[0] in ("prefill", "decode") for k in eng._fns)
    assert out == base


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_debug_prefill_paths_agree(gpt, llama, kind):
    """``Engine._debug_prefill_paths`` (the card's tail and chunk check):
    on the CPU in f32 the tail over a cached prefix and the chunked prefill
    give the monolithic prefill's logits within 1e-5 by relative norm, and
    free every block they took. GPT runs with the prefix cache (its second
    wave's prompts match cached chains), Llama without (the tail reads the
    first half of the monolithic pass's blocks)."""
    _, tm = gpt if kind == "gpt" else llama
    rng = np.random.RandomState(40)
    vocab = 211 if kind == "gpt" else 1024
    prompts = _shared_prompts(rng, 3, shared_len=32, lo=20, hi=40,
                              vocab=vocab)
    kw = dict(ENGINE_KW, prefix_cache=kind == "gpt", prefill_chunk=2 * BS)
    with Engine(tm, device="cpu", **kw) as eng:
        serve_waves(eng, [prompts[:1]], max_new_tokens=2)
        used = drained(eng)["pages_used"]
        mono, tail, chunk = eng._debug_prefill_paths(prompts)
        assert eng.stats()["pages_used"] == used
        eng._pool.check()
    assert mono.shape == (3, vocab) and np.isfinite(mono).all()
    assert _rel(tail, mono) <= 1e-5 and _rel(chunk, mono) <= 1e-5
    assert (tail.argmax(-1) == mono.argmax(-1)).all()
    assert (chunk.argmax(-1) == mono.argmax(-1)).all()
