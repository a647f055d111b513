"""Port parity: serving-state durability in ``paddle_tpu_torch`` (the pool's
snapshot and restore, ``kv_block_checksums``, ``Engine.snapshot``/``adopt``/
``handoff`` and the supervisor's crash re-attach), against JAX.

The tiny GPT of ``serving_util`` (and a tiny GQA Llama) is built in both
packages with the same weights (``torch_port_util.port_of``), f32, greedy.
Every recovery scenario of the reference's ``tests/test_serving_snapshot.py``
runs on the port's engine, and its outputs must equal the JAX engine's
outputs for the same prompts token for token. Pool CRCs must equal the
reference's on the same bookkeeping, and the checksums the reference's
within rtol 1e-6 (f32 sums in another order). The crash scenario runs in
both packages under one chaos spec whose first step waits while all prompts
land (``serve.slow_step:at=1``) and whose crash hits a fixed decode step, so
the recovery records' counts must be equal too. Every wait has a timeout.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.fault import inject as jinject
from paddle_tpu.models.llama import LlamaConfig as JLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import PagePool as JPagePool
from paddle_tpu.serving import ServingSupervisor as JSupervisor
from paddle_tpu.serving.pool import _pool_crc as j_pool_crc
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import (Engine, PagePool, ServeError,
                                      ServingSupervisor, SnapshotError,
                                      TRASH_BLOCK)
from paddle_tpu_torch.serving import engine as E
from paddle_tpu_torch.serving import pool as P
from paddle_tpu_torch.serving.pool import _pool_crc
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import chaos, port_of, port_of_llama, wait_for

KW = dict(ENGINE_KW, device="cpu")
# the JAX baselines: a pool big enough that nothing is preempted
REF_KW = dict(ENGINE_KW, num_blocks=256)
# the whole wave is queued before the first admission
FIRST_STEP_WAITS = "serve.slow_step:at=1,ms=200"


@pytest.fixture(scope="module")
def gpt():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def llama():
    paddle.seed(3)
    cfg = JLlamaConfig(vocab_size=193, hidden_size=32, num_layers=2,
                       num_heads=4, num_kv_heads=2, intermediate_size=64,
                       max_position_embeddings=128)
    jm = JLlama(cfg)
    jm.eval()
    return jm, port_of_llama(jm)


@pytest.fixture(scope="module")
def ref(gpt):
    """Greedy outputs of the JAX engine, one wave of prompts at a time."""
    eng = JEngine(gpt[0], **REF_KW)
    yield lambda prompts, n: [h.result(timeout=300) for h in
                              [eng.submit(p, max_new_tokens=n)
                               for p in prompts]]
    eng.close()


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jinject.disarm()


def _delta(c0, name):
    return profiler.counters().get(name, 0) - c0.get(name, 0)


def _mid_decode(eng, steps=2):
    wait_for(lambda: eng.stats()["decode_steps"] >= steps, 30,
             "decode never started")


# ---------------------------------------------------------------- pool unit
def _busy(cls):
    pool = cls(16)
    a = pool.alloc(3)
    b = pool.alloc(2)
    pool.share(b)  # refcount 2: a shared prefix block
    pool.park(4)
    return pool, a, b


def test_pool_roundtrip_and_crc_match_reference():
    pool, a, b = _busy(PagePool)
    jpool, _, _ = _busy(JPagePool)
    snap = pool.snapshot()
    jsnap = jpool.snapshot()
    assert {k: snap[k] for k in ("free", "ref", "parked")} \
        == {k: jsnap[k] for k in ("free", "ref", "parked")}
    assert snap["crc"] == jsnap["crc"]
    assert _pool_crc(16, snap["free"], snap["ref"], snap["parked"]) \
        == j_pool_crc(16, snap["free"], snap["ref"], snap["parked"])
    clone = PagePool.restore(snap)
    clone.check()
    assert (clone.num_blocks, clone.free_blocks, clone.parked_blocks) \
        == (pool.num_blocks, pool.free_blocks, pool.parked_blocks)
    assert all(clone.refcount(x) == 1 for x in a)
    assert all(clone.refcount(x) == 2 for x in b)
    clone.free(b)  # live: the shared blocks need both frees
    assert all(clone.refcount(x) == 1 for x in b)
    pool.free(a)  # the capture is not a view of the source
    assert all(PagePool.restore(snap).refcount(x) == 1 for x in a)
    # a port capture restores in the reference and the other way round
    assert JPagePool.restore(snap).free_blocks == len(snap["free"]) == 6
    assert PagePool.restore(jsnap).parked_blocks == 4


def _recrc(snap):
    snap["crc"] = _pool_crc(snap["num_blocks"], snap["free"], snap["ref"],
                            snap["parked"])
    return snap


@pytest.mark.parametrize("tamper,match", [
    (lambda s, a: s["free"].pop(), "torn"),
    (lambda s, a: _recrc(s) and s["free"].append(a[0]) or _recrc(s),
     "two states"),
    (lambda s, a: s["ref"].__setitem__(a[0], 0) or _recrc(s), "refcount"),
    (lambda s, a: s["ref"].__setitem__(TRASH_BLOCK, 1) or _recrc(s),
     "out of range"),
    (lambda s, a: s["ref"].__setitem__(s["num_blocks"] + 3, 1) or _recrc(s),
     "out of range"),
    (lambda s, a: s.__setitem__("version", 99), "version"),
    (lambda s, a: s.__setitem__("free", object()), "malformed"),
], ids=["torn", "free_and_owned", "zero_ref", "trash_ref", "id_past_end",
        "bad_version", "malformed"])
def test_pool_restore_rejects(tamper, match):
    pool, a, _ = _busy(PagePool)
    snap = pool.snapshot()
    tamper(snap, a)
    with pytest.raises(SnapshotError, match=match):
        PagePool.restore(snap)


def test_pool_park_and_damage_keep_reference_semantics():
    for cls in (PagePool, JPagePool):
        pool = cls(8)
        assert pool.park(100) == 6  # one free block always stays
        assert pool.alloc(2) is None and pool.alloc(1) is not None
        assert pool.unpark(2) == 2 and pool.parked_blocks == 4
        pool.check()
        pool.damage()
        with pytest.raises(RuntimeError):
            pool.check()


# ---------------------------------------------------------------- checksums
def test_kv_block_checksums_match_reference_and_repeat_bitwise():
    rng = np.random.RandomState(0)
    kp = rng.randn(2, 12, 8, 2, 16).astype(np.float32)
    vp = rng.randn(2, 12, 8, 2, 16).astype(np.float32)
    bids = [3, 1, 7, 11, 4]
    want = JG.kv_block_checksums(jnp.asarray(kp), jnp.asarray(vp), bids)
    tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
    got = TG.kv_block_checksums(tk, tv, bids)
    assert got.shape == (5, 2) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.array_equal(got, TG.kv_block_checksums(tk, tv, bids))
    assert TG.kv_block_checksums(tk, tv, []).shape == (0, 2)
    # more blocks than one gather chunk: the same sums as one at a time
    many = list(range(12)) * 12
    full = TG.kv_block_checksums(tk, tv, many)
    np.testing.assert_array_equal(full[:12], TG.kv_block_checksums(
        tk, tv, list(range(12))))
    np.testing.assert_allclose(full[12:24], full[:12], rtol=0)
    # a zeroed block changes its own fingerprint only
    tk2 = tk.clone()
    tk2[:, 7] = 0
    diff = TG.kv_block_checksums(tk2, tv, bids) != got
    assert diff.tolist() == [[False, False], [False, False], [True, False],
                             [False, False], [False, False]]


# ------------------------------------------------------------------ handoff
def test_handoff_mid_decode_matches_reference(gpt, ref):
    prompts = make_prompts(6, np.random.RandomState(30))
    want = ref(prompts, 10)
    c0 = profiler.counters()
    old = Engine(gpt[1], **KW)
    try:
        hs = [old.submit(p, max_new_tokens=10) for p in prompts]
        _mid_decode(old)
        snap = old.handoff()
        with pytest.raises(ServeError):
            old.submit([1, 2], max_new_tokens=2)  # stopped for good
        assert not old._thread.is_alive()
        with Engine(gpt[1], **KW) as new:
            own_pool = new._kpool
            info = new.adopt(snap)
            assert new._kpool is snap["kpool"] and new._kpool is not own_pool
            running = [r for r in snap["seqs"] if r["phase"] == "running"]
            assert info["mode"] == "reattach"
            assert info["reattached"] == len(running) > 0
            assert info["reprefill_tokens"] == 0 and info["resumed"] == 0
            assert info["blocks_reattached"] == sum(len(r["blocks"])
                                                    for r in running)
            assert info["reprefill_tokens_saved"] == sum(len(r["tokens"])
                                                         for r in running)
            outs = [h.result(timeout=60) for h in hs]
            assert new.health()["last_recovery"]["mode"] == "reattach"
            wait_for(lambda: new.stats()["pages_used"] == 0, 10, "no drain")
    finally:
        old.close()
    assert outs == want
    assert _delta(c0, "serve_handoffs") == 1
    assert _delta(c0, "serve_adoptions") == 1
    assert _delta(c0, "serve_reprefill_tokens") == 0


class _RacedQuiesce:
    """The engine's quiesce event whose first ``wait`` times out just as
    the loop sets it and exits: it returns False only after both."""

    def __init__(self, eng):
        self._ev, self._eng, self._raced = eng._quiesced, eng, False

    def set(self):
        self._ev.set()

    def is_set(self):
        return self._ev.is_set()

    def wait(self, timeout=None):
        if self._raced:
            return self._ev.wait(timeout)
        self._raced = True
        assert self._ev.wait(30), "the loop never quiesced"
        self._eng._thread.join(30)
        return False


def test_handoff_survives_a_quiesce_that_races_the_wait(gpt, ref):
    """A loop that quiesces and exits between ``handoff``'s wait timing out
    and its liveness check has handed off, not failed (the engine raised
    "engine failed before handoff quiesce" there, seen once on the card
    in a Llama-7B handoff)."""
    prompts = make_prompts(3, np.random.RandomState(33))
    want = ref(prompts, 8)
    old = Engine(gpt[1], **KW)
    try:
        hs = [old.submit(p, max_new_tokens=8) for p in prompts]
        _mid_decode(old)
        old._quiesced = _RacedQuiesce(old)
        snap = old.handoff()
        assert not old._thread.is_alive()
        with Engine(gpt[1], **KW) as new:
            assert new.adopt(snap)["mode"] == "reattach"
            outs = [h.result(timeout=60) for h in hs]
    finally:
        old.close()
    assert outs == want


def test_handoff_transfers_queue(gpt, ref):
    prompts = make_prompts(4, np.random.RandomState(31))
    want = ref(prompts, 8)
    kw = dict(KW, max_batch=1)
    old = Engine(gpt[1], **kw)
    try:
        hs = [old.submit(p, max_new_tokens=8) for p in prompts]
        _mid_decode(old)
        snap = old.handoff()
        assert snap["queue"], "nothing was queued at handoff time"
        with Engine(gpt[1], **kw) as new:
            info = new.adopt(snap)
            assert info["queued"] == len(snap["queue"])
            outs = [h.result(timeout=60) for h in hs]
    finally:
        old.close()
    assert outs == want


def test_handoff_prefix_chain_survives(gpt, ref):
    rng = np.random.RandomState(32)
    shared = rng.randint(0, 211, (40,)).tolist()
    prompts = [shared + rng.randint(0, 211, (5,)).tolist() for _ in range(6)]
    want = ref(prompts, 8)
    kw = dict(KW, num_blocks=128, prefix_cache=True)
    old = Engine(gpt[1], **kw)
    try:
        outs1 = [h.result(timeout=60) for h in
                 [old.submit(p, max_new_tokens=8) for p in prompts]]
        snap = old.handoff()
        with Engine(gpt[1], **kw) as new:
            new.adopt(snap)
            h0 = profiler.counters().get("serve_prefix_hits", 0)
            outs2 = [h.result(timeout=60) for h in
                     [new.submit(p, max_new_tokens=8) for p in prompts]]
            assert profiler.counters().get("serve_prefix_hits", 0) > h0
            st = new.stats()
            assert st["pages_used"] == st["pages_cached"] > 0
            new._pool.check()
        # a successor without an index releases the chain's references
        snap2 = Engine(gpt[1], **kw)
        try:
            [h.result(timeout=60) for h in
             [snap2.submit(p, max_new_tokens=8) for p in prompts]]
            captured = snap2.handoff()
        finally:
            snap2.close()
        with Engine(gpt[1], **dict(kw, prefix_cache=False)) as bare:
            bare.adopt(captured)
            assert bare.stats()["pages_cached"] == 0
            assert bare.stats()["pages_used"] == 0
            bare._pool.check()
    finally:
        old.close()
    assert outs1 == want and outs2 == want


def test_handoff_corrupt_snapshot_falls_back_to_reprefill(gpt, ref):
    prompts = make_prompts(4, np.random.RandomState(35))
    want = ref(prompts, 8)
    c0 = profiler.counters()
    old = Engine(gpt[1], **KW)
    try:
        hs = [old.submit(p, max_new_tokens=8) for p in prompts]
        _mid_decode(old)
        inject.arm("serve.snapshot_corrupt")
        snap = old.handoff()
        inject.disarm()
        with Engine(gpt[1], **KW) as new:
            info = new.adopt(snap)
            assert info["mode"] == "reprefill"
            assert "CRC" in info["reject_reason"]
            assert info["reprefill_tokens"] == sum(
                len(r["tokens"]) for r in snap["seqs"])
            outs = [h.result(timeout=60) for h in hs]
            assert new.health()["last_recovery"]["mode"] == "reprefill"
    finally:
        old.close()
    assert outs == want
    assert _delta(c0, "serve_snapshot_rejected") == 1


def test_kv_content_tamper_rejected(gpt, ref):
    prompts = make_prompts(3, np.random.RandomState(36))
    want = ref(prompts, 8)
    old = Engine(gpt[1], **KW)
    try:
        hs = [old.submit(p, max_new_tokens=8) for p in prompts]
        _mid_decode(old)
        snap = old.handoff()
        snap["kpool"] = torch.zeros_like(snap["kpool"])  # wrong KV bytes
        with Engine(gpt[1], **KW) as new:
            with pytest.raises(SnapshotError, match="fingerprint"):
                new.adopt(snap, fallback="raise")
            info = new.adopt(snap)  # the default: re-prefill, whole
            assert info["mode"] == "reprefill"
            outs = [h.result(timeout=60) for h in hs]
    finally:
        old.close()
    assert outs == want


def test_adopt_refuses_geometry_mismatch_and_traffic(gpt):
    rng = np.random.RandomState(37)
    old = Engine(gpt[1], **KW)
    try:
        old.submit(rng.randint(0, 211, (5,)).tolist(),
                   max_new_tokens=4).result(timeout=60)
        snap = old.handoff()
        with Engine(gpt[1], **dict(KW, num_blocks=32)) as other:
            with pytest.raises(SnapshotError, match="geometry"):
                other.adopt(snap, fallback="raise")
            assert other._compat_key()[-2:] == (0, "replicated")
        with Engine(gpt[1], **KW) as busy:
            busy.submit(rng.randint(0, 211, (4,)).tolist(),
                        max_new_tokens=2).result(timeout=60)
            with pytest.raises(ServeError, match="fresh"):
                busy.adopt(snap)
    finally:
        old.close()


def test_handoff_crash_before_quiesce_fails_whole(gpt):
    rng = np.random.RandomState(34)
    old = Engine(gpt[1], **KW)
    try:
        inject.arm("serve.crash:at=2")
        h = old.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=50)
        wait_for(lambda: inject.fired_counts().get("serve.crash"), 30,
                 "the crash never fired")
        with pytest.raises(ServeError):
            old.handoff(timeout=10.0)
        with pytest.raises(ServeError):
            h.result(timeout=10)  # failed, not stranded
    finally:
        old.close()


# ---------------------------------------------------- crash → re-attach
def _sup_run(sup_cls, model, spec, prompts, n, **kw):
    with chaos(spec):
        with sup_cls(model, watchdog_s=4.0, snapshot=True, **kw) as sup:
            hs = [sup.submit(p, max_new_tokens=n) for p in prompts]
            outs = [h.result(timeout=120) for h in hs]
            health = sup.health()
            assert sup.restarts == 1 and health["ok"] and sup.ready()
            wait_for(lambda: sup.stats()["pages_used"]
                     == sup.stats()["pages_cached"], 10, "no drain")
            return outs, health["last_recovery"], sup


def test_crash_reattach_matches_reference_record(gpt, ref):
    """The reference's acceptance pin, with a crash at a fixed decode step
    in both packages: zero tokens re-prefilled, the same recovery counts,
    outputs equal to an uninterrupted reference run."""
    prompts = make_prompts(6, np.random.RandomState(20))
    want = ref(prompts, 10)
    spec = FIRST_STEP_WAITS + ";serve.crash:step=4,times=1"
    keys = ("mode", "kind", "reattached", "blocks_reattached",
            "reprefill_tokens_saved", "requeued")
    jouts, jrec, _ = _sup_run(JSupervisor, gpt[0], spec, prompts, 10,
                              **ENGINE_KW)
    c0 = profiler.counters()
    outs, rec, _ = _sup_run(ServingSupervisor, gpt[1], spec, prompts, 10,
                            **KW)
    assert outs == want and jouts == want
    assert {k: rec[k] for k in keys} == {k: jrec[k] for k in keys}
    assert rec["mode"] == "reattach" and rec["reattached"] == 6
    assert rec["reprefill_tokens_saved"] == sum(len(p) + 5 for p in prompts)
    assert _delta(c0, "serve_reprefill_tokens") == 0
    assert _delta(c0, "serve_requeued") == 0
    assert _delta(c0, "serve_snapshots") == 1
    assert _delta(c0, "serve_restart_mttr_ms") > 0


def test_crash_reattach_with_prefix_cache_armed(gpt, ref):
    rng = np.random.RandomState(22)
    shared = rng.randint(0, 211, (40,)).tolist()
    prompts = [shared + rng.randint(0, 211, (int(rng.randint(3, 10)),))
               .tolist() for _ in range(8)]
    want = ref(prompts, 10)
    c0 = profiler.counters()
    spec = FIRST_STEP_WAITS + ";serve.crash:step=5,times=1"
    with chaos(spec):
        with ServingSupervisor(gpt[1], watchdog_s=4.0, snapshot=True,
                               prefix_cache=True,
                               **dict(KW, num_blocks=128)) as sup:
            outs = [h.result(timeout=120) for h in
                    [sup.submit(p, max_new_tokens=10) for p in prompts]]
            assert sup.health()["last_recovery"]["mode"] == "reattach"
            st = sup.stats()
            assert st["pages_used"] == st["pages_cached"] > 0
            with sup._lock:
                sup._engine._pool.check()
            h0 = profiler.counters().get("serve_prefix_hits", 0)
            outs2 = [h.result(timeout=120) for h in
                     [sup.submit(p, max_new_tokens=10) for p in prompts]]
            assert profiler.counters().get("serve_prefix_hits", 0) > h0
    assert outs == want and outs2 == want
    assert _delta(c0, "serve_reprefill_tokens") == 0


def test_crash_corrupt_snapshot_requeues_whole(gpt, ref):
    prompts = make_prompts(6, np.random.RandomState(23))
    want = ref(prompts, 10)
    c0 = profiler.counters()
    outs, rec, _ = _sup_run(
        ServingSupervisor, gpt[1],
        FIRST_STEP_WAITS + ";serve.crash:step=4,times=1;serve.snapshot_corrupt",
        prompts, 10, **KW)
    assert outs == want
    assert rec["mode"] == "reprefill" and rec["requeued"] == len(prompts)
    assert rec["blocks_reattached"] == 0
    assert _delta(c0, "serve_snapshot_rejected") == 1
    assert _delta(c0, "serve_reprefill_tokens") > 0


def test_streamed_request_reattaches_contiguously(gpt, ref):
    p = np.random.RandomState(25).randint(0, 211, (6,)).tolist()
    want = ref([p], 10)[0]
    c0 = profiler.counters()
    with chaos("serve.crash:at=5"):
        with ServingSupervisor(gpt[1], watchdog_s=4.0, snapshot=True,
                               **KW) as sup:
            got = list(sup.submit(p, max_new_tokens=10, stream=True))
            assert sup.restarts == 1
    assert p + got == want
    assert _delta(c0, "serve_relayed") == 0  # its own handle, no relay


def test_reattach_llama_gqa_matches_reference(llama):
    """Llama with grouped KV heads (KV = 2 of 4): the pools' geometry
    changes, the durability contract does not."""
    jm, tm = llama
    rng = np.random.RandomState(21)
    prompts = [rng.randint(0, 193, (int(rng.randint(3, 20)),)).tolist()
               for _ in range(6)]
    kw = dict(block_size=8, num_blocks=64, max_batch=8, max_seq_len=128)
    with JEngine(jm, **kw) as jeng:
        want = [h.result(timeout=300) for h in
                [jeng.submit(p, max_new_tokens=10) for p in prompts]]
    old = Engine(tm, **kw, device="cpu")
    try:
        with chaos(FIRST_STEP_WAITS):
            hs = [old.submit(p, max_new_tokens=10) for p in prompts]
            _mid_decode(old, 3)
            snap = old.handoff()
        assert snap["kpool"].shape[3] == 2
        with Engine(tm, **kw, device="cpu") as new:
            info = new.adopt(snap)
            assert info["mode"] == "reattach" and info["reattached"] == 6
            outs = [h.result(timeout=60) for h in hs]
    finally:
        old.close()
    assert outs == want


def test_wedge_never_snapshots(gpt):
    rng = np.random.RandomState(26)
    c0 = profiler.counters()
    with ServingSupervisor(gpt[1], watchdog_s=1.0, snapshot=True,
                           **KW) as sup:
        sup.generate(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=3)
        inject.arm("serve.wedge:at=2,ms=3000")
        h = sup.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=50)
        with pytest.raises(ServeError, match="wedged"):
            h.result(timeout=30)
        inject.disarm()
        assert sup.restarts == 1
        assert sup.health()["last_recovery"]["mode"] != "reattach"
        assert len(sup.generate(rng.randint(0, 211, (4,)).tolist(),
                                max_new_tokens=3)) == 7
    assert _delta(c0, "serve_snapshots") == 0


def test_unconfigured_path_never_touches_durability(gpt, monkeypatch):
    """Without the snapshot flag a supervised crash takes the requeue path
    and plain traffic never calls snapshot, restore, adopt or handoff."""
    def boom(*a, **k):
        raise AssertionError("durability code ran on the unconfigured path")

    for cls, name in ((P.PagePool, "snapshot"), (P.PagePool, "restore"),
                      (E.Engine, "snapshot"), (E.Engine, "adopt"),
                      (E.Engine, "handoff")):
        monkeypatch.setattr(cls, name, boom)
    prompts = make_prompts(4, np.random.RandomState(40))
    with Engine(gpt[1], **KW) as eng:
        base = [h.result(timeout=60) for h in
                [eng.submit(p, max_new_tokens=8) for p in prompts]]
    with chaos("serve.crash:at=3"):
        with ServingSupervisor(gpt[1], watchdog_s=4.0, **KW) as sup:
            outs = [h.result(timeout=120) for h in
                    [sup.submit(p, max_new_tokens=8) for p in prompts]]
            assert sup.restarts == 1
            assert sup.health()["last_recovery"]["mode"] == "reprefill"
    assert outs == base
