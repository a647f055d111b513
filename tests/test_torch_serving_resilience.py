"""Port parity: the resilience layer of ``paddle_tpu_torch``'s serving engine
(deadlines, priorities, load shedding, probes and drain, the out-of-memory
ladder, and ``ServingSupervisor``), against JAX.

Each case ports a case of the reference's ``tests/test_serving_resilience.py``
(or ``tests/test_memory_pressure.py`` for the ladder) and keeps its name. The
tiny GPT of ``serving_util`` is built in both packages with the same weights,
f32, greedy; where a case produces tokens they must equal the JAX engine's
for the same prompts. Chaos specs are armed in both packages' injection
modules at once (``torch_port_util.chaos``). Supervisors run with the
smallest watchdog the reference accepts (1 s), and every wait has its own
timeout. A supervised engine's ``serve.step`` unit records in the
distributed watchdog's progress table (replaced at a restart, removed at
``close``) are held against the reference's supervisor.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.fault import inject as jinject
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import inject, memory
from paddle_tpu_torch.serving import (DeadlineExceeded, Engine, EngineConfig,
                                      Overloaded, Readiness, ServeError,
                                      ServingSupervisor)
from paddle_tpu_torch.serving import engine as E
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import chaos, port_of, serve_flags, wait_for

KW = dict(ENGINE_KW, device="cpu")
REF_KW = dict(ENGINE_KW, num_blocks=256)


@pytest.fixture(scope="module")
def gpt():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def ref(gpt):
    """Greedy outputs of the JAX engine, one wave of prompts at a time."""
    eng = JEngine(gpt[0], **REF_KW)
    yield lambda prompts, n: [h.result(timeout=300) for h in
                              [eng.submit(p, max_new_tokens=n)
                               for p in prompts]]
    eng.close()


@pytest.fixture
def model(gpt):
    return gpt[1]


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jinject.disarm()


def _count(name):
    return profiler.counters().get(name, 0)


# ------------------------------------------------------------------ deadlines
def test_doomed_queued_request_rejected_at_admission(model):
    rng = np.random.RandomState(0)
    c0 = _count("serve_deadline_shed")
    with Engine(model, **KW) as eng:
        eng.generate(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=4)
        # an EMA of 1 s a step: 11 steps never fit a 0.5 s deadline
        eng._ema_step_s = 1.0
        h = eng.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=10,
                       deadline_s=0.5)
        with pytest.raises(DeadlineExceeded, match="doomed") as ei:
            h.result(timeout=30)
        assert ei.value.request_id == h.request_id
        assert eng.stats()["pages_used"] == 0
        assert len(eng.generate(rng.randint(0, 211, (4,)).tolist(),
                                max_new_tokens=3)) == 7
    assert _count("serve_deadline_shed") > c0


def test_running_request_expires_mid_decode(model):
    rng = np.random.RandomState(1)
    c0 = _count("serve_deadline_expired")
    inject.arm("serve.slow_step:from=1,ms=60")
    with Engine(model, **KW) as eng:
        t0 = time.monotonic()
        h = eng.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=100,
                       deadline_s=0.4)
        with pytest.raises(DeadlineExceeded, match="expired"):
            h.result(timeout=30)
        assert time.monotonic() - t0 < 4.0  # far from 100 steps of 60 ms
        assert eng.stats()["pages_used"] == 0
    assert _count("serve_deadline_expired") > c0


def test_deadline_validation(model):
    with Engine(model, **KW) as eng:
        with pytest.raises(ValueError, match="deadline_s"):
            eng.submit([1, 2], max_new_tokens=2, deadline_s=0.0)
    with pytest.raises(ValueError, match="max_queue"):
        Engine(model, **KW, max_queue=-1)
    with serve_flags(FLAGS_serve_max_queue=5, FLAGS_serve_shed=True):
        cfg = EngineConfig(**ENGINE_KW).resolve(128)
    assert (cfg.max_queue, cfg.shed) == (5, True)
    cfg = EngineConfig(**ENGINE_KW).resolve(128)
    assert (cfg.max_queue, cfg.shed) == (0, False)


def test_deadline_met_request_unaffected(model, ref):
    p = np.random.RandomState(2).randint(0, 211, (7,)).tolist()
    with Engine(model, **KW) as eng:
        plain = eng.generate(p, max_new_tokens=5)
        h = eng.submit(p, max_new_tokens=5, deadline_s=300.0)
        timed = h.result(timeout=60)
        assert 0.0 < h.latency_s < 60.0
    assert timed == plain == ref([p], 5)[0]


# ----------------------------------------------------------------- priorities
def test_eviction_is_priority_then_youngest(model, monkeypatch):
    rng = np.random.RandomState(3)
    evicted = []
    orig = E.Engine._evict

    def record(self, seq):
        evicted.append(seq.req.id)
        return orig(self, seq)

    monkeypatch.setattr(E.Engine, "_evict", record)
    with Engine(model, block_size=8, num_blocks=10, max_batch=4,
                max_seq_len=72, device="cpu") as eng:
        hi = eng.submit(rng.randint(0, 211, (8,)).tolist(), max_new_tokens=24,
                        priority=5)
        los = [eng.submit(rng.randint(0, 211, (8,)).tolist(),
                          max_new_tokens=24) for _ in range(3)]
        outs = [h.result(timeout=120) for h in [hi] + los]
    assert all(len(o) == 32 for o in outs)
    assert evicted, "pool pressure never forced an eviction"
    assert hi.request_id not in evicted
    # among equals the youngest goes first
    assert evicted[0] == max(h.request_id for h in los)


def test_admission_prefers_priority(model):
    rng = np.random.RandomState(4)
    with Engine(model, block_size=8, num_blocks=64, max_batch=1,
                max_seq_len=128, device="cpu") as eng:
        hog = eng.submit(rng.randint(0, 211, (4,)).tolist(),
                         max_new_tokens=60)
        lo = eng.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=3)
        hi = eng.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=3,
                        priority=9)
        hi.result(timeout=60)
        assert not lo.done  # hi jumped the queue
        assert eng._has_prio
        hog.result(timeout=60)
        lo.result(timeout=60)


# ------------------------------------------------------------- load shedding
def test_overload_fast_fails_with_retry_hint(model):
    rng = np.random.RandomState(5)
    c0 = _count("serve_shed")
    with Engine(model, block_size=8, num_blocks=64, max_batch=1,
                max_seq_len=128, max_queue=2, shed=True, device="cpu") as eng:
        hog = eng.submit(rng.randint(0, 211, (4,)).tolist(),
                         max_new_tokens=80)
        queued, shed = [], None
        t0 = time.monotonic()
        for _ in range(50):
            try:
                queued.append(eng.submit(rng.randint(0, 211, (4,)).tolist(),
                                         max_new_tokens=3))
            except Overloaded as e:
                shed = e
                break
        assert time.monotonic() - t0 < 5.0
        assert shed is not None and shed.retry_after_s > 0.0
        r = eng.ready()
        assert isinstance(r, Readiness) and not r
        assert r["reason"] == "queue_full"
        hog.result(timeout=60)
        for h in queued:
            h.result(timeout=60)
        wait_for(lambda: eng.stats()["pages_used"] == 0, 10, "no drain")
        assert eng.ready()
    assert _count("serve_shed") > c0


def test_unbounded_queue_without_shed_flag(model):
    rng = np.random.RandomState(6)
    with Engine(model, block_size=8, num_blocks=64, max_batch=1,
                max_seq_len=128, max_queue=2, device="cpu") as eng:
        hs = [eng.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=3)
              for _ in range(8)]
        for h in hs:
            h.result(timeout=60)


# -------------------------------------------------------------- wedged close
def test_close_timeout_on_wedged_thread_fails_handles(model):
    rng = np.random.RandomState(7)
    c0 = _count("serve_wedged_close")
    inject.arm("serve.wedge:at=1,ms=3000")
    eng = Engine(model, **KW)
    h = eng.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=50)
    wait_for(lambda: inject.fired_counts().get("serve.wedge"), 30,
             "the wedge never fired")
    t0 = time.monotonic()
    eng.close(timeout=0.5)
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(ServeError):
        h.result(timeout=5)
    assert not eng.health()["ok"]
    assert _count("serve_wedged_close") > c0
    # the bounded wedge wakes on a broken engine and exits without touching
    # its pool: the granted blocks stay as the wedge left them
    used = eng._pool.used_blocks
    eng._thread.join(timeout=10)
    assert not eng._thread.is_alive()
    assert eng._pool.used_blocks == used and not h._req.tokens


# ----------------------------------------------------------------- supervisor
def test_crash_mid_decode_restart_bit_identical(model, ref):
    prompts = make_prompts(6, np.random.RandomState(8))
    want = ref(prompts, 8)
    c0 = profiler.counters()
    with chaos("serve.crash:at=4"):
        with ServingSupervisor(model, watchdog_s=1.0, **KW) as sup:
            outs = [h.result(timeout=60) for h in
                    [sup.submit(p, max_new_tokens=8) for p in prompts]]
            assert sup.restarts == 1
            assert sup.health()["ok"] and sup.ready()
            assert sup.health()["last_recovery"]["mode"] == "reprefill"
    assert outs == want
    c1 = profiler.counters()
    for name in ("serve_crash_detected", "serve_restarts", "serve_requeued"):
        assert c1.get(name, 0) > c0.get(name, 0)


def test_crash_recovery_keeps_stream_contiguous(model, ref):
    p = np.random.RandomState(9).randint(0, 211, (6,)).tolist()
    want = ref([p], 10)[0]
    with chaos("serve.crash:at=5"):
        with ServingSupervisor(model, watchdog_s=1.0, **KW) as sup:
            got = list(sup.submit(p, max_new_tokens=10, stream=True))
            assert sup.restarts == 1
    assert p + got == want


def test_wedge_fails_inflight_structurally_and_restarts(model):
    rng = np.random.RandomState(10)
    c0 = _count("serve_wedge_detected")
    with ServingSupervisor(model, watchdog_s=1.0, **KW) as sup:
        sup.generate(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=3)
        inject.arm("serve.wedge:at=2,ms=3000")
        t0 = time.monotonic()
        h = sup.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=50)
        with pytest.raises(ServeError, match="wedged"):
            h.result(timeout=30)
        assert time.monotonic() - t0 < 1.0 + 2.0
        inject.disarm()
        assert sup.restarts == 1
        assert len(sup.generate(rng.randint(0, 211, (4,)).tolist(),
                                max_new_tokens=3)) == 7
    assert _count("serve_wedge_detected") > c0


def test_requeue_bypasses_shed_policy(model, ref):
    prompts = make_prompts(4, np.random.RandomState(18))
    want = ref(prompts, 10)
    kw = dict(KW, max_batch=2, max_queue=2, shed=True)
    with ServingSupervisor(model, watchdog_s=1.0, **kw) as sup:
        first = [sup.submit(p, max_new_tokens=10) for p in prompts[:2]]
        wait_for(lambda: not sup.stats()["queue_depth"], 30, "not admitted")
        rest = [sup.submit(p, max_new_tokens=10) for p in prompts[2:]]
        inject.arm("serve.crash:at=1")
        outs = [h.result(timeout=60) for h in first + rest]
        assert sup.restarts == 1
    assert outs == want


def test_max_restarts_exhaustion_breaks_supervisor(model):
    rng = np.random.RandomState(11)
    inject.arm("serve.crash:from=1")
    with ServingSupervisor(model, watchdog_s=1.0, max_restarts=1,
                           **KW) as sup:
        h = sup.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=20)
        with pytest.raises(ServeError):
            h.result(timeout=30)
        wait_for(lambda: not sup.health()["supervisor_ok"], 30,
                 "the supervisor never broke")
        assert not sup.ready() and sup.ready()["reason"] == "supervisor_broken"
        inject.disarm()
        with pytest.raises(ServeError, match="broken"):
            sup.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=2)


def test_supervisor_refuses_short_watchdog(model):
    with pytest.raises(ValueError, match="watchdog_s"):
        ServingSupervisor(model, watchdog_s=0.5, **KW)


# ------------------------------------------------------- health, ready, drain
def test_health_and_ready_probes(model):
    with Engine(model, **KW) as eng:
        h = eng.health()
        assert h["ok"] and h["thread_alive"] and h["broken"] is None
        assert h["beat_age_s"] < 30.0 and h["last_recovery"] == {"mode": "none"}
        r = eng.ready()
        assert r and r["reason"] is None
        assert eng.debug_requests() == []
    assert not eng.health()["ok"]
    assert not eng.ready() and eng.ready()["reason"] == "unhealthy"


def test_drain_completes_outstanding_then_stops(model, ref):
    prompts = make_prompts(5, np.random.RandomState(12))
    want = ref(prompts, 6)
    eng = Engine(model, **KW)
    hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    rows = eng.debug_requests()
    assert {r["id"] for r in rows} == {h.request_id for h in hs}
    eng.close(drain=True, timeout=60)
    assert [h.result(timeout=5) for h in hs] == want
    with pytest.raises(ServeError):
        eng.submit([1, 2], max_new_tokens=2)


def test_submit_during_drain_rejected(model):
    rng = np.random.RandomState(13)
    eng = Engine(model, **KW)
    hog = eng.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=60)
    closer = threading.Thread(target=lambda: eng.close(drain=True, timeout=60),
                              daemon=True)
    closer.start()
    wait_for(lambda: eng._draining, 10, "the drain never started")
    r = eng.ready()
    assert not r and r["reason"] == "draining"
    with pytest.raises(ServeError, match="draining"):
        eng.submit(rng.randint(0, 211, (4,)).tolist(), max_new_tokens=2)
    assert len(hog.result(timeout=60)) == 64
    closer.join(timeout=60)
    assert not closer.is_alive()


def test_supervisor_drain_close(model):
    rng = np.random.RandomState(14)
    sup = ServingSupervisor(model, watchdog_s=1.0, **KW)
    hs = [sup.submit(p, max_new_tokens=5) for p in make_prompts(3, rng)]
    sup.close(drain=True, timeout=60)
    for h in hs:
        assert len(h.result(timeout=5)) >= 6


# ------------------------------------------------------------ the OOM ladder
def test_serving_oom_shrinks_pool_and_completes(model, ref):
    """hbm.oom at the serving step parks free blocks and the step retries:
    nothing fails, the tokens are the reference's."""
    prompts = make_prompts(6, np.random.RandomState(15))
    want = ref(prompts, 8)
    c0 = profiler.counters()
    with chaos("hbm.oom:op=serve.step,at=3"):
        with Engine(model, **KW) as eng:
            outs = [h.result(timeout=60) for h in
                    [eng.submit(p, max_new_tokens=8) for p in prompts]]
            assert eng.stats()["pages_parked"] > 0
            eng._pool.check()
    assert outs == want
    c1 = profiler.counters()
    assert c1["serve_pool_shrunk"] > c0.get("serve_pool_shrunk", 0)
    assert c1["hbm_oom_trips"] == c0.get("hbm_oom_trips", 0) + 1
    assert memory.recent_ooms()[-1]["where"] == "serve.step"


def test_request_pool_shrink_and_unpark_decay(model, monkeypatch):
    monkeypatch.setattr(E.Engine, "_UNPARK_AFTER", 2)
    rng = np.random.RandomState(16)
    with Engine(model, **KW) as eng:
        info = memory.free_pressure("test")["handlers"][eng._provider]
        assert info["requested_blocks"] == "free/4"
        eng.request_pool_shrink(10)
        h = eng.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=20)
        wait_for(lambda: eng.stats()["pages_parked"] > 0, 10, "never parked")
        assert len(h.result(timeout=60)) == 25
        # clean steps return the parked blocks half at a time
        assert eng.stats()["pages_parked"] < 10 + 63 // 4
        eng._pool.check()
    assert eng._provider not in memory.free_pressure("test")["handlers"]


def test_oom_streak_falls_through_to_crash_containment(model):
    rng = np.random.RandomState(17)
    with chaos("hbm.oom:op=serve.step,from=1"):
        with Engine(model, **KW) as eng:
            h = eng.submit(rng.randint(0, 211, (5,)).tolist(),
                           max_new_tokens=8)
            with pytest.raises(ServeError):
                h.result(timeout=30)
            assert memory.is_oom(eng._broken)
            assert eng._oom_streak == 9


# ------------------------------------------------------------------- stress
def test_concurrent_submits_shrinks_and_cancels_keep_the_pool(model, ref):
    """More client threads than cores submit with priorities while another
    thread keeps asking for pool shrinks and cancels some requests, under a
    short switch interval: every request ends (tokens or cancelled), the
    greedy ones that finished carry the reference's tokens, and the pool's
    conservation holds with nothing left in use."""
    import os
    import sys

    prompts = make_prompts(24, np.random.RandomState(19))
    want = dict(enumerate(ref(prompts, 6)))
    results, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Engine(model, **KW) as eng:
            def client(i):
                try:
                    for j in range(i, len(prompts), n_threads):
                        h = eng.submit(prompts[j], max_new_tokens=6,
                                       priority=j % 3)
                        if j % 7 == 0:
                            h.cancel()
                        try:
                            results[j] = h.result(timeout=60)
                        except E.RequestCancelled:
                            results[j] = None
                except Exception as e:  # reported by the assertion below
                    errors.append(e)

            def shrinker():
                for _ in range(20):
                    eng.request_pool_shrink(2)
                    time.sleep(0.002)

            n_threads = 2 * (os.cpu_count() or 2) + 1
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)] \
                + [threading.Thread(target=shrinker)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            wait_for(lambda: eng.stats()["pages_used"] == 0, 10, "no drain")
            eng._pool.check()
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(results) == len(prompts)
    for j, out in results.items():
        assert out is None and j % 7 == 0 or out == want[j]


# ------------------------------------------------------------ inert tripwire
def test_unconfigured_path_adds_zero_threads_and_zero_sweeps(model,
                                                              monkeypatch):
    def boom(*a, **k):
        raise AssertionError("resilience code ran on the unconfigured path")

    for name in ("_shed_sweep", "snapshot", "_chaos_step", "adopt",
                 "handoff", "_on_oom"):
        monkeypatch.setattr(E.Engine, name, boom)
    rng = np.random.RandomState(15)
    before = {t.ident for t in threading.enumerate()}
    with Engine(model, **KW) as eng:
        [h.result(timeout=60) for h in
         [eng.submit(p, max_new_tokens=5) for p in make_prompts(4, rng)]]
        new = [t for t in threading.enumerate() if t.ident not in before]
        assert [t.name for t in new] == [eng._provider]
        assert eng._deadline_seen is False and eng._has_prio is False
        assert eng._supervised is False and not inject.armed()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_supervised_engine_publishes_serve_step_units_removed_on_close(
        gpt, pkg, tmp_path):
    """A supervised engine's scheduler publishes ``serve.step`` unit
    records into this rank's watchdog progress entry (beside the rank's
    own record), a restart replaces the dead engine's unit, and ``close``
    removes it: the same in both packages."""
    import json as _json

    if pkg == "port":
        from paddle_tpu_torch.distributed import watchdog as wd
        from paddle_tpu_torch.serving import ServingSupervisor as Sup
        model, kw, arm = gpt[1], KW, inject
    else:
        from paddle_tpu.distributed import watchdog as wd
        from paddle_tpu.serving import ServingSupervisor as Sup
        model, kw, arm = gpt[0], REF_KW, jinject
    wd.reset()
    wd.configure(rank=0, world_size=1, store=None, progress_dir=str(tmp_path))
    wd.publish(step=5, phase="train_step", force=True)
    rec_path = tmp_path / "rank_0.json"

    def units():
        wd.publish(force=True)  # write the current record through
        return _json.loads(rec_path.read_text()).get("units", {})

    try:
        prompt = np.random.RandomState(3).randint(0, 211, (5,)).tolist()
        with Sup(model, watchdog_s=1.0, **kw) as sup:
            sup.generate(prompt, max_new_tokens=3)
            first = units()
            assert len(first) == 1
            (name, rec), = first.items()
            assert rec["phase"] == "serve.step" and rec["step"] > 0
            arm.arm("serve.crash:at=1")
            sup.generate(prompt, max_new_tokens=3)
            assert sup.restarts == 1
            arm.disarm()
            wait_for(lambda: len(units()) == 1 and name not in units(), 30,
                     "the restarted engine's unit")
        assert units() == {}
        rec = _json.loads(rec_path.read_text())
        assert (rec["step"], rec["phase"]) == (5, "train_step")
    finally:
        wd.reset()
