"""Port parity: serving SLO observability in ``paddle_tpu_torch``
(``serving/observe.py``, the engine's and the supervisor's hooks, the
telemetry endpoint, the flight post-mortems), against JAX.

Parity with the reference: ``Histogram``, the SLO layer and ``percentile``
over one seeded stream of values, equal to the reference's dicts and floats
exactly; ``drift``/``drift_value`` to 1e-12; ``prometheus_text`` for the same
counters, gauges and histograms, line for line; and one traced 4-request
wave through both engines (the tiny GPT of ``serving_util`` with the same
weights, the wave queued before the first admission by
``serve.slow_step:at=1``), where each request's timeline event names, the
TTFT, gap, end-to-end and queue-wait histogram counts and the set of
``/metrics`` families the serving layer adds are equal. Times differ and are
not compared; the counter families are not either (each package counts what
it runs).

The rest ports the assertions of the reference's
``tests/test_serving_observe.py`` to the port: one timeline per request with
exact histogram counts, trace continuity across preemption, supervisor
crash recovery, snapshot re-attach, handoff and chunked prefill, the
endpoint's routes, the step-time drift gauge, the flight post-mortems of a
crash and of an exhaustion, and the inert tripwire (a trace-off engine never
calls into ``serving.observe``).
"""
import json
import re
import socket
import threading
import time

import numpy as np
import pytest

from paddle_tpu import profiler as jprofiler
from paddle_tpu.fault import inject as jinject
from paddle_tpu.profiler import export as jexport
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import observe as jobserve
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.fault import memory as fmem
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.profiler import export as texport
from paddle_tpu_torch.profiler import flight
from paddle_tpu_torch.serving import Engine, ServingSupervisor, observe
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import chaos, port_of, wait_for

KW = dict(ENGINE_KW, device="cpu")
TRACED = dict(KW, trace=True)
FIRST_STEP_WAITS = "serve.slow_step:at=1,ms=200"
METRICS = ("serve_ttft_seconds", "serve_inter_token_seconds",
           "serve_e2e_seconds", "serve_queue_seconds")


@pytest.fixture(scope="module")
def gpt():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


@pytest.fixture
def model(gpt):
    return gpt[1]


@pytest.fixture(autouse=True)
def _clean():
    observe.reset()
    jobserve.reset()
    yield
    inject.disarm()
    jinject.disarm()
    observe.reset()
    jobserve.reset()


def _drive(eng, prompts, max_new=4, **kw):
    hs = [eng.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    return [h.result(timeout=120) for h in hs]


def _get(port, path):
    from urllib.error import HTTPError
    from urllib.request import urlopen

    try:
        with urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


def _names(tl):
    return [ev["name"] for ev in tl["events"]]


def _total(snap, metric):
    return sum(s["count"] for s in snap.get(metric, {}).values())


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- parity: histograms, percentile, drift, Prometheus text -------------------

def test_buckets_and_metric_table_match_reference():
    assert observe.LATENCY_BUCKETS == jobserve.LATENCY_BUCKETS
    assert observe.GAP_BUCKETS == jobserve.GAP_BUCKETS
    assert observe.SLO_METRICS == jobserve.SLO_METRICS


def _stream(seed=0, n=400):
    rng = np.random.RandomState(seed)
    vals = np.concatenate([rng.lognormal(-5.0, 2.0, n), [0.0, 0.001, 30.0,
                                                          31.0, 1e-5]])
    prio = rng.randint(0, 3, vals.size)
    return [float(v) for v in vals], [int(p) for p in prio]


@pytest.mark.parametrize("buckets", ["LATENCY_BUCKETS", "GAP_BUCKETS"])
def test_histogram_matches_reference(buckets):
    vals, _ = _stream(1)
    mine = observe.Histogram(getattr(observe, buckets))
    ref = jobserve.Histogram(getattr(jobserve, buckets))
    for v in vals:
        mine.observe(v)
        ref.observe(v)
    assert mine.snapshot() == ref.snapshot()


def test_slo_snapshot_and_percentile_match_reference():
    vals, prio = _stream(2)
    for i, (v, p) in enumerate(zip(vals, prio)):
        metric = METRICS[i % len(METRICS)]
        observe.slo().observe(metric, p, v)
        jobserve.slo().observe(metric, p, v)
    assert observe.slo().snapshot() == jobserve.slo().snapshot()
    for metric in METRICS:
        for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
            for p in (None, 0, 1, 2, 7):
                assert observe.percentile(metric, q, priority=p) \
                    == jobserve.percentile(metric, q, priority=p)


def test_drift_math_matches_reference():
    rng = np.random.RandomState(3)
    for name in ("step_eta", "hbm_admission"):
        for pred, act in rng.uniform(1e-4, 0.05, (20, 2)):
            a = observe.drift(name, float(pred), float(act))
            b = jobserve.drift(name, float(pred), float(act))
            assert abs(a - b) <= 1e-12
    for rel in rng.uniform(0.0, 1.0, 10):
        assert abs(observe.drift_value("kernel_estimate", float(rel),
                                       pairs=3)
                   - jobserve.drift_value("kernel_estimate", float(rel),
                                          pairs=3)) <= 1e-12
    mine, ref = observe.drift_gauges(), jobserve.drift_gauges()
    assert set(mine) == set(ref)
    for k in mine:
        assert set(mine[k]) == set(ref[k])
        for f in mine[k]:
            assert abs(mine[k][f] - ref[k][f]) <= 1e-12


def test_drift_math():
    rel = observe.drift("x", 10.0, 5.0)
    assert rel == 1.0
    g = observe.drift_gauges()["x"]
    assert g["rel_err"] == 1.0 and g["samples"] == 1
    observe.drift("x", 5.0, 5.0)  # EMA: 0.8 * 1.0 + 0.2 * 0.0
    g = observe.drift_gauges()["x"]
    assert abs(g["rel_err"] - 0.8) < 1e-9
    assert g["samples"] == 2 and g["last_rel_err"] == 0.0


def test_prometheus_text_matches_reference(monkeypatch):
    """The same counters, memory gauges, SLO histograms and drift gauges in
    both packages give the same exposition, line for line."""
    counters = {"serve_requests": 40, "serve_shed": 3,
                "serve_deadline_shed": 2, "serve_deadline_expired": 1,
                "serve_tokens": 977, "flight_dumps": 1}
    mem = {"live_bytes": 1 << 20, "live_arrays": 12,
           "peak_live_bytes": 3 << 20, "last_delta_bytes": -4096,
           "censuses": 5}
    for mod, exp, obs in ((profiler, texport, observe),
                          (jprofiler, jexport, jobserve)):
        monkeypatch.setattr(mod, "counters", lambda: dict(counters))
        monkeypatch.setattr(mod, "memory_stats", lambda: dict(mem))
        monkeypatch.setattr(exp, "_metric_providers",
                            {"serving": obs._provider})
    vals, prio = _stream(4, 120)
    for i, (v, p) in enumerate(zip(vals, prio)):
        for obs in (observe, jobserve):
            obs.slo().observe(METRICS[i % len(METRICS)], p, v)
    for obs in (observe, jobserve):
        obs.drift("step_eta", 0.010, 0.008)
        obs.drift("step_eta", 0.009, 0.012)
    mine = texport.prometheus_text()
    ref = jexport.prometheus_text()
    assert mine.splitlines() == ref.splitlines()
    assert 'paddle_tpu_serve_ttft_seconds_bucket{priority="0",le="+Inf"}' \
        in mine


# -- parity: one traced wave through both engines -----------------------------

def _families(text):
    return {line.split()[2]: line.split()[3] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def _wave(eng, prompts, max_new):
    outs = _drive(eng, prompts, max_new=max_new)
    return outs


def test_traced_wave_matches_reference(gpt):
    jm, tm = gpt
    rng = np.random.RandomState(5)
    prompts = make_prompts(4, rng)
    max_new = 6
    with chaos(FIRST_STEP_WAITS):
        with JEngine(jm, **ENGINE_KW, trace=True) as eng:
            ref_outs = _wave(eng, prompts, max_new)
        ref_book = jobserve.trace_book()
        ref_done = sorted(ref_book.completed(), key=lambda t: t["req_id"])
        ref_snap = jobserve.slo().snapshot()
        ref_fams = _families(jprofiler.export_metrics(format="prometheus"))
        with Engine(tm, **TRACED) as eng:
            outs = _wave(eng, prompts, max_new)
    assert outs == ref_outs
    book = observe.trace_book()
    done = sorted(book.completed(), key=lambda t: t["req_id"])
    assert book.open_traces() == {} and ref_book.open_traces() == {}
    assert [t["req_id"] for t in done] == [t["req_id"] for t in ref_done] \
        == [1, 2, 3, 4]
    for mine, ref in zip(done, ref_done):
        assert _names(mine) == _names(ref), mine["req_id"]
        assert mine["outcome"] == ref["outcome"] == "ok"
        assert mine["prompt_len"] == ref["prompt_len"]
    snap = observe.slo().snapshot()
    for metric in METRICS:
        assert _total(snap, metric) == _total(ref_snap, metric)
        assert {p: s["count"] for p, s in snap[metric].items()} \
            == {p: s["count"] for p, s in ref_snap[metric].items()}
    assert _total(snap, "serve_inter_token_seconds") == 4 * (max_new - 1)
    fams = _families(profiler.export_metrics(format="prometheus"))
    # the families the serving layer and the memory gauges add; each
    # package's counters are its own
    assert {k: v for k, v in fams.items() if v != "counter"} \
        == {k: v for k, v in ref_fams.items() if v != "counter"}
    assert "paddle_tpu_serve_e2e_latency" in fams


# -- timelines and exact histogram counts ---------------------------------------

def test_multi_stream_drive_one_timeline_per_request(model, tmp_path):
    rng = np.random.RandomState(40)
    prompts = make_prompts(16, rng)
    max_new = 4
    with Engine(model, **TRACED) as eng:
        outs = _drive(eng, prompts, max_new=max_new)
    assert all(len(o) == len(p) + max_new for o, p in zip(outs, prompts))
    book = observe.trace_book()
    done = book.completed()
    assert len(done) == 16
    assert len({tl["trace"] for tl in done}) == 16
    assert book.open_traces() == {}
    for tl in done:
        names = _names(tl)
        assert tl["outcome"] == "ok"
        assert names[0] == "queue" and "prefill" in names
        assert "decode_step" in names
        assert names.index("prefill") < names.index("decode_step")
        assert tl["t_close"] >= tl["t_open"]
    snap = observe.slo().snapshot()
    assert _total(snap, "serve_ttft_seconds") == 16
    assert _total(snap, "serve_e2e_seconds") == 16
    assert _total(snap, "serve_queue_seconds") == 16
    assert _total(snap, "serve_inter_token_seconds") == 16 * (max_new - 1)
    ct, jl = tmp_path / "trace.json", tmp_path / "trace.jsonl"
    book.chrome_trace(str(ct))
    book.jsonl(str(jl))
    doc = json.loads(ct.read_text())
    assert len([e for e in doc["traceEvents"] if e["ph"] == "M"]) == 16
    lines = [json.loads(ln) for ln in jl.read_text().splitlines()]
    assert {ln["trace"] for ln in lines} == {tl["trace"] for tl in done}


def test_priority_classes_key_histograms(model):
    rng = np.random.RandomState(41)
    prompts = make_prompts(8, rng)
    with Engine(model, **TRACED) as eng:
        for h in [eng.submit(p, max_new_tokens=3, priority=i % 2)
                  for i, p in enumerate(prompts)]:
            h.result(timeout=120)
    snap = observe.slo().snapshot()["serve_ttft_seconds"]
    assert set(snap) == {"0", "1"}
    assert snap["0"]["count"] == 4 and snap["1"]["count"] == 4
    assert observe.percentile("serve_ttft_seconds", 0.5) > 0.0
    assert observe.percentile("serve_ttft_seconds", 0.5, priority=1) > 0.0


def test_histogram_bucket_semantics():
    h = observe.Histogram((0.1, 1.0))
    for v in (0.05, 0.1, 0.5, 5.0):
        h.observe(v)
    s = h.snapshot()
    assert s["counts"] == [2, 1, 1] and s["cumulative"] == [2, 3, 4]
    assert s["count"] == 4 and abs(s["sum"] - 5.65) < 1e-9
    assert observe.percentile("serve_ttft_seconds", 0.99) == 0.0


def test_trace_ring_evicts_oldest(model):
    old = flags.get_flags("FLAGS_serve_trace_ring")
    flags.set_flags({"FLAGS_serve_trace_ring": 3})
    c0 = profiler.counters().get("serve_trace_evicted", 0)
    try:
        observe.reset()
        with Engine(model, **TRACED) as eng:
            _drive(eng, make_prompts(5, np.random.RandomState(7)),
                   max_new=2)
    finally:
        flags.set_flags(old)
    assert len(observe.trace_book().completed()) == 3
    assert profiler.counters()["serve_trace_evicted"] == c0 + 2


# -- trace continuity across the hard paths --------------------------------------

def test_preemption_reprefill_stays_one_timeline(model):
    rng = np.random.RandomState(42)
    prompts = [rng.randint(0, 211, (8,)).tolist() for _ in range(4)]
    with Engine(model, trace=True, block_size=8, num_blocks=10, max_batch=4,
                max_seq_len=72, device="cpu") as eng:
        outs = _drive(eng, prompts, max_new=24)
    assert all(len(o) == 32 for o in outs)
    done = observe.trace_book().completed()
    assert len(done) == 4 and len({tl["trace"] for tl in done}) == 4
    assert observe.trace_book().open_traces() == {}
    evicted = [tl for tl in done if "evict" in _names(tl)]
    assert evicted, "the geometry must force an eviction"
    for tl in evicted:
        assert _names(tl).count("prefill") >= 2


@pytest.mark.parametrize("snapshot", [False, True])
def test_crash_recovery_trace_continuity(model, snapshot):
    rng = np.random.RandomState(43)
    prompts = make_prompts(6, rng)
    with Engine(model, **KW) as eng:
        baseline = _drive(eng, prompts, max_new=8)
    observe.reset()
    inject.arm("serve.crash:at=4")
    with ServingSupervisor(model, watchdog_s=4.0, snapshot=snapshot,
                           **TRACED) as sup:
        outs = _drive(sup, prompts, max_new=8)
        assert sup.restarts == 1
        mode = sup.health()["last_recovery"]["mode"]
    assert outs == baseline
    done = observe.trace_book().completed()
    assert len(done) == 6 and len({tl["trace"] for tl in done}) == 6
    assert observe.trace_book().open_traces() == {}
    assert all(tl["outcome"] == "ok" for tl in done)
    relayed = [tl for tl in done if "relay" in _names(tl)]
    if snapshot:
        assert mode == "reattach" and not relayed
    else:
        assert relayed, "a requeue recovery stamps relay events"
        for tl in relayed:
            ev = [e for e in tl["events"] if e["name"] == "relay"][-1]
            assert ev["attrs"]["error"] is None


def test_handoff_trace_continuity(model):
    rng = np.random.RandomState(45)
    prompts = make_prompts(6, rng)
    old = Engine(model, **TRACED)
    try:
        hs = [old.submit(p, max_new_tokens=10) for p in prompts]
        wait_for(lambda: old.stats()["decode_steps"] >= 2, 30,
                 "two decode steps")
        snap = old.handoff()
        with Engine(model, **TRACED) as new:
            assert new.adopt(snap)["mode"] == "reattach"
            outs = [h.result(timeout=120) for h in hs]
    finally:
        old.close()
    assert all(len(o) == len(p) + 10 for o, p in zip(outs, prompts))
    done = observe.trace_book().completed()
    assert len(done) == 6 and len({tl["trace"] for tl in done}) == 6
    assert observe.trace_book().open_traces() == {}
    assert all(tl["outcome"] == "ok" for tl in done)


def test_chunked_prefill_single_timeline(model):
    rng = np.random.RandomState(46)
    prompts = [rng.randint(0, 211, (n,)).tolist() for n in (40, 61)]
    c0 = profiler.counters().get("serve_prefill_chunks", 0)
    with Engine(model, prefill_chunk=8, **TRACED) as eng:
        outs = _drive(eng, prompts, max_new=4)
    assert all(len(o) == len(p) + 4 for o, p in zip(outs, prompts))
    assert profiler.counters().get("serve_prefill_chunks", 0) > c0
    done = observe.trace_book().completed()
    assert len(done) == 2 and len({tl["trace"] for tl in done}) == 2
    long_tl = next(tl for tl in done if tl["prompt_len"] == 61)
    chunks = [e for e in long_tl["events"]
              if e["name"] == "prefill" and e["attrs"].get("chunked")]
    assert len(chunks) >= 2


def test_prefix_match_lands_on_the_timeline(model):
    rng = np.random.RandomState(47)
    head = rng.randint(0, 211, (32,)).tolist()
    with Engine(model, prefix_cache=True, **TRACED) as eng:
        _drive(eng, [head + [1, 2, 3]], max_new=2)
        _drive(eng, [head + [4, 5, 6]], max_new=2)
    second = max(observe.trace_book().completed(), key=lambda t: t["req_id"])
    ev = [e for e in second["events"] if e["name"] == "prefix_match"]
    assert len(ev) == 1 and ev[0]["attrs"] == {"tokens": 32, "blocks": 4}


# -- the telemetry endpoint -----------------------------------------------------

_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? "
    r"(NaN|[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?)$")
_BUCKET = re.compile(r'^(paddle_tpu_serve_\w+_seconds)_bucket'
                     r'\{priority="(\d+)",le="([^"]+)"\} (\d+)$')


def test_metrics_is_valid_prometheus(model):
    rng = np.random.RandomState(48)
    with Engine(model, **TRACED) as eng:
        _drive(eng, make_prompts(8, rng), max_new=3)
        ep = observe.start_endpoint(eng, 0)  # port 0: an ephemeral bind
        try:
            code, body = _get(ep.port, "/metrics")
        finally:
            ep.close()
    assert code == 200
    lines = [ln for ln in body.splitlines() if ln]
    for ln in lines:
        if not ln.startswith("#"):
            assert _SAMPLE.match(ln), f"invalid exposition line: {ln!r}"
    last = {}
    for ln in lines:
        m = _BUCKET.match(ln)
        if m:
            key, le, v = (m.group(1), m.group(2)), m.group(3), int(m.group(4))
            assert v >= last.get(key, (0, None))[0], ln
            last[key] = (v, le)
    assert {k[0] for k in last} == {"paddle_tpu_" + m for m in METRICS}
    assert all(le == "+Inf" for _, le in last.values())
    counts = {(m.group(1), m.group(2)): int(m.group(3)) for m in re.finditer(
        r'(paddle_tpu_serve_\w+_seconds)_count\{priority="(\d+)"\} (\d+)',
        body)}
    assert counts == {k: v for k, (v, _) in last.items()}
    assert counts[("paddle_tpu_serve_ttft_seconds", "0")] == 8
    assert "# TYPE paddle_tpu_serve_e2e_latency summary" in body
    assert "paddle_tpu_serve_shed_rate" in body


def test_healthz_flips_on_injected_wedge(model):
    rng = np.random.RandomState(49)
    old = flags.get_flags("FLAGS_serve_watchdog_s")
    flags.set_flags({"FLAGS_serve_watchdog_s": 2.0})
    eng = Engine(model, **KW)
    ep = observe.start_endpoint(eng, 0)
    try:
        eng.generate(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=3)
        code, body = _get(ep.port, "/healthz")
        assert code == 200 and json.loads(body)["ok"]
        code, body = _get(ep.port, "/readyz")
        assert code == 200 and json.loads(body)["ready"]
        inject.arm("serve.wedge:at=1,ms=8000")
        eng.submit(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=20)
        wait_for(lambda: not eng.health()["ok"], 30, "a stale heartbeat")
        code, body = _get(ep.port, "/healthz")
        assert code == 503 and json.loads(body)["stale"]
        code, body = _get(ep.port, "/readyz")
        assert code == 503 and json.loads(body)["reason"] == "unhealthy"
    finally:
        flags.set_flags(old)
        ep.close()
        eng.close(timeout=0.5)


def test_readyz_flips_on_close(model):
    eng = Engine(model, **KW)
    ep = observe.start_endpoint(eng, 0)
    try:
        assert _get(ep.port, "/readyz")[0] == 200
        eng.close(drain=True)
        code, body = _get(ep.port, "/readyz")
        assert code == 503 and not json.loads(body)["ready"]
    finally:
        ep.close()
        eng.close()


def test_debug_requests_shows_live_traces(model):
    rng = np.random.RandomState(50)
    prompts = make_prompts(8, rng)
    with Engine(model, **TRACED) as eng:
        ep = observe.start_endpoint(eng, 0)
        try:
            inject.arm("serve.slow_step:at=1,ms=300")
            hs = [eng.submit(p, max_new_tokens=32) for p in prompts]
            code, body = _get(ep.port, "/debug/requests")
            assert code == 200
            rows = json.loads(body)
            assert rows, "no in-flight rows observed"
            for row in rows:
                assert row["phase"] in ("queued", "prefilling",
                                        "chunk_prefill", "running",
                                        "preempted")
                assert row["trace"]
            for h in hs:
                h.result(timeout=120)
            assert _get(ep.port, "/nope")[0] == 404
        finally:
            ep.close()


def test_bind_failure_is_counter_not_crash():
    class _T:
        pass

    c0 = profiler.counters().get("serve_http_bind_failed", 0)
    blocker = socket.socket()
    try:
        blocker.bind(("", 0))
        blocker.listen(1)
        assert observe.start_endpoint(_T(), blocker.getsockname()[1]) is None
    finally:
        blocker.close()
    assert profiler.counters().get("serve_http_bind_failed", 0) == c0 + 1


def test_supervisor_owns_port_across_restart(model):
    rng = np.random.RandomState(51)
    port = _free_port()
    inject.arm("serve.crash:at=4")
    with ServingSupervisor(model, watchdog_s=4.0, metrics_port=port,
                           **TRACED) as sup:
        assert sup._endpoint is not None and sup._engine._endpoint is None
        assert sup._engine.config.metrics_port == 0
        assert _get(port, "/healthz")[0] == 200
        _drive(sup, make_prompts(4, rng), max_new=8)
        assert sup.restarts == 1
        code, body = _get(port, "/healthz")  # the same port, a new engine
        assert code == 200
        h = json.loads(body)
        assert h["ok"] and h["uptime_s"] < h["supervisor_uptime_s"]
    assert sup._endpoint is None


def test_engine_config_endpoint_lifecycle(model):
    port = _free_port()
    eng = Engine(model, metrics_port=port, **KW)
    try:
        assert eng._endpoint is not None
        assert _get(port, "/healthz")[0] == 200
    finally:
        eng.close()
    assert eng._endpoint is None
    assert not any(t.name == "serve-metrics" for t in threading.enumerate())
    with pytest.raises(ValueError, match="metrics_port"):
        Engine(model, metrics_port=-1, **KW)


# -- drift ----------------------------------------------------------------------

def test_step_eta_drift_from_warm_decode(model):
    rng = np.random.RandomState(52)
    with Engine(model, **TRACED) as eng:
        eng.generate(rng.randint(0, 211, (5,)).tolist(), max_new_tokens=8)
        eng.generate(rng.randint(0, 211, (6,)).tolist(), max_new_tokens=8)
    g = observe.drift_gauges()["step_eta"]
    assert g["samples"] >= 1 and np.isfinite(g["rel_err"])
    assert g["rel_err"] >= 0.0 and g["actual"] > 0.0
    steps = [sp for sp in flight.recent_spans() if sp.name == "decode_step"
             and "cost_drift" in sp.attrs]
    assert steps and all(sp.attrs["cost_drift"] >= 0.0 for sp in steps)
    text = profiler.export_metrics(format="prometheus")
    assert 'paddle_tpu_cost_drift{model="step_eta"}' in text


# -- flight post-mortems ----------------------------------------------------------

def _dumps(tmp_path, reason):
    return [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())
            if p.name.endswith(f"_{reason}.json")]


def test_crash_dumps_carry_engine_and_supervisor_context(model, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    rng = np.random.RandomState(53)
    prompts = make_prompts(4, rng)
    inject.arm(FIRST_STEP_WAITS + ";serve.crash:step=3,times=1")
    with ServingSupervisor(model, watchdog_s=4.0, **KW) as sup:
        outs = _drive(sup, prompts, max_new=8)
        assert sup.restarts == 1
    assert all(len(o) == len(p) + 8 for o, p in zip(outs, prompts))
    loop, = _dumps(tmp_path, "serving_loop_error")
    sup_dump, = _dumps(tmp_path, "serving_supervisor_crash")
    for doc in (loop, sup_dump):
        eng_ctx = [v for k, v in doc["context"].items()
                   if k.startswith("paddle_tpu_torch_serving_")
                   and "supervisor" not in k]
        sup_ctx = [v for k, v in doc["context"].items()
                   if k.startswith("paddle_tpu_torch_serving_supervisor_")]
        assert len(sup_ctx) == 1 and sup_ctx[0]["max_restarts"] == 3
        rows = [c for c in eng_ctx if c.get("step") == 3]
        assert rows and len(rows[0]["running"]) == 4
        last = [s for s in doc["recent_spans"] if s["name"] == "decode_step"]
        assert last[-1]["attrs"]["step"] == 2 and last[-1]["attrs"]["rows"] == 4
        assert doc["fault_inject"]["armed"]
    assert "injected serve.crash" in loop["extra"]["exception"]
    assert sup_dump["extra"]["restarts"] == 1


def test_oom_post_mortem_carries_the_census(model, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    rng = np.random.RandomState(54)
    c0 = profiler.counters().get("hbm_oom_trips", 0)
    inject.arm("hbm.oom:op=serve.step,at=2")
    with Engine(model, **KW) as eng:
        outs = _drive(eng, make_prompts(3, rng), max_new=4)
    assert all(len(o) > 4 for o in outs)
    assert profiler.counters()["hbm_oom_trips"] == c0 + 1
    ev = fmem.recent_ooms()[-1]
    path = fmem.post_mortem(ev["where"], [{"action": "park"}],
                            RuntimeError(ev["message"]))
    doc = json.loads(open(path).read())
    assert doc["reason"] == "hbm_exhausted"
    assert doc["extra"]["where"] == "serve.step"
    assert doc["extra"]["census"]["device"] == "cpu"
    assert "live_bytes" in doc["extra"]["census"]
    assert doc["context"]["hbm"]["recent_oom"][-1]["where"] == "serve.step"


# -- inert when unconfigured -----------------------------------------------------

def test_flag_off_engine_never_touches_observe(model, monkeypatch):
    def _explode(*a, **k):
        raise AssertionError("observe hook reached with tracing off")

    for name in ("on_submit", "on_admit", "on_shed", "on_prefix_match",
                 "on_cow", "on_relay", "on_tokens", "on_done", "drift",
                 "drift_value", "trace_book", "start_endpoint"):
        monkeypatch.setattr(observe, name, _explode)
    rng = np.random.RandomState(55)
    with Engine(model, prefix_cache=True, **KW) as eng:
        assert eng._obs is None and eng._endpoint is None
        outs = _drive(eng, make_prompts(4, rng), max_new=4)
        outs += _drive(eng, [outs[0][:20]], max_new=4, deadline_s=60.0)
    assert all(len(o) > 4 for o in outs)
    assert observe._book is None
    assert not any(t.name == "serve-metrics" for t in threading.enumerate())


def test_trace_flag_arms_engine(model):
    old = flags.get_flags("FLAGS_serve_trace")
    flags.set_flags({"FLAGS_serve_trace": True})
    try:
        with Engine(model, **KW) as eng:
            assert eng._obs is observe
    finally:
        flags.set_flags(old)
    with Engine(model, **KW) as eng:
        assert eng._obs is None
