"""Port parity: ``paddle_tpu_torch.profiler`` (spans, scheduler, exporters,
flight recorder, memory census) against ``paddle_tpu.profiler``.

``make_scheduler`` is held against the reference over a grid of its five
arguments, and both raise the same ``ValueError``s. The rest ports the
reference's ``tests/test_profiler.py`` assertions to the port's surface: span
nesting and the ``error`` attr, scheduled recording windows, the chrome and
JSON-lines exports, Prometheus text, the flight ring's bound, its dump and
``on_crash``, the memory census on a CPU ``train_step`` span, and a
``ProfilerTarget.GPU`` profiler raising without CUDA. The reference's timing
guard (``TestOverheadGuard``) becomes a structural check: a closed profiler
appends nothing to the session list. Every profiler here records host spans
only (``ProfilerTarget.CPU`` or ``timer_only=True``); the device timeline
runs on the card, in ``chip_smoke.py``.
"""
import itertools
import json

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.profiler import (ProfilerState, ProfilerTarget, flight,
                                       make_scheduler, spans)

C, R, REC, RAR = (ProfilerState.CLOSED, ProfilerState.READY,
                  ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


def _host(**kw):
    return profiler.Profiler(targets=[ProfilerTarget.CPU], **kw)


def _work(steps=2):
    for i in range(steps):
        with profiler.span("train_step", step=i) as sp:
            with profiler.span("forward"):
                pass
            with profiler.RecordEvent("op::matmul"):
                pass
            sp.set(done=True)


# -- scheduler ----------------------------------------------------------------

@pytest.mark.parametrize("closed,ready,record,repeat,skip_first",
                         list(itertools.product((0, 2), (0, 1), (1, 3),
                                                (0, 2), (0, 1))))
def test_make_scheduler_matches_reference(closed, ready, record, repeat,
                                          skip_first):
    kw = dict(closed=closed, ready=ready, record=record, repeat=repeat,
              skip_first=skip_first)
    mine, ref = make_scheduler(**kw), jprofiler.make_scheduler(**kw)
    assert [mine(s) for s in range(24)] == [ref(s) for s in range(24)]


@pytest.mark.parametrize("kw", [dict(record=0), dict(closed=-1),
                                dict(ready=-1), dict(repeat=-1),
                                dict(skip_first=-1)])
def test_make_scheduler_validates_like_reference(kw):
    with pytest.raises(ValueError) as mine:
        make_scheduler(**kw)
    with pytest.raises(ValueError) as ref:
        jprofiler.make_scheduler(**kw)
    assert str(mine.value) == str(ref.value)


def test_states_and_targets_match_reference():
    for cls in ("ProfilerState", "ProfilerTarget"):
        mine, ref = getattr(profiler, cls), getattr(jprofiler, cls)
        names = [n for n in vars(ref) if n.isupper()]
        assert {n: getattr(mine, n) for n in names} \
            == {n: getattr(ref, n) for n in names}


def test_profiler_step_drives_recording_windows():
    traces = []
    p = _host(scheduler=make_scheduler(closed=1, ready=1, record=2),
              on_trace_ready=lambda prof: traces.append(prof.step_num))
    p.start()
    seen = []
    for _ in range(8):
        seen.append((p.current_state, profiler._enabled))
        p.step()
    p.stop()
    assert [s for s, _ in seen] == [C, R, REC, RAR, C, R, REC, RAR]
    assert [e for _, e in seen] == [st in (REC, RAR) for st, _ in seen]
    assert traces == [4, 8]


def test_scheduled_window_scopes_spans():
    p = _host(scheduler=make_scheduler(closed=2, record=1))
    p.start()
    assert p.current_state == C
    _work(1)
    assert profiler.events() == [] and profiler.span_events() == []
    p.step()
    p.step()
    _work(1)
    assert any(s["name"] == "train_step" for s in profiler.span_events())
    assert [e.name for e in profiler.events()] == ["op::matmul"]
    p.stop()


# -- spans --------------------------------------------------------------------

def test_span_nesting_and_attrs():
    with _host():
        _work(2)
    got = profiler.span_events()
    by_id = {s["span_id"]: s for s in got}
    steps = [s for s in got if s["name"] == "train_step"]
    fwd = [s for s in got if s["name"] == "forward"]
    assert len(steps) == 2 and len(fwd) == 2
    assert all(by_id[f["parent_id"]]["name"] == "train_step" for f in fwd)
    assert all(s["parent_id"] == 0 and s["attrs"]["done"] for s in steps)
    assert [s["attrs"]["step"] for s in steps] == [0, 1]
    assert all(s["t1"] >= s["t0"] for s in got)


def test_span_records_error_attr():
    with pytest.raises(ValueError):
        with profiler.span("doomed"):
            raise ValueError("boom")
    sp = flight.recent_spans()[-1]
    assert sp.name == "doomed" and sp.attrs["error"] == "ValueError"
    assert spans.current_span() is None and spans.active_spans() == []


def test_active_spans_and_update_attrs():
    with profiler.span("outer") as outer:
        with profiler.span("inner") as inner:
            assert spans.active_spans() == [outer, inner]
            assert spans.current_span() is inner
    spans.update_attrs(inner, late=7)
    assert flight.recent_spans()[-2].attrs == {"late": 7}


def test_span_observers_see_finished_spans_and_drop_raisers():
    seen = []

    def bad(sp):
        raise RuntimeError("observer bug")

    spans.add_span_observer(seen.append)
    spans.add_span_observer(bad)
    try:
        with profiler.span("observed", k=1):
            pass
        with profiler.span("again"):
            pass
        assert [s.name for s in seen] == ["observed", "again"]
        assert bad not in spans._observers
    finally:
        spans.remove_span_observer(seen.append)
        spans.remove_span_observer(bad)


def test_closed_profiler_appends_nothing_to_the_session():
    """The structural form of the reference's TestOverheadGuard: with the
    profiler constructed but CLOSED, a span reaches the flight ring and
    nothing else."""
    p = _host()
    p.start()
    p.stop()
    # the session's sinks are the native rings: their drains must not grow
    n_sp, n_ev = len(profiler.span_events()), len(profiler.events())
    flight.clear()
    _work(3)
    assert len(profiler.span_events()) == n_sp
    assert len(profiler.events()) == n_ev
    assert len(flight.recent_spans()) == 6


def test_summary_aggregates_and_sorts():
    with _host() as p:
        _work(3)
    s = p.summary()
    assert "train_step" in s and "op::matmul" in s and "calls" in s
    by_calls = p.summary(sorted_by="calls").splitlines()[1:]
    counts = [int(line.split()[-5]) for line in by_calls]
    assert counts == sorted(counts, reverse=True) and counts[0] == 3
    names = [line.split()[0] for line in
             p.summary(sorted_by="name").splitlines()[1:]]
    assert names == sorted(names)
    with pytest.raises(ValueError, match="sorted_by"):
        p.summary(sorted_by="bogus")


# -- exporters ----------------------------------------------------------------

def test_chrome_export_and_metadata(tmp_path):
    profiler.counter_inc("serve_requests", 0)  # the key exists
    with _host() as p:
        _work(1)
    out = tmp_path / "trace.json"
    p.export(str(out))
    doc = json.loads(out.read_text())
    ev = doc["traceEvents"]
    assert {e["name"] for e in ev} == {"train_step", "forward", "op::matmul"}
    assert all("dur" in e and e["ph"] == "X" for e in ev)
    step = next(e for e in ev if e["name"] == "train_step")
    assert step["cat"] == "span" and step["args"]["done"] is True
    meta = doc["metadata"]
    assert "serve_requests" in meta["counters"]
    assert "FLAGS_serve_trace" in meta["flags"]
    assert "peak_live_bytes" in meta["memory"]
    assert p.device_trace_path is None  # no device timeline on this target


def test_jsonl_roundtrip(tmp_path):
    with _host() as p:
        _work(2)
    out = tmp_path / "trace.jsonl"
    p.export(str(out), format="jsonl")
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert {ln["type"] for ln in lines} == {"span", "event", "metrics"}
    steps = [ln for ln in lines if ln["type"] == "span"
             and ln["name"] == "train_step"]
    assert [s["attrs"]["step"] for s in steps] == [0, 1]
    metrics = lines[-1]
    assert metrics["type"] == "metrics"
    assert "counters" in metrics and "memory" in metrics \
        and "flags" in metrics


def test_prometheus_text_format():
    profiler.counter_inc("serve_requests", 0)
    text = profiler.export_metrics(format="prometheus")
    assert "# TYPE paddle_tpu_serve_requests counter" in text
    assert "# TYPE paddle_tpu_memory_peak_live_bytes gauge" in text
    for line in text.splitlines():
        if not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            float(val)
            if name.startswith(("paddle_tpu_serve_requests",
                                "paddle_tpu_memory_")):
                int(val)


def test_export_metrics_json_file(tmp_path):
    out = tmp_path / "metrics.json"
    text = profiler.export_metrics(str(out), format="json")
    doc = json.loads(out.read_text())
    assert doc == json.loads(text)
    assert "counters" in doc and "memory" in doc


def test_unknown_formats_raise(tmp_path):
    p = _host()
    with pytest.raises(ValueError):
        p.export(str(tmp_path / "x"), format="xml")
    with pytest.raises(ValueError):
        profiler.export_metrics(format="xml")


# -- flight recorder ----------------------------------------------------------

def test_ring_is_bounded():
    flight.clear()
    for i in range(flight.capacity() + 50):
        with profiler.span("tick", i=i):
            pass
    got = flight.recent_spans()
    assert len(got) == flight.capacity() == jprofiler.flight.capacity()
    assert got[-1].attrs["i"] == flight.capacity() + 49


def test_manual_dump_contents(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    flight.add_context_provider("probe", lambda: {"rows": 3})
    flight.add_context_provider("broken", lambda: 1 / 0)
    c0 = profiler.counters().get("flight_dumps", 0)
    try:
        _work(1)
        with profiler.span("dumping"):
            path = flight.dump("manual", extra={"note": "hello"})
    finally:
        flight.remove_context_provider("probe")
        flight.remove_context_provider("broken")
    doc = json.loads(open(path).read())
    ref_keys = {"reason", "pid", "active_spans", "recent_spans", "ts",
                "counters", "memory", "flags", "pending_graph",
                "fault_inject", "context", "extra"}
    assert ref_keys <= set(doc)
    assert doc["reason"] == "manual" and doc["extra"]["note"] == "hello"
    assert [s["name"] for s in doc["active_spans"]] == ["dumping"]
    assert any(s["name"] == "train_step" for s in doc["recent_spans"])
    # the lazy engine is off here: nothing pending (the reference's keys)
    assert doc["pending_graph"] == {"pending_nodes": 0, "tail_ops": [],
                                    "deferred_checks": 0}
    assert doc["allocator"] == {}  # CUDA never initialized here
    assert doc["context"]["probe"] == {"rows": 3}
    assert "ZeroDivisionError" in doc["context"]["broken"]["error"]
    assert doc["fault_inject"] == {"armed": False, "fired": {}}
    assert flight.last_dump() == path
    assert profiler.counters()["flight_dumps"] == c0 + 1
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]


def test_on_crash_guard_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError):
        with flight.on_crash():
            _work(1)
            raise RuntimeError("train loop died")
    doc = json.loads(open(flight.last_dump()).read())
    assert doc["reason"] == "uncaught_exception"
    assert "train loop died" in doc["extra"]["exception"]


# -- memory census ------------------------------------------------------------

@pytest.fixture(scope="module")
def train_step():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

    m = GPTForPretraining(gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0),
                          device="cpu")
    opt = pt.optimizer.AdamW(1e-3, parameters=m.named_parameters())
    step = pt.jit.compile_train_step(m, lambda m, i, l: m.loss(i, l), opt)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, m.config.vocab_size, (2, 16)).astype(np.int64)
    return step, ids


def test_census_on_cpu_train_step_spans(train_step):
    step, ids = train_step
    c0 = profiler.memory_stats()["censuses"]
    with _host(profile_memory=True):
        step(ids, ids)
        step(ids, ids)
    got = [s for s in profiler.span_events() if s["name"] == "train_step"]
    assert len(got) == 2
    for s in got:
        a = s["attrs"]
        assert a["live_bytes"] > 0 and a["live_arrays"] > 0
        assert a["peak_live_bytes"] >= a["live_bytes"]
        assert "delta_bytes" in a
    stats = profiler.memory_stats()
    assert stats["peak_live_bytes"] >= stats["live_bytes"] > 0
    assert stats["censuses"] == c0 + 2
    assert got[1]["attrs"]["delta_bytes"] == \
        got[1]["attrs"]["live_bytes"] - got[0]["attrs"]["live_bytes"]


def test_census_off_without_memory_profiling(train_step):
    step, ids = train_step
    c0 = profiler.memory_stats()["censuses"]
    with _host():
        step(ids, ids)
    assert profiler.memory_stats()["censuses"] == c0
    s = [s for s in profiler.span_events() if s["name"] == "train_step"][-1]
    assert "live_bytes" not in s["attrs"]
    old = flags.get_flags("FLAGS_profile_memory")
    flags.set_flags({"FLAGS_profile_memory": True})
    try:
        step(ids, ids)  # the flag alone arms it, no profiler running
    finally:
        flags.set_flags(old)
    assert profiler.memory_stats()["censuses"] == c0 + 1
    assert "live_bytes" in flight.recent_spans()[-1].attrs


# -- device timeline ----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(targets=[ProfilerTarget.GPU]), {},
                                dict(targets=[ProfilerTarget.CPU,
                                              ProfilerTarget.GPU])])
def test_gpu_target_raises_without_cuda(monkeypatch, kw):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="ProfilerTarget.GPU needs CUDA"):
        profiler.Profiler(**kw)


def test_host_only_profilers_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for p in (profiler.Profiler(timer_only=True),
              profiler.Profiler(targets=[ProfilerTarget.GPU],
                                timer_only=True), _host()):
        with p:
            _work(1)
        assert not p.device_timeline and p.device_events() == []
