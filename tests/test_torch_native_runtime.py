"""Port parity: the native host runtime of ``paddle_tpu_torch``
(``core/csrc/{trace,queue,arena}.cc`` through ``core/native.py``) against the
reference's ``paddle_tpu.core.native`` on the same calls.

The port's library is built from its own sources into
``paddle_tpu_torch/_build/`` (never from ``runtime_cpp/``); each case makes
the same calls on both libraries and compares what comes back: the queue's
FIFO, close and blocking-producer behaviour, the trace ring's interned
names and records, the span ring written from two threads, the arena's
size-class reuse, a ``Profiler`` session's exported span names and nesting,
and the thread-worker ``DataLoader`` over the native queue.
"""
import ctypes
import json
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.core import native as jnative
from paddle_tpu_torch.core import native


@pytest.fixture(scope="module")
def libs():
    ref = jnative.lib()
    assert ref is not None, "the reference's native runtime did not build"
    return native.lib(), ref


def test_library_is_built_from_the_ports_sources():
    path = native.library_path()
    assert native.lib() is not None and path.is_file()
    assert path.parent.name == "_build" \
        and path.parent.parent.name == "paddle_tpu_torch"
    assert path.name.startswith("libpaddle_tpu_torch_native-")
    assert native.HAS_SPANS
    # the name carries the sources' hash: an edited source is another file
    assert native.library_path() == path


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a library that cannot be built raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native runtime build failed"):
        native.build()


# -------------------------------------------------------------------- queue
@pytest.mark.parametrize("cls", [native.NativeQueue, "ref"],
                         ids=["port", "reference"])
def test_queue_fifo_and_close(libs, cls):
    q = (jnative.NativeQueue if cls == "ref" else cls)(4)
    got = []
    for i in range(3):
        assert q.push(bytes([i]) * (i + 1))
    got.append(len(q))
    got.append(q.pop())
    q.close()
    got += [q.pop(), q.pop(), q.pop(), q.push(b"x")]
    assert got == [3, b"\x00", b"\x01\x01", b"\x02\x02\x02", None, False]


def _blocking_run(make):
    """A capacity-2 queue: the producer's third push waits until the
    consumer pops; returns the producer's pushes seen before the pop, and
    every buffer the consumer drained."""
    q = make(2)
    pushed = []
    start = threading.Event()

    def producer():
        for i in range(20):
            q.push(np.full(100, i, np.uint8).tobytes())
            pushed.append(i)
            if i == 1:
                start.set()
        q.close()

    t = threading.Thread(target=producer)
    t.start()
    start.wait(10)
    t.join(0.2)  # the third push is blocked on the full queue
    before = list(pushed)
    received = []
    while True:
        b = q.pop()
        if b is None:
            break
        received.append(b)
    t.join(10)
    return before, received


def test_queue_blocking_producer_matches_reference(libs):
    before, received = _blocking_run(native.NativeQueue)
    rbefore, rreceived = _blocking_run(jnative.NativeQueue)
    assert before == rbefore == [0, 1]
    assert received == rreceived
    assert [b[0] for b in received] == list(range(20))
    assert all(len(b) == 100 for b in received)


# --------------------------------------------------------------- trace rings
def _trace_calls(L):
    r = L.ptt_create(8)
    a = L.ptt_intern(r, b"matmul")
    b = L.ptt_intern(r, b"copy")
    same = L.ptt_intern(r, b"matmul")
    for k in range(11):  # wraps the 8-slot ring
        L.ptt_record(r, (a, b)[k % 2], k % 3, 1000 + k, 2000 + k)
    buf = ctypes.create_string_buffer(24 * 16)
    n = L.ptt_drain(r, buf, 16)
    rows = np.frombuffer(buf, dtype=[("name_id", "<u4"), ("tid", "<u4"),
                                     ("t0", "<u8"), ("t1", "<u8")],
                         count=n).tolist()
    names = (L.ptt_name(r, a), L.ptt_name(r, b), L.ptt_name(r, 99))
    L.ptt_reset(r)
    after = L.ptt_drain(r, buf, 16)
    L.ptt_destroy(r)
    return (a, b, same, n, rows, names, after)


def test_trace_intern_record_drain_match_reference(libs):
    port, ref = libs
    got, want = _trace_calls(port), _trace_calls(ref)
    assert got == want
    assert got[3] == 8 and got[4][0][2] == 1003  # the newest 8, oldest first
    assert got[5] == (b"matmul", b"copy", b"")


def _span_ring_two_threads(L, n=2000):
    r = L.ptt_create(1 << 14)
    nid = L.ptt_intern(r, b"decode_step")

    def emit(tid):
        for k in range(n):
            sid = tid * 100000 + k + 1
            L.ptt_span_record(r, nid, tid, k, k + 1, sid, sid - 1 if k else 0)

    ts = [threading.Thread(target=emit, args=(t,)) for t in (1, 2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    buf = ctypes.create_string_buffer(40 * (1 << 14))
    got = L.ptt_span_drain(r, buf, 1 << 14)
    rows = np.frombuffer(buf, dtype=[
        ("name_id", "<u4"), ("tid", "<u4"), ("t0", "<u8"), ("t1", "<u8"),
        ("span_id", "<u8"), ("parent_id", "<u8")], count=got)
    L.ptt_destroy(r)
    return sorted(map(tuple, rows.tolist()))


def test_span_ring_from_two_threads_keeps_every_record(libs):
    """Two threads write the span ring at once through its atomic cursor:
    every record lands whole, and the set equals the reference's."""
    port, ref = libs
    got = _span_ring_two_threads(port)
    assert len(got) == 4000
    assert {r[1] for r in got} == {1, 2}
    assert all(r[4] // 100000 == r[1] and r[3] == r[2] + 1 for r in got)
    assert got == _span_ring_two_threads(ref)


def test_ring_counts_the_records_a_wraparound_overwrote(libs):
    port, _ = libs
    r = port.ptt_create(8)
    nid = port.ptt_intern(r, b"step")
    for k in range(11):
        port.ptt_record(r, nid, 0, k, k + 1)
    for k in range(3):
        port.ptt_span_record(r, nid, 0, k, k + 1, k + 1, 0)
    assert (port.ptt_dropped(r, 0), port.ptt_dropped(r, 1)) == (3, 0)
    port.ptt_reset(r)
    assert port.ptt_dropped(r, 0) == 0
    port.ptt_destroy(r)


def test_profiler_reports_a_wrapped_ring(libs):
    """A session that outgrows the 65536-record ring keeps the newest,
    counts the overwritten in the metrics snapshot and warns at export."""
    import paddle_tpu_torch.profiler as tprof
    from paddle_tpu_torch.profiler import export

    with tprof.Profiler(targets=[tprof.ProfilerTarget.CPU]):
        assert export.metrics_snapshot()["trace_dropped"] == {
            "events": 0, "spans": 0}
        for k in range((1 << 16) + 5):
            tprof._record("tick", k)
        assert export.dropped() == {"events": 5, "spans": 0}
        assert export.metrics_snapshot()["trace_dropped"]["events"] == 5
        with pytest.warns(RuntimeWarning, match="5 oldest records"):
            events = export.merged_events()
    assert len(events) == 1 << 16 and events[0].start == 5


# -------------------------------------------------------------------- arena
def _arena_calls(L):
    a = L.pta_create(64)
    p = L.pta_alloc(a, 10_000)
    aligned = p % 64 == 0
    L.pta_free(a, p)
    p2 = L.pta_alloc(a, 12_000)  # the same 16 KiB class: reused
    small = L.pta_alloc(a, 100)  # a 4 KiB page of its own
    L.pta_free(a, small)
    small2 = L.pta_alloc(a, 4096)
    out = (aligned, p2 == p, small2 == small, L.pta_reused(a),
           L.pta_bytes(a))
    L.pta_destroy(a)
    return out


def test_arena_size_class_reuse_matches_reference(libs):
    port, ref = libs
    got = _arena_calls(port)
    assert got == _arena_calls(ref)
    assert got == (True, True, True, 2, 16384 + 4096)


# ---------------------------------------------------------- profiler session
def _session(profiler, ProfilerTarget, path, **kw):
    from threading import Thread

    def work(tag):
        with profiler.span("serve", who=tag):
            with profiler.span("decode_step", step=1):
                with profiler.RecordEvent("op::paged"):
                    pass
            with profiler.span("decode_step", step=2):
                pass

    p = profiler.Profiler(targets=[ProfilerTarget.CPU], **kw)
    p.start()
    with profiler.span("train_step", step=0) as sp:
        with profiler.span("forward"):
            pass
        sp.set(done=True)
    t = Thread(target=work, args=("thread",))
    t.start()
    t.join()
    p.stop()
    p.export(str(path))
    trace = json.loads(path.read_text())
    spans = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    by_id = {e["args"]["span_id"]: e for e in spans}

    def parent(e):
        pid = e["args"]["parent_id"]
        return by_id[pid]["name"] if pid else None

    shape = sorted((e["name"], parent(e), e["args"].get("step"),
                    e["args"].get("who"), e["args"].get("done"))
                   for e in spans)
    events = sorted(e["name"] for e in trace["traceEvents"]
                    if e.get("cat") == "op")
    return shape, events


def test_profiler_session_exports_from_the_native_rings(libs, tmp_path,
                                                        monkeypatch):
    """A session with spans from two threads and a RecordEvent: the port's
    export (drained from its native rings) names the same spans with the
    same parents and attributes as the reference's export, and the Python
    lists the rings replaced are gone."""
    import paddle_tpu.profiler as jprof
    import paddle_tpu_torch.profiler as tprof

    got = _session(tprof, tprof.ProfilerTarget, tmp_path / "port.json")
    want = _session(jprof, jprof.ProfilerTarget, tmp_path / "ref.json",
                    timer_only=True)
    assert got == want
    assert ("decode_step", "serve", 2, None, None) in got[0]
    assert ("forward", "train_step", None, None, None) in got[0]
    assert got[1] == ["op::paged"]
    assert not hasattr(tprof.spans, "_span_events")
    assert not hasattr(tprof, "_events")
    # every record went through the native rings
    calls = {"span": 0}
    monkeypatch.setattr(tprof, "_native", _CountingLib(tprof._native, calls))
    with tprof.Profiler(targets=[tprof.ProfilerTarget.CPU]):
        with tprof.span("x"):
            pass
    assert calls["span"] == 1


class _CountingLib:
    """The native library with its span writes counted."""

    def __init__(self, lib, calls):
        self._lib, self._calls = lib, calls

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name != "ptt_span_record":
            return fn

        def counted(*a):
            self._calls["span"] += 1
            return fn(*a)

        return counted


def test_span_attrs_updated_after_the_span_closed_are_exported():
    import paddle_tpu_torch.profiler as tprof
    from paddle_tpu_torch.profiler.spans import update_attrs

    with tprof.Profiler(targets=[tprof.ProfilerTarget.CPU]):
        with tprof.span("train_step") as sp:
            pass
        update_attrs(sp, live_bytes=7)
        got = [s for s in tprof.span_events() if s["name"] == "train_step"]
    assert got and got[-1]["attrs"] == {"live_bytes": 7}


# -------------------------------------------------------- DataLoader threads
class _DS:
    def __len__(self):
        return 22

    def __getitem__(self, i):
        return np.full((4,), i, np.float32), np.int64(i)


def _batches(loader):
    return [(np.asarray(x).tolist(), np.asarray(y).tolist())
            for x, y in loader]


@pytest.mark.parametrize("workers", [1, 3])
def test_thread_loader_over_native_queue_equals_serial_and_reference(
        workers, monkeypatch):
    import paddle_tpu.io as jio
    from paddle_tpu_torch import io as tio

    made = []
    real = native.NativeQueue

    class Spy(real):
        def __init__(self, cap):
            made.append(cap)
            super().__init__(cap)

    monkeypatch.setattr(native, "NativeQueue", Spy)
    kw = dict(batch_size=4, shuffle=True, seed=7, drop_last=False)
    serial = _batches(tio.DataLoader(_DS(), places="cpu", **kw))
    threaded = _batches(tio.DataLoader(_DS(), places="cpu", num_workers=workers,
                                       use_shared_memory=False, **kw))
    assert made == [2]  # max(2, prefetch_factor)
    assert threaded == serial and len(serial) == 6
    ref = _batches(jio.DataLoader(_DS(), num_workers=1, **kw))
    assert ref == serial


def test_thread_loader_batches_are_host_tensors_and_errors_surface():
    from paddle_tpu_torch import io as tio

    class Bad(_DS):
        def __getitem__(self, i):
            if i == 9:
                raise ValueError("sample 9")
            return super().__getitem__(i)

    out = list(tio.DataLoader(_DS(), places="cpu", batch_size=5,
                              num_workers=2, use_shared_memory=False))
    assert all(isinstance(t, torch.Tensor) for b in out for t in b)
    assert out[0][1].dtype == torch.int64 and out[0][0].dtype == torch.float32
    it = iter(tio.DataLoader(Bad(), places="cpu", batch_size=5,
                             num_workers=2, use_shared_memory=False))
    next(it)
    with pytest.raises(ValueError, match="sample 9"):
        next(it)
    assert not any(t.is_alive() for t in it.inner.workers)  # closed


def _live_workers():
    return [t for t in threading.enumerate()
            if t.name == "dataloader-worker" and t.is_alive()]


def _wait_workers_gone(timeout=5.0):
    import time

    end = time.monotonic() + timeout
    while _live_workers() and time.monotonic() < end:
        time.sleep(0.01)
    return _live_workers()


@pytest.mark.parametrize("how", ["dropped", "prefetcher_closed",
                                 "prefetcher_dropped"])
def test_abandoned_thread_loader_stops_its_workers(how):
    """An iterator left part way through an epoch, with workers blocked on
    the full native queue, stops them once it is dropped or closed."""
    import gc

    from paddle_tpu_torch import io as tio

    gc.collect()
    assert _wait_workers_gone() == []
    loader = tio.DataLoader(_DS(), places="cpu", batch_size=1, num_workers=2,
                            use_shared_memory=False)
    if how == "dropped":
        it = iter(loader)
        got = [next(it) for _ in range(2)]
        assert _live_workers()  # 20 batches still due, the queue holds 2
        del it
    else:
        pf = tio.DevicePrefetcher(loader, buffer_size=1, device="cpu")
        got = [next(pf) for _ in range(2)]
        assert _live_workers()
        if how == "prefetcher_closed":
            pf.close()
        del pf
    gc.collect()
    assert [b[1].tolist() for b in got] == [[0], [1]]
    assert _wait_workers_gone() == []
