"""Profiler (port of ``paddle_tpu/profiler/__init__.py``).

Layers, each usable alone:

* **counters**: always-on integer bumps at step granularity
  (:func:`counters`), exported as JSON or Prometheus text (:mod:`.export`);
* **span tracer** (:mod:`.spans`): nested, attributed host spans
  (``train_step``; ``schedule`` → ``admit``/``prefill``/``decode_step``),
  kept in the session while a :class:`Profiler` records. A session's flat
  events (``RecordEvent``) and finished spans live in the native host
  runtime's two C++ rings (``core/csrc/trace.cc``, built at first use by
  ``core/native.py``), the one sink of their timing records; span
  attributes stay in Python, joined by span id at export;
* **flight recorder** (:mod:`.flight`): an always-on ring of the last N spans
  and a JSON post-mortem on a serving crash, a supervisor recovery, an
  unrecovered device-memory exhaustion or an uncaught exception;
* **device timeline**: with ``ProfilerTarget.GPU`` among the targets, a
  ``torch.profiler`` session (CUPTI through Kineto) runs beside the host
  spans while the profiler records; :meth:`Profiler.device_events` lists its
  device activity (kernels by name, start, end, stream) and
  :meth:`Profiler.export` writes it as a chrome trace beside the host one.
  The reference hands the device timeline to ``jax.profiler``;
* **memory census** (:func:`memory_census`): the caching allocator's
  counters of the profiled device, once per train step, under
  ``Profiler(profile_memory=True)`` or ``FLAGS_profile_memory``. The
  reference walks ``jax.live_arrays()``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

__all__ = ["ProfilerTarget", "ProfilerState", "RecordEvent", "Profiler",
           "make_scheduler", "profiler_guard", "counter_inc", "counters",
           "reset_counters", "KNOWN_COUNTERS", "memory_census", "memory_stats", "events",
           "span_events", "export_metrics", "span", "spans", "flight"]


class ProfilerTarget:
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class _Event:
    __slots__ = ("name", "start", "end", "tid")

    def __init__(self, name, start, end, tid=0):
        self.name = name
        self.start = start
        self.end = end
        self.tid = tid


_enabled = False
_memory_on = False  # set while a Profiler(profile_memory=True) session runs

_lock = threading.Lock()
_counters = defaultdict(int)  # guarded_by: _lock


def counter_inc(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += int(n)


def counters() -> Dict[str, int]:
    """Snapshot of the counters. The reference's names, for what the port
    runs (``KNOWN_COUNTERS`` below is the registry):

    Serving engine: ``serve_requests`` / ``serve_admitted`` /
    ``serve_retired`` / ``serve_cancelled`` / ``serve_failed`` (request
    lifecycle), ``serve_prefills`` / ``serve_decode_steps`` /
    ``serve_tokens`` (work done), ``serve_compiles`` (step functions built),
    ``serve_backpressure``, ``serve_preempted``, ``serve_engine_errors``;
    the prefix cache (``serve_prefix_hits`` / ``serve_prefix_misses`` /
    ``serve_prefix_blocks_shared`` / ``serve_prefix_evicted``,
    ``serve_cow_copies``), chunked prefill (``serve_prefill_chunks``,
    ``serve_tail_prefills``), speculative decoding
    (``serve_draft_proposed`` / ``serve_draft_accepted``); the KV pool
    (``serve_pages_allocated`` / ``serve_pages_freed`` /
    ``serve_pages_shared``); tensor-parallel serving
    (``serve_tp_gather_bytes``, the shards' gathered bytes).

    Resilience and durability: ``serve_shed``, ``serve_deadline_shed``,
    ``serve_deadline_expired``, ``serve_wedged_close``,
    ``serve_crash_detected`` / ``serve_wedge_detected`` /
    ``serve_restarts`` / ``serve_requeued`` / ``serve_relayed``,
    ``serve_restart_mttr_ms``, ``serve_pool_damaged``, ``serve_snapshots`` /
    ``serve_snapshot_failed`` / ``serve_snapshot_rejected``,
    ``serve_pool_restores``, ``serve_adoptions``, ``serve_reattached`` /
    ``serve_reattached_blocks``, ``serve_reprefill_tokens`` /
    ``serve_reprefill_tokens_saved``, ``serve_handoffs``; device-memory
    pressure: ``hbm_oom_trips``, ``serve_pool_shrunk``,
    ``serve_pages_parked`` / ``serve_pages_unparked``.

    HBM admission and the out-of-memory ladder (``fault/memory.py``):
    ``hbm_admission_checks`` / ``hbm_admission_rejects`` (preflight
    decisions under ``FLAGS_hbm_admission``), ``hbm_oom_recoveries``
    (ladder rungs that brought a step back: a retry or a degrade),
    ``hbm_degraded_steps`` (steps re-run through the accumulate path),
    ``hbm_cache_evicted`` (cold CUDA graphs the lazy engine evicted). Data
    parallelism (``distributed/parallel.py``, the sharded update):
    ``dp_buckets``, ``dp_all_reduces``, ``dp_sync_bytes``,
    ``dp_reduce_scatters``, ``dp_gather_bytes``.

    The lazy engine (``core/lazy.py``): ``lazy_flushes``,
    ``lazy_cache_hits`` (flushes whose signature was seen before),
    ``lazy_graph_captures`` / ``lazy_graph_replays`` (CUDA graphs captured
    and replayed), ``lazy_replay_fallbacks`` (flushes whose capture or
    replay failed and that ran eagerly), ``lazy_blocks`` /
    ``lazy_block_ns`` (attributed host waits), ``lazy_deferred_checks``
    (NaN/Inf checks moved off the critical path),
    ``naninf_donation_suppressed``, ``lazy_donated_buffers``,
    ``lazy_verify_passes`` (``FLAGS_lazy_verify``).

    Training runtime: ``naninf_trips`` (the nan/inf scan),
    ``io_device_prefetched`` (batches the ``DevicePrefetcher`` staged),
    ``io_quarantine_skips`` (quarantined samples skipped),
    ``metric_host_reads`` (``metric`` updates' host reads),
    ``retry_attempts``, ``preemption_drains``; the stability sentinel:
    ``stability_observed``, ``stability_readbacks``, ``stability_trips``,
    ``stability_skips``, ``stability_rollbacks``, ``stability_halts``,
    ``stability_coordinated_trips``, ``stability_barrier_timeouts``;
    supervision and checkpoints: ``watchdog_trips``,
    ``heartbeat_failures``, ``ckpt_saves``, ``ckpt_save_failures``,
    ``ckpt_coordinated_commits``, ``ckpt_resume_fallbacks``.

    Host embedding (``incubate/host_embedding.py``): ``host_emb_lookups``,
    ``host_emb_hot_hits`` / ``host_emb_hot_misses``,
    ``host_emb_cache_admitted`` / ``host_emb_cache_evicted`` /
    ``host_emb_cache_shrinks``, ``host_emb_prefetch_hits`` /
    ``host_emb_prefetch_drops`` / ``host_emb_prefetch_patched``,
    ``host_emb_push_bytes``, ``host_emb_block_ns`` (host ns blocked on the
    table), ``host_emb_transport_serial`` (sharded-table transfers left on
    the serial path because the parallel transport's connections failed).

    Serving observability: ``serve_trace_evicted`` (completed timelines
    dropped from the bounded trace ring), ``serve_http_requests`` (telemetry
    endpoint GETs served), ``serve_http_bind_failed`` (endpoint start-ups
    that lost the port). Telemetry: ``flight_dumps``.

    Kernel registry (``ops/kernels``, only with ``FLAGS_kernel_autotune``
    ``ondemand`` or ``search``): ``kernel_tune_hits`` /
    ``kernel_tune_misses`` (tuning DB), ``kernel_tune_searches``,
    ``kernel_tune_candidates``, ``kernel_tune_candidate_errors``,
    ``kernel_tune_verify_fails``, ``kernel_tune_budget_stops``,
    ``kernel_tune_db_rejects``."""
    with _lock:
        return dict(_counters)


# The counter registry: every counter the package bumps, by name. The
# ``counter-registry`` lint rule (analysis/lint.py) holds the three-way
# contract: every ``counter_inc`` literal in the package appears here, every
# name here is bumped somewhere, and every name here is documented
# (double-backticked) in the :func:`counters` docstring above.
KNOWN_COUNTERS = frozenset({
    "ckpt_coordinated_commits", "ckpt_resume_fallbacks",
    "ckpt_save_failures", "ckpt_saves",
    "dp_all_reduces", "dp_buckets", "dp_gather_bytes",
    "dp_reduce_scatters", "dp_sync_bytes",
    "flight_dumps",
    "hbm_admission_checks", "hbm_admission_rejects", "hbm_cache_evicted",
    "hbm_degraded_steps", "hbm_oom_recoveries", "hbm_oom_trips",
    "heartbeat_failures",
    "host_emb_block_ns", "host_emb_cache_admitted",
    "host_emb_cache_evicted", "host_emb_cache_shrinks",
    "host_emb_hot_hits", "host_emb_hot_misses", "host_emb_lookups",
    "host_emb_prefetch_drops", "host_emb_prefetch_hits",
    "host_emb_prefetch_patched", "host_emb_push_bytes",
    "host_emb_transport_serial",
    "io_device_prefetched", "io_quarantine_skips",
    "kernel_tune_budget_stops", "kernel_tune_candidate_errors",
    "kernel_tune_candidates", "kernel_tune_db_rejects",
    "kernel_tune_hits", "kernel_tune_misses", "kernel_tune_searches",
    "kernel_tune_verify_fails",
    "lazy_block_ns", "lazy_blocks", "lazy_cache_hits",
    "lazy_deferred_checks", "lazy_donated_buffers", "lazy_flushes",
    "lazy_graph_captures", "lazy_graph_replays", "lazy_replay_fallbacks",
    "lazy_verify_passes",
    "metric_host_reads",
    "naninf_donation_suppressed", "naninf_trips",
    "preemption_drains", "retry_attempts",
    "serve_admitted", "serve_adoptions", "serve_backpressure",
    "serve_cancelled", "serve_compiles", "serve_cow_copies",
    "serve_crash_detected", "serve_deadline_expired",
    "serve_deadline_shed", "serve_decode_steps",
    "serve_draft_accepted", "serve_draft_proposed",
    "serve_engine_errors", "serve_failed", "serve_handoffs",
    "serve_http_bind_failed", "serve_http_requests",
    "serve_pages_allocated", "serve_pages_freed", "serve_pages_parked",
    "serve_pages_shared", "serve_pages_unparked", "serve_pool_damaged",
    "serve_pool_restores", "serve_pool_shrunk", "serve_preempted",
    "serve_prefill_chunks", "serve_prefills",
    "serve_prefix_blocks_shared", "serve_prefix_evicted",
    "serve_prefix_hits", "serve_prefix_misses",
    "serve_reattached", "serve_reattached_blocks", "serve_relayed",
    "serve_reprefill_tokens", "serve_reprefill_tokens_saved",
    "serve_requests", "serve_requeued", "serve_restart_mttr_ms",
    "serve_restarts", "serve_retired", "serve_shed",
    "serve_snapshot_failed", "serve_snapshot_rejected",
    "serve_snapshots", "serve_tail_prefills", "serve_tokens",
    "serve_tp_gather_bytes", "serve_trace_evicted",
    "serve_wedge_detected", "serve_wedged_close",
    "stability_barrier_timeouts", "stability_coordinated_trips",
    "stability_halts", "stability_observed", "stability_readbacks",
    "stability_rollbacks", "stability_skips", "stability_trips",
    "watchdog_trips",
})


def reset_counters() -> None:
    with _lock:
        _counters.clear()


# -- memory accounting --------------------------------------------------------
_mem: Dict[str, int] = {
    "live_bytes": 0, "live_arrays": 0, "peak_live_bytes": 0,
    "last_delta_bytes": 0, "censuses": 0,
}
_mem_lock = threading.Lock()


def _cpu_live() -> tuple:
    """(bytes, tensors) of the live CPU tensors ``gc`` can see, each storage
    counted once: the census of a CPU run (tests)."""
    import gc
    import warnings

    import torch

    def is_tensor(o):
        try:
            return isinstance(o, torch.Tensor)
        except ReferenceError:  # a weakref.proxy whose referent is gone
            return False

    seen, total = set(), 0
    with warnings.catch_warnings():
        # isinstance() touches deprecated module attributes gc also holds
        warnings.simplefilter("ignore")
        objs = [o for o in gc.get_objects() if is_tensor(o)]
    for o in objs:
        try:
            if o.device.type != "cpu":
                continue
            st = o.untyped_storage()
            key = st.data_ptr()
            if key == 0 or key in seen:
                continue
            seen.add(key)
            total += st.nbytes()
        except (RuntimeError, NotImplementedError):
            continue  # a tensor without plain storage (sparse, meta, ...)
    return total, len(seen)


def memory_census(device=None) -> Dict[str, int]:
    """Refresh the gauges from the profiled device and return them: live
    bytes and blocks, the delta since the previous census, and the peak.

    On a CUDA device the caching allocator answers
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``active.all.current``, and ``allocated_bytes.all.peak`` for the peak,
    the allocator's own high-water mark since the last
    ``torch.cuda.reset_peak_memory_stats``); it reads host-side counters and
    never waits on the device. On the CPU it walks the live tensors ``gc``
    can see (tests only), and the peak is the high-water mark of the
    censuses. ``device=None`` is the current CUDA device when CUDA is
    available, else the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        st = torch.cuda.memory_stats(device)
        total = int(st.get("allocated_bytes.all.current", 0))
        count = int(st.get("active.all.current", 0))
        peak = int(st.get("allocated_bytes.all.peak", 0))
    else:
        total, count = _cpu_live()
        peak = None
    with _mem_lock:
        _mem["last_delta_bytes"] = total - _mem["live_bytes"]
        _mem["live_bytes"] = total
        _mem["live_arrays"] = count
        _mem["censuses"] += 1
        _mem["peak_live_bytes"] = max(total, _mem["peak_live_bytes"]) \
            if peak is None else max(total, peak)
        return dict(_mem)


def memory_stats() -> Dict[str, int]:
    """Last-census gauges WITHOUT a fresh census (safe mid-crash)."""
    with _mem_lock:
        return dict(_mem)


def _memory_active() -> bool:
    if _enabled and _memory_on:
        return True
    from ..framework import flags as _flags

    return bool(_flags.flag("FLAGS_profile_memory", False))


# The native host runtime's recorder (core/csrc/trace.cc): its event ring and
# span ring hold the session's timing records. Created at the first record
# (or session reset); a failed build raises there.
_native = None
_native_rec = None
_native_lock = threading.Lock()
_name_ids: Dict[str, int] = {}  # the recorder's interned ids, by name


def _native_recorder():
    """The session recorder (a ``ptt_create`` handle of 65536 events and
    65536 spans), built and created on the first call."""
    global _native, _native_rec
    if _native_rec is None:
        with _native_lock:
            if _native_rec is None:
                from ..core import native as _native_mod

                _native = _native_mod.lib()
                _native_rec = _native.ptt_create(1 << 16)
    return _native_rec


def _name_id(rec, name: str) -> int:
    nid = _name_ids.get(name)
    if nid is None:
        nid = _name_ids.setdefault(name, _native.ptt_intern(rec,
                                                             name.encode()))
    return nid


def _record(name: str, t0: int, tid: int = 0):
    """Event sink: a start stamp taken while ``_enabled``, closed here, into
    the native event ring (its one sink)."""
    t1 = time.perf_counter_ns()
    if _enabled:
        rec = _native_recorder()
        _native.ptt_record(rec, _name_id(rec, name), tid, t0, t1)


class RecordEvent:
    """A named host event (reference ``platform/profiler.h`` RecordEvent):
    ``with RecordEvent("load"):`` or ``begin()``/``end()``. Recorded, into
    the native event ring, only while a profiler records."""

    def __init__(self, name, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()

    def end(self):
        if _enabled and self._t0 is not None:
            _record(self.name, self._t0)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def _reset_session():
    """Clear the session sinks (both native rings and the span attribute
    table) so a new recording starts empty."""
    spans._reset_session()
    rec = _native_recorder()
    _native.ptt_reset(rec)


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """Step-state schedule for ``Profiler.step()`` (reference
    ``profiler.make_scheduler``): after ``skip_first`` warm-up steps, cycle
    through ``closed`` CLOSED steps, ``ready`` READY steps and ``record``
    recording steps (the last of which is RECORD_AND_RETURN: the trace is
    handed to ``on_trace_ready`` at the next ``step()``). ``repeat`` bounds
    the number of cycles (0 = unlimited)."""
    closed, ready, record = int(closed), int(ready), int(record)
    repeat, skip_first = int(repeat), int(skip_first)
    if record < 1:
        raise ValueError("make_scheduler: record must be >= 1")
    if min(closed, ready, repeat, skip_first) < 0:
        raise ValueError("make_scheduler: negative phase length")
    cycle = closed + ready + record

    def schedule(step: int) -> int:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * cycle:
            return ProfilerState.CLOSED
        pos = s % cycle
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == cycle - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return schedule


# one torch.profiler (Kineto) session may run in a process at a time
_device_lock = threading.Lock()
_device_owner = None  # guarded_by: _device_lock


class Profiler:
    """Host-span profiler with an optional step scheduler and a device
    timeline.

    Without a scheduler, ``start()`` records until ``stop()``. With
    ``scheduler=make_scheduler(...)``, call ``step()`` once per train step:
    recording turns on only for the scheduled windows, and
    ``on_trace_ready(prof)`` fires at the end of each RECORD_AND_RETURN
    window (and at ``stop()`` if a window is still open).

    ``targets`` (None = CPU and GPU): with ``ProfilerTarget.GPU`` and not
    ``timer_only``, each recording window also runs a ``torch.profiler``
    session with CPU and CUDA activities. That needs CUDA: without it the
    constructor raises, and a session that fails to start raises; nothing
    falls back to a host-only trace. ``targets=[ProfilerTarget.CPU]`` or
    ``timer_only=True`` records host spans and events only, anywhere."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        targets = [ProfilerTarget.CPU, ProfilerTarget.GPU] \
            if targets is None else list(targets)
        self.timer_only = timer_only
        self.device_timeline = ProfilerTarget.GPU in targets and not timer_only
        if self.device_timeline:
            import torch

            if not torch.cuda.is_available():
                raise RuntimeError(
                    "profiler: ProfilerTarget.GPU needs CUDA, and "
                    "torch.cuda.is_available() is False; pass "
                    "targets=[ProfilerTarget.CPU] or timer_only=True for a "
                    "host-only profile")
        self.scheduler = scheduler
        self.on_trace_ready = on_trace_ready
        self.profile_memory = profile_memory
        self.record_shapes = record_shapes
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self.device_trace_path = None
        self._torch_prof = None  # the recording window's session
        self._last_torch_prof = None  # the last finished window's
        self._device_events: List[dict] = []

    # -- device timeline ----------------------------------------------------
    def _start_device(self):
        global _device_owner
        from torch.profiler import ProfilerActivity, profile

        with _device_lock:
            if _device_owner is not None:
                raise RuntimeError(
                    "profiler: another Profiler's device timeline is "
                    "recording (one torch.profiler session per process)")
            _device_owner = self
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=self.record_shapes)
        try:
            prof.start()
        except Exception as e:
            with _device_lock:
                _device_owner = None
            raise RuntimeError(
                f"profiler: the device timeline (torch.profiler with CUDA "
                f"activity, CUPTI through Kineto) failed to start: {e!r}"
            ) from e
        self._torch_prof = prof
        self._device_events = []

    def _stop_device(self):
        global _device_owner
        import torch
        from torch.autograd import DeviceType

        prof = self._torch_prof
        try:
            torch.cuda.synchronize()  # the window's launches land in it
            prof.stop()
        finally:
            with _device_lock:
                _device_owner = None
        self._device_events = sorted(
            ({"name": e.name(), "start_ns": int(e.start_ns()),
              "end_ns": int(e.end_ns()),
              "stream": int(e.device_resource_id()),
              "device": int(e.device_index())}
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA),
            key=lambda d: d["start_ns"])

    def device_events(self) -> List[dict]:
        """The last recorded window's device activity (kernels, copies,
        sets), time-ordered: ``{"name", "start_ns", "end_ns", "stream",
        "device"}`` each. Empty without a device timeline."""
        return list(self._device_events)

    # -- state machine -----------------------------------------------------
    def _recording(self) -> bool:
        return self.current_state in (ProfilerState.RECORD,
                                      ProfilerState.RECORD_AND_RETURN)

    def _apply(self, new_state: int):
        global _enabled
        was = self._recording()
        old, self.current_state = self.current_state, new_state
        now = self._recording()
        if now and not was:
            if self.device_timeline and self._torch_prof is None:
                try:
                    self._start_device()
                except BaseException:
                    self.current_state = old
                    raise
            _enabled = True
        elif was and not now:
            _enabled = False
            if self._torch_prof is not None:
                try:
                    self._stop_device()
                finally:
                    self._last_torch_prof = self._torch_prof
                    self._torch_prof = None

    def start(self):
        global _memory_on
        self.step_num = 0
        _reset_session()
        if self.profile_memory:
            _memory_on = True
        first = (self.scheduler(0) if self.scheduler is not None
                 else ProfilerState.RECORD)
        self._apply(first)

    def stop(self):
        global _memory_on
        was = self._recording()
        self._apply(ProfilerState.CLOSED)
        if self.profile_memory:
            _memory_on = False
        if was and self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self):
        """Advance the scheduler one train step; when the step that just
        finished was RECORD_AND_RETURN, hand the trace to
        ``on_trace_ready`` and reset the session for the next cycle."""
        finished_window = self.current_state == ProfilerState.RECORD_AND_RETURN
        self.step_num += 1
        new = (self.scheduler(self.step_num) if self.scheduler is not None
               else ProfilerState.RECORD)
        if finished_window:
            self._apply(ProfilerState.CLOSED)
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
            _reset_session()
        self._apply(new)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- output ------------------------------------------------------------
    def export(self, path, format="json"):
        """Chrome-trace export of the host spans and events, with the
        counters, memory gauges and flags as trace ``metadata``;
        ``format="jsonl"`` writes the one-object-a-line stream instead. With
        a device timeline, the last window's ``torch.profiler`` trace goes
        beside it as a chrome trace (``<path stem>.device.json``, also in
        ``device_trace_path``)."""
        from . import export as _export

        if format in ("json", "chrome"):
            _export.chrome_trace(path)
        elif format in ("jsonl", "ndjson"):
            _export.jsonl(path)
        else:
            raise ValueError(f"unknown export format {format!r}")
        if self._last_torch_prof is not None:
            stem = os.path.splitext(str(path))[0]
            self.device_trace_path = f"{stem}.device.json"
            self._last_torch_prof.export_chrome_trace(self.device_trace_path)

    def summary(self, sorted_by="total", op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Aggregate table over events and spans: calls, total, avg, min,
        max per name. ``sorted_by`` is one of ``total``/``calls``/``avg``/
        ``min``/``max``/``name`` (None = total)."""
        from . import export as _export

        div = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}.get(time_unit, 1e6)
        agg: Dict[str, list] = {}
        rows = [(e.name, e.end - e.start) for e in _export.merged_events()] \
            + [(s["name"], s["t1"] - s["t0"]) for s in _export.merged_spans()]
        for name, dur in rows:
            r = agg.get(name)
            if r is None:
                agg[name] = [1, dur, dur, dur]
            else:
                r[0] += 1
                r[1] += dur
                r[2] = min(r[2], dur)
                r[3] = max(r[3], dur)
        sorted_by = sorted_by or "total"
        keys = {
            "total": lambda kv: -kv[1][1],
            "calls": lambda kv: -kv[1][0],
            "avg": lambda kv: -(kv[1][1] / kv[1][0]),
            "min": lambda kv: -kv[1][2],
            "max": lambda kv: -kv[1][3],
            "name": lambda kv: kv[0],
        }
        if sorted_by not in keys:
            raise ValueError(f"summary: unknown sorted_by {sorted_by!r}; "
                             f"expected one of {sorted(keys)}")
        u = time_unit if time_unit in ("s", "ms", "us", "ns") else "ms"
        lines = [f"{'name':40s} {'calls':>8s} {'total_' + u:>12s} "
                 f"{'avg_' + u:>10s} {'min_' + u:>10s} {'max_' + u:>10s}"]
        for name, (calls, total, mn, mx) in sorted(agg.items(),
                                                   key=keys[sorted_by]):
            lines.append(f"{name:40s} {calls:8d} {total / div:12.3f} "
                         f"{total / calls / div:10.3f} {mn / div:10.3f} "
                         f"{mx / div:10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_guard(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


# Submodules read the package (counters, memory gauges, _enabled), so they
# load AFTER those definitions.
from . import flight  # noqa: E402
from . import spans  # noqa: E402
from .spans import span  # noqa: E402


def events() -> List[_Event]:
    """The session's flat events, time-ordered."""
    from . import export as _export

    return _export.merged_events()


def span_events() -> List[dict]:
    """The session's finished spans (dicts with ids, tid, times, attrs)."""
    from . import export as _export

    return _export.merged_spans()


def export_metrics(path: Optional[str] = None, format: str = "json"):
    """Counter and memory snapshot as JSON (default) or Prometheus text;
    returns the text and writes it to ``path`` when given."""
    from . import export as _export

    return _export.export_metrics(path, format=format)
