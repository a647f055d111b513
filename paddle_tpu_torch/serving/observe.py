"""Serving SLO observability: request tracing, token-latency histograms, a
telemetry endpoint and cost-model drift (port of
``paddle_tpu/serving/observe.py``; the same public names, span names,
Prometheus families and JSON keys).

Four layers, each inert until armed:

* **request tracing** (``FLAGS_serve_trace``, ``Engine(trace=True)``):
  ``Engine.submit`` gives every request a process-unique trace id on the
  ``_Request`` object itself. The snapshot records, the supervisor's harvest
  and the handoff queue carry ``_Request`` objects whole, so the id survives
  crash recovery, re-attach and handoff; the supervisor's requeue copies it
  onto the continuation. Scheduler spans that touch requests are tagged
  ``traces=(...)``, and a span observer
  (:func:`paddle_tpu_torch.profiler.spans.add_span_observer`) routes each
  finished one into the per-request timelines. Queue wait, shed decisions,
  prefix-cache matches, copy-on-write copies and relays are synthesized
  directly. Completed timelines land in a bounded ring (:class:`TraceBook`,
  ``FLAGS_serve_trace_ring``), exportable as chrome trace or JSONL.
* **SLO histograms**: fixed buckets, keyed by priority class: TTFT,
  inter-token gap, end-to-end latency, queue wait. ONE host clock read at
  the retire of each scheduler step, attributed to the rows that emitted a
  token. They reach ``profiler.export_metrics()`` as Prometheus histograms
  (and a derived summary) through the provider hook of
  ``profiler/export.py``.
* **telemetry endpoint** (``FLAGS_serve_metrics_port``): an opt-in stdlib
  ``http.server`` thread serving ``/metrics`` (Prometheus text),
  ``/healthz`` and ``/readyz`` (the ``health()``/``ready()`` dicts as JSON,
  200/503) and ``/debug/requests`` (the in-flight table with trace ids).
  Port 0 (the default) starts no thread.
* **cost-model drift**: predicted against measured, as |relative error| EMA
  gauges and a ``cost_drift`` span attr. The port scores two predictors:
  the engine's shed-sweep step-time estimate (``step_eta``) against each
  warm decode step, and ``kernel_estimate``, the kernel autotuner's
  cost-model ordering against its measured timings (the discordant-pair
  fraction, through :func:`drift_value`, once a search has timed two
  configs; ``ops/kernels/autotune.py``). The reference's third,
  ``hbm_admission``, has no call site in the port yet, and :func:`drift`
  takes any name.

Everything here is O(1) per scheduler step (per emitted token for the gap
histogram, the order of the per-row work the scheduler already does).
"""
from __future__ import annotations

import collections
import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import profiler
from ..framework.flags import flag
from ..profiler import spans as _spans
from ..profiler import export as _export

__all__ = [
    "Histogram", "TraceBook", "MetricsEndpoint",
    "enabled", "trace_book", "slo", "drift", "drift_value", "drift_gauges",
    "percentile", "reset", "start_endpoint",
]


def enabled() -> bool:
    return bool(flag("FLAGS_serve_trace", False))


# -- fixed-bucket histograms --------------------------------------------------

# Bucket upper bounds in SECONDS. Latency-shaped (roughly log-spaced):
# TTFT / end-to-end / queue wait share one layout; the inter-token gap gets
# a finer low end (decode steps are sub-millisecond on a warm engine).
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
GAP_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
)

# SLO metric name -> (bucket layout, help string)
SLO_METRICS = {
    "serve_ttft_seconds": (LATENCY_BUCKETS, "submit -> first generated token"),
    "serve_inter_token_seconds": (GAP_BUCKETS, "gap between consecutive tokens of one request"),
    "serve_e2e_seconds": (LATENCY_BUCKETS, "submit -> successful completion"),
    "serve_queue_seconds": (LATENCY_BUCKETS, "submit -> admission (queue wait)"),
}


class Histogram:
    """One fixed-bucket histogram (Prometheus ``histogram`` semantics:
    cumulative ``le`` buckets + ``_sum`` + ``_count``).  ``observe`` is a
    binary search + three integer bumps under a lock — the scheduler thread
    writes, the endpoint/export threads read snapshots."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # guarded_by: _lock
        self._sum = 0.0  # guarded_by: _lock
        self._count = 0  # guarded_by: _lock

    def observe(self, value: float) -> None:
        import bisect

        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum = list(itertools.accumulate(counts))
        return {
            "buckets": list(self.buckets),
            "counts": counts,          # per-bucket (last = +Inf overflow)
            "cumulative": cum,         # Prometheus le-cumulative view
            "sum": s,
            "count": c,
        }


class _Slo:
    """The SLO metric layer: ``(metric, priority class)`` -> Histogram.
    Priority classes are the engine's integer priorities, labeled as
    strings; histograms are created on first observation per class."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: Dict[Tuple[str, str], Histogram] = {}  # guarded_by: _lock

    def observe(self, metric: str, priority, value: float) -> None:
        key = (metric, str(int(priority)))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.get(key)
                if h is None:
                    h = Histogram(SLO_METRICS[metric][0])
                    self._hists[key] = h
        h.observe(value)

    def snapshot(self) -> dict:
        with self._lock:
            items = list(self._hists.items())
        out: Dict[str, dict] = {}
        for (metric, prio), h in items:
            out.setdefault(metric, {})[prio] = h.snapshot()
        return out


# -- request timelines --------------------------------------------------------

_trace_ids = itertools.count(1)  # GIL-atomic; process-unique trace ids


class TraceBook:
    """Open + completed per-request timelines.  One book per process is
    shared by every traced engine: trace ids are process-unique, and a
    request's timeline must stay in ONE place while the request migrates
    between engines (supervisor restart, handoff).  The completed ring is
    bounded (``capacity``); the oldest timeline is evicted on overflow
    (``serve_trace_evicted``)."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(int(capacity), 1)
        self._lock = threading.Lock()
        self._open: Dict[str, dict] = {}  # guarded_by: _lock
        self._done = collections.deque()  # guarded_by: _lock

    # -- lifecycle ---------------------------------------------------------
    def open(self, req_id: int, prompt_len: int, priority: int,
             trace: Optional[str] = None) -> str:
        tid = trace if trace is not None else f"t{next(_trace_ids)}"
        rec = {
            "trace": tid,
            "req_id": int(req_id),
            "prompt_len": int(prompt_len),
            "priority": int(priority),
            "t_open": time.perf_counter_ns(),
            "events": [],
            "outcome": None,
        }
        with self._lock:
            # a recovered request re-opens its original trace id on the new
            # engine: keep the accumulated events, only re-point req_id
            # (the requeue continuation has a fresh engine-local id)
            prev = self._open.get(tid)
            if prev is not None:
                prev["req_id"] = int(req_id)
            else:
                self._open[tid] = rec
        return tid

    def event(self, trace: Optional[str], name: str, t0: int, t1: int,
              **attrs) -> None:
        """Synthesize one timeline event (ns timestamps, the span clock).
        Falls back to the completed ring: a recovery relay lands AFTER the
        continuation already closed the timeline on the new engine."""
        if not trace:
            return
        ev = {"name": name, "t0": int(t0), "t1": int(t1), "attrs": attrs}
        with self._lock:
            tl = self._open.get(trace)
            if tl is None:
                for done in reversed(self._done):
                    if done["trace"] == trace:
                        tl = done
                        break
            if tl is not None:
                tl["events"].append(ev)

    def close(self, trace: Optional[str], outcome: str) -> None:
        if not trace:
            return
        with self._lock:
            tl = self._open.pop(trace, None)
            if tl is None:
                return
            tl["outcome"] = outcome
            tl["t_close"] = time.perf_counter_ns()
            self._done.append(tl)
            if len(self._done) > self.capacity:
                self._done.popleft()
                profiler.counter_inc("serve_trace_evicted")

    # -- span fan-in -------------------------------------------------------
    def span_observer(self, sp) -> None:
        """Registered with ``spans.add_span_observer``: any finished span
        tagged ``traces=(...)`` lands (attrs minus the tag) on every open
        timeline it names."""
        traces = sp.attrs.get("traces")
        if not traces:
            return
        attrs = {k: v for k, v in sp.attrs.items() if k != "traces"}
        ev = {"name": sp.name, "t0": sp.t0, "t1": sp.t1, "attrs": attrs}
        with self._lock:
            for t in traces:
                tl = self._open.get(t)
                if tl is not None:
                    tl["events"].append(ev)

    # -- inspection / export ----------------------------------------------
    def completed(self) -> List[dict]:
        with self._lock:
            return [dict(t, events=list(t["events"])) for t in self._done]

    def open_traces(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v, events=list(v["events"]))
                    for k, v in self._open.items()}

    def timeline(self, trace: str) -> Optional[dict]:
        with self._lock:
            tl = self._open.get(trace)
            if tl is None:
                for t in self._done:
                    if t["trace"] == trace:
                        tl = t
                        break
            return None if tl is None else dict(tl, events=list(tl["events"]))

    def chrome_trace(self, path: str) -> None:
        """Completed timelines as a chrome://tracing document — one display
        thread per request so timelines stack instead of interleaving."""
        events = []
        for i, tl in enumerate(self.completed()):
            events.append({
                "name": "thread_name", "ph": "M", "pid": 0, "tid": i,
                "args": {"name": f"{tl['trace']} req={tl['req_id']}"},
            })
            for ev in tl["events"]:
                events.append({
                    "name": ev["name"], "ph": "X", "cat": "request",
                    "ts": ev["t0"] / 1000.0,
                    "dur": max(ev["t1"] - ev["t0"], 0) / 1000.0,
                    "pid": 0, "tid": i,
                    "args": dict(ev["attrs"], trace=tl["trace"]),
                })
        from ..framework.io import atomic_open

        with atomic_open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f,
                      default=str)

    def jsonl(self, path: str) -> None:
        from ..framework.io import atomic_open

        with atomic_open(path, "w") as f:
            for tl in self.completed():
                f.write(json.dumps(tl, default=str) + "\n")


# -- module singletons --------------------------------------------------------
# One book + one SLO layer per process (trace ids are process-unique and
# requests migrate between engines). Created lazily on the first traced
# engine; `reset()` gives tests/benches a clean slate.
_state_lock = threading.Lock()
_book: Optional[TraceBook] = None  # guarded_by: _state_lock
_slo: Optional[_Slo] = None  # guarded_by: _state_lock


def trace_book() -> TraceBook:
    global _book
    b = _book
    if b is None:
        with _state_lock:
            b = _book
            if b is None:
                b = TraceBook(int(flag("FLAGS_serve_trace_ring", 256)))
                _spans.add_span_observer(b.span_observer)
                _book = b
    return b


def slo() -> _Slo:
    global _slo
    s = _slo
    if s is None:
        with _state_lock:
            s = _slo
            if s is None:
                s = _Slo()
                _slo = s
    return s


def reset() -> None:
    """Drop all tracing/SLO/drift state (tests, bench isolation)."""
    global _book, _slo
    with _state_lock:
        if _book is not None:
            _spans.remove_span_observer(_book.span_observer)
        _book = None
        _slo = None
    with _drift_lock:
        _drift.clear()


# -- request lifecycle hooks (called by Engine/ServingSupervisor) -------------
# Every hook is only reached when the engine was constructed with tracing
# armed — the flag-off scheduler never imports or touches this module past
# the one boolean probe at engine construction (inert tripwire).

def on_submit(req, trace: Optional[str] = None) -> None:
    """Assign (or re-attach) the trace id and open the timeline."""
    req.trace = trace_book().open(
        req.id, len(req.prompt), req.priority, trace=trace
    )
    req.t_submit_ns = time.perf_counter_ns()


def on_admit(req) -> None:
    """Queue exit into prefill: synthesize the queue-wait span + observe."""
    now_ns = time.perf_counter_ns()
    trace_book().event(req.trace, "queue", req.t_submit_ns, now_ns)
    slo().observe("serve_queue_seconds", req.priority,
                  max(time.monotonic() - req.t_submit, 0.0))


def on_shed(req, kind: str) -> None:
    """Request shed from the queue (deadline doom/expiry): the queue span
    closes with the shed reason and the timeline completes as shed."""
    b = trace_book()
    b.event(req.trace, "queue", req.t_submit_ns, time.perf_counter_ns(),
            shed=kind)
    b.close(req.trace, "shed")


def on_prefix_match(req, tokens_matched: int, blocks: int) -> None:
    now = time.perf_counter_ns()
    trace_book().event(req.trace, "prefix_match", now, now,
                       tokens=int(tokens_matched), blocks=int(blocks))


def on_cow(trace: Optional[str], blocks: int) -> None:
    now = time.perf_counter_ns()
    trace_book().event(trace, "cow_copy", now, now, blocks=int(blocks))


def on_relay(req, tokens: int, error: Optional[str]) -> None:
    """Supervisor recovery relay stitched a continuation's output into the
    original handle — the last hop of a recovered request's timeline."""
    now = time.perf_counter_ns()
    trace_book().event(req.trace, "relay", now, now, tokens=int(tokens),
                       error=error)


def on_tokens(emitted, now_mono: float) -> None:
    """Per-token latency attribution. ``emitted`` is the list of requests
    that received a token this scheduler step; ``now_mono`` is the ONE host
    clock read taken at step retire."""
    s = slo()
    for req in emitted:
        if req.t_first_tok == 0.0:
            req.t_first_tok = now_mono
            s.observe("serve_ttft_seconds", req.priority,
                      max(now_mono - req.t_submit, 0.0))
        else:
            s.observe("serve_inter_token_seconds", req.priority,
                      max(now_mono - req.t_last_tok, 0.0))
        req.t_last_tok = now_mono


def on_done(req, error) -> None:
    """Terminal state: e2e latency (successes only — shed/cancelled would
    skew the SLO line) and timeline completion."""
    b = trace_book()
    if error is None:
        slo().observe("serve_e2e_seconds", req.priority,
                      max(time.monotonic() - req.t_submit, 0.0))
        b.close(req.trace, "ok")
    else:
        b.close(req.trace, type(error).__name__)


# -- cost-model drift ---------------------------------------------------------
_DRIFT_EMA = 0.8  # same smoothing the engine's step EMA uses

_drift_lock = threading.Lock()
_drift: Dict[str, dict] = {}  # guarded_by: _drift_lock


def drift(name: str, predicted: float, actual: float) -> float:
    """Record one predicted-vs-actual pair: |relative error| against the
    measurement, EMA-smoothed into the ``cost_drift`` gauge family.
    Returns this sample's relative error (the ``cost_drift`` span attr)."""
    denom = max(abs(float(actual)), 1e-12)
    rel = abs(float(predicted) - float(actual)) / denom
    return drift_value(name, rel, predicted=float(predicted),
                       actual=float(actual))


def drift_value(name: str, rel: float, **extra) -> float:
    """Record an already-computed drift sample (the kernel-estimate ORDER
    check has no single predicted/actual pair — its sample is the
    discordant-pair fraction between estimated and measured orderings)."""
    rel = float(rel)
    with _drift_lock:
        g = _drift.get(name)
        if g is None:
            g = {"rel_err": rel, "samples": 0}
            _drift[name] = g
        else:
            g["rel_err"] = _DRIFT_EMA * g["rel_err"] + (1 - _DRIFT_EMA) * rel
        g["samples"] += 1
        g["last_rel_err"] = rel
        g.update(extra)
    return rel


def drift_gauges() -> Dict[str, dict]:
    with _drift_lock:
        return {k: dict(v) for k, v in _drift.items()}


# -- derived views ------------------------------------------------------------

def percentile(metric: str, q: float, priority: Optional[int] = None) -> float:
    """Estimate a quantile from the fixed-bucket histogram (bucket upper
    bound with linear interpolation inside the bucket — the standard
    Prometheus ``histogram_quantile`` estimate). Merges priority classes
    unless one is named. Returns 0.0 with no observations."""
    snap = slo().snapshot().get(metric)
    if not snap:
        return 0.0
    if priority is not None:
        snap = {str(int(priority)): snap.get(str(int(priority)))}
    layouts = [s for s in snap.values() if s]
    if not layouts:
        return 0.0
    buckets = layouts[0]["buckets"]
    counts = [0] * (len(buckets) + 1)
    total = 0
    for s in layouts:
        for i, c in enumerate(s["counts"]):
            counts[i] += c
        total += s["count"]
    if total == 0:
        return 0.0
    rank = q * total
    cum = 0
    lo = 0.0
    for i, c in enumerate(counts):
        nxt = cum + c
        if nxt >= rank and c > 0:
            hi = buckets[i] if i < len(buckets) else buckets[-1]
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum = nxt
        if i < len(buckets):
            lo = buckets[i]
    return buckets[-1]


def shed_gauges() -> Dict[str, float]:
    """Shed / deadline-miss RATES derived from the lifecycle counters
    (fractions of submitted requests; 0.0 before any traffic)."""
    c = profiler.counters()
    total = max(c.get("serve_requests", 0) + c.get("serve_shed", 0), 1)
    shed = c.get("serve_shed", 0) + c.get("serve_deadline_shed", 0)
    miss = c.get("serve_deadline_shed", 0) + c.get("serve_deadline_expired", 0)
    return {
        "serve_shed_rate": shed / total,
        "serve_deadline_miss_rate": miss / total,
    }


# -- export provider ----------------------------------------------------------

def _prom_lines() -> List[str]:
    lines: List[str] = []
    snap = slo().snapshot() if _slo is not None else {}
    for metric in sorted(snap):
        mn = "paddle_tpu_" + metric
        lines.append(f"# HELP {mn} {SLO_METRICS[metric][1]}")
        lines.append(f"# TYPE {mn} histogram")
        for prio in sorted(snap[metric]):
            s = snap[metric][prio]
            for le, cum in zip(
                [str(b) for b in s["buckets"]] + ["+Inf"], s["cumulative"]
            ):
                lines.append(
                    f'{mn}_bucket{{priority="{prio}",le="{le}"}} {cum}'
                )
            lines.append(f'{mn}_sum{{priority="{prio}"}} {s["sum"]}')
            lines.append(f'{mn}_count{{priority="{prio}"}} {s["count"]}')
    if "serve_e2e_seconds" in snap:
        # derived summary view (bucket-estimate quantiles) so dashboards
        # without histogram_quantile still get the headline percentiles
        mn = "paddle_tpu_serve_e2e_latency"
        lines.append(f"# TYPE {mn} summary")
        tot_sum = sum(s["sum"] for s in snap["serve_e2e_seconds"].values())
        tot_cnt = sum(s["count"] for s in snap["serve_e2e_seconds"].values())
        for q in (0.5, 0.9, 0.99):
            lines.append(
                f'{mn}{{quantile="{q}"}} {percentile("serve_e2e_seconds", q)}'
            )
        lines.append(f"{mn}_sum {tot_sum}")
        lines.append(f"{mn}_count {tot_cnt}")
    for name, g in sorted(drift_gauges().items()):
        mn = "paddle_tpu_cost_drift"
        if not any(line.startswith(f"# TYPE {mn} ") for line in lines):
            lines.append(f"# TYPE {mn} gauge")
        lines.append(f'{mn}{{model="{name}"}} {g["rel_err"]}')
    for name, val in sorted(shed_gauges().items()):
        mn = "paddle_tpu_" + name
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn} {val}")
    return lines


def _json_snapshot() -> dict:
    return {
        "slo": slo().snapshot() if _slo is not None else {},
        "cost_drift": drift_gauges(),
        "rates": shed_gauges(),
    }


def _provider():
    return _prom_lines(), _json_snapshot()


_export.register_metric_provider("serving", _provider)


# -- telemetry endpoint -------------------------------------------------------

class MetricsEndpoint:
    """Opt-in stdlib HTTP telemetry server (one daemon thread + the
    per-connection threads ``ThreadingHTTPServer`` spawns).  Routes:

    * ``GET /metrics``        — Prometheus text exposition (counters,
      gauges, SLO histograms, drift gauges);
    * ``GET /healthz``        — ``target.health()`` as JSON, 200 when
      ``ok`` else 503 (liveness);
    * ``GET /readyz``         — ``target.ready()`` as JSON, 200 when
      ``ready`` else 503 (traffic admission);
    * ``GET /debug/requests`` — live in-flight request table (phase, age,
      blocks held, trace id) from ``target.debug_requests()``.

    Holds the target (Engine or ServingSupervisor) behind a weakref so the
    endpoint never keeps a closed engine alive; a dead target answers 503.
    """

    def __init__(self, target, port: int, host: str = ""):
        import http.server
        import weakref

        self._target_ref = weakref.ref(target)
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            # telemetry must never spam the serving process's stderr
            def log_message(self, *args):
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                profiler.counter_inc("serve_http_requests")
                path = self.path.split("?", 1)[0]
                target = outer._target_ref()
                try:
                    if path == "/metrics":
                        self._send(
                            200, profiler.export_metrics(format="prometheus"),
                            ctype="text/plain; version=0.0.4",
                        )
                    elif path in ("/healthz", "/readyz"):
                        if target is None:
                            self._send(503, json.dumps(
                                {"ok": False, "error": "engine gone"}))
                            return
                        if path == "/healthz":
                            h = target.health()
                            ok = bool(h.get("ok"))
                        else:
                            h = target.ready()
                            ok = bool(h.get("ready"))
                        self._send(200 if ok else 503,
                                   json.dumps(h, default=str))
                    elif path == "/debug/requests":
                        rows = [] if target is None else target.debug_requests()
                        self._send(200, json.dumps(rows, default=str))
                    else:
                        self._send(404, json.dumps({"error": "not found"}))
                except BrokenPipeError:
                    pass
                except Exception as e:
                    try:
                        self._send(500, json.dumps({"error": repr(e)}))
                    except Exception:
                        pass

        http.server.ThreadingHTTPServer.allow_reuse_address = True
        self._server = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="serve-metrics",
        )
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5.0)


def start_endpoint(target, port: int):
    """Start the telemetry endpoint, or return None (with a counter bump)
    when the port can't be bound — telemetry must never take serving down."""
    try:
        return MetricsEndpoint(target, int(port))
    except OSError:
        profiler.counter_inc("serve_http_bind_failed")
        return None
