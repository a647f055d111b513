"""Trace and metrics exporters (port of ``paddle_tpu/profiler/export.py``).

Flat events and spans each live in ONE sink, the native host runtime's C++
rings (``core/csrc/trace.cc``), and the functions here drain them (the
drain copies; the cursors run on until the next session resets them),
resolve each record's name through ``ptt_name``, join the spans' attributes
from the Python side table by span id, and hand them back in time order;
each span keeps its ``span_id``/``parent_id``, the nesting. Each ring keeps
its newest 65536 records: what a wraparound overwrote is counted under
``trace_dropped`` in :func:`metrics_snapshot`, and a drain that finds its
ring wrapped warns.

Formats:

* :func:`chrome_trace`: ``chrome://tracing`` / Perfetto JSON; spans are
  complete ("X") events whose time containment per tid gives the nesting,
  with ``span_id``/``parent_id``/attributes in ``args`` and the counter,
  memory and flags snapshot in the top-level ``metadata``;
* :func:`jsonl`: one JSON object a line (spans, events, then a metrics
  record), greppable without a trace viewer;
* :func:`export_metrics`: counters and memory gauges as JSON or Prometheus
  text, with what the registered providers add (the serving SLO
  histograms).
"""
from __future__ import annotations

import ctypes
import json
import re
import sys
import time
import warnings
from typing import Dict, List, Optional

import numpy as np

__all__ = ["merged_events", "merged_spans", "dropped", "metrics_snapshot",
           "chrome_trace", "jsonl", "register_metric_provider",
           "prometheus_text", "export_metrics"]


def _pkg():
    return sys.modules[__package__]


_EVENT = np.dtype([("name_id", "<u4"), ("tid", "<u4"), ("t0", "<u8"),
                   ("t1", "<u8")])  # trace.cc Event, 24 bytes
_SPAN = np.dtype(_EVENT.descr + [("span_id", "<u8"), ("parent_id", "<u8")])
_MAX_DRAIN = 1 << 16  # the rings' capacity


def dropped() -> Dict[str, int]:
    """Records the native rings overwrote since the session began (each
    keeps its newest 65536): ``{"events": n, "spans": n}``, zeros before
    the first record."""
    m = _pkg()
    rec = m._native_rec
    if rec is None:
        return {"events": 0, "spans": 0}
    return {"events": int(m._native.ptt_dropped(rec, 0)),
            "spans": int(m._native.ptt_dropped(rec, 1))}


def _drain(kind: str) -> list:
    """``(name, record)`` for each record of the native ``"event"`` or
    ``"span"`` ring, oldest first; warns when the ring wrapped and lost
    its oldest records."""
    m = _pkg()
    rec = m._native_recorder()
    lost = int(m._native.ptt_dropped(rec, int(kind == "span")))
    if lost:
        warnings.warn(f"profiler: the native {kind} ring wrapped; its "
                      f"{lost} oldest records of this session were "
                      "overwritten", RuntimeWarning, stacklevel=3)
    dt = _EVENT if kind == "event" else _SPAN
    buf = ctypes.create_string_buffer(dt.itemsize * _MAX_DRAIN)
    drain = m._native.ptt_drain if kind == "event" \
        else m._native.ptt_span_drain
    n = drain(rec, buf, _MAX_DRAIN)
    if n <= 0:
        return []
    rows = np.frombuffer(buf, dtype=dt, count=int(n))
    names: Dict[int, str] = {}

    def name_of(nid: int) -> str:
        if nid not in names:
            raw = m._native.ptt_name(rec, nid)
            names[nid] = raw.decode(errors="replace") if raw \
                else f"name_{nid}"
        return names[nid]

    return [(name_of(int(r["name_id"])), r) for r in rows]


def merged_events() -> list:
    """Flat events (``RecordEvent``) as ``_Event`` objects, time-ordered."""
    m = _pkg()
    out = [m._Event(name, int(r["t0"]), int(r["t1"]), int(r["tid"]))
           for name, r in _drain("event")]
    out.sort(key=lambda e: e.start)
    return out


def merged_spans() -> List[dict]:
    """Finished spans of the session as dicts (attributes joined by span
    id), time-ordered."""
    attrs = _pkg().spans._span_attrs
    out = []
    for name, r in _drain("span"):
        sid, t0, t1 = int(r["span_id"]), int(r["t0"]), int(r["t1"])
        out.append({"name": name, "span_id": sid,
                    "parent_id": int(r["parent_id"]), "tid": int(r["tid"]),
                    "t0": t0, "t1": t1, "dur_us": (t1 - t0) / 1000.0,
                    "attrs": dict(attrs.get(sid, ()))})
    out.sort(key=lambda s: s["t0"])
    return out


def metrics_snapshot() -> dict:
    """Counters, memory gauges, the flags in effect and the records the
    native rings overwrote (the trace metadata and flight-dump payload),
    with each provider's JSON under its name."""
    m = _pkg()
    try:
        from ..framework.flags import _FLAGS

        flags = dict(_FLAGS)
    except Exception:
        flags = {}
    snap = {
        "ts": time.time(),
        "counters": m.counters(),
        "memory": m.memory_stats(),
        "flags": flags,
        "trace_dropped": dropped(),
    }
    for name, (_prom, json_obj) in _provider_results():
        snap[name] = json_obj
    return snap


def chrome_trace(path: str) -> None:
    events = [
        {
            "name": e.name,
            "ph": "X",
            "cat": "op",
            "ts": e.start / 1000.0,
            "dur": (e.end - e.start) / 1000.0,
            "pid": 0,
            "tid": e.tid,
        }
        for e in merged_events()
    ]
    for s in merged_spans():
        events.append({
            "name": s["name"],
            "ph": "X",
            "cat": "span",
            "ts": s["t0"] / 1000.0,
            "dur": (s["t1"] - s["t0"]) / 1000.0,
            "pid": 0,
            "tid": s["tid"],
            "args": {"span_id": s["span_id"], "parent_id": s["parent_id"],
                     **s["attrs"]},
        })
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": metrics_snapshot(),
    }
    from ..framework.io import atomic_open

    # a viewer opening the file mid-export sees the previous trace or the
    # whole new one, never a truncated document
    with atomic_open(path, "w") as f:
        json.dump(doc, f, default=str)


def jsonl(path: str) -> None:
    """One JSON object a line: ``{"type": "span"|"event"|"metrics", ...}``."""
    from ..framework.io import atomic_open

    with atomic_open(path, "w") as f:
        for s in merged_spans():
            f.write(json.dumps({"type": "span", **s}, default=str) + "\n")
        for e in merged_events():
            f.write(json.dumps({
                "type": "event", "name": e.name, "t0": e.start, "t1": e.end,
                "dur_us": (e.end - e.start) / 1000.0, "tid": e.tid}) + "\n")
        f.write(json.dumps({"type": "metrics", **metrics_snapshot()},
                           default=str) + "\n")


# -- metrics ------------------------------------------------------------------
_METRIC_NAME = re.compile(r"[^a-zA-Z0-9_]")

# Extra metric providers (serving/observe.py: SLO histograms, drift and rate
# gauges). A provider is ``fn() -> (prom_lines, json_obj)``: the lines join
# the Prometheus exposition verbatim (the provider owns its TYPE headers) and
# the JSON object lands in ``metrics_snapshot()`` under the provider's name.
# A provider that raises is skipped, never fatal to a scrape.
_metric_providers: Dict[str, object] = {}


def register_metric_provider(name: str, fn) -> None:
    _metric_providers[name] = fn


def _provider_results():
    for name, fn in list(_metric_providers.items()):
        try:
            yield name, fn()
        except Exception:
            continue


def prometheus_text() -> str:
    """Prometheus text exposition: every counter as a ``counter``, every
    memory gauge as a ``gauge``, prefixed ``paddle_tpu_`` (the reference's
    metric names, so one dashboard reads both), then the providers'
    lines."""
    m = _pkg()
    lines = []
    for name, val in sorted(m.counters().items()):
        mn = "paddle_tpu_" + _METRIC_NAME.sub("_", name)
        lines.append(f"# TYPE {mn} counter")
        lines.append(f"{mn} {int(val)}")
    for name, val in sorted(m.memory_stats().items()):
        mn = "paddle_tpu_memory_" + _METRIC_NAME.sub("_", name)
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn} {int(val)}")
    for _name, (prom_lines, _json) in _provider_results():
        lines.extend(prom_lines)
    return "\n".join(lines) + "\n"


def export_metrics(path: Optional[str] = None, format: str = "json") -> str:
    if format == "json":
        text = json.dumps(metrics_snapshot(), default=str)
    elif format in ("prometheus", "prom", "text"):
        text = prometheus_text()
    else:
        raise ValueError(f"unknown metrics format {format!r}")
    if path is not None:
        # a textfile collector reads this concurrently: never a torn file
        from ..framework.io import atomic_open

        with atomic_open(path, "w") as f:
            f.write(text)
    return text
