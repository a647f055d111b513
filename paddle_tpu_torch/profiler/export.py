"""Trace and metrics exporters (port of ``paddle_tpu/profiler/export.py``).

Flat events and spans each live in ONE sink, the profiler session's Python
lists (the reference's native C++ rings are not ported), and the functions
here read them back in time order.

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

import json
import re
import sys
import time
from typing import Dict, List, Optional

__all__ = ["merged_events", "merged_spans", "metrics_snapshot",
           "chrome_trace", "jsonl", "register_metric_provider",
           "prometheus_text", "export_metrics"]


def _pkg():
    return sys.modules[__package__]


def merged_events() -> list:
    """Flat events (``RecordEvent``) as ``_Event`` objects, time-ordered."""
    out = list(_pkg()._events)
    out.sort(key=lambda e: e.start)
    return out


def merged_spans() -> List[dict]:
    """Finished spans of the session as dicts, time-ordered."""
    out = [sp.to_dict() for sp in _pkg().spans._span_events]
    out.sort(key=lambda s: s["t0"])
    return out


def metrics_snapshot() -> dict:
    """Counters, memory gauges and the flags in effect (the trace metadata
    and flight-dump payload), with each provider's JSON under its name."""
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
