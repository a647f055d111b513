"""Flight recorder: always-on bounded span history and crash dumps (port of
``paddle_tpu/profiler/flight.py``).

An always-on ring (``collections.deque(maxlen=N)`` of finished spans, one
append per span) keeps the last N spans, and :func:`dump` writes a JSON
post-mortem with:

* the recent finished spans (with attributes) and the OPEN span stack of the
  dumping thread;
* the counter snapshot, the memory gauges and the flags in effect;
* the context of every registered provider (a serving engine's in-flight
  table, a supervisor's restart state, the out-of-memory event tail);
* the arming state of fault injection;
* on the card, the caching allocator's census of every initialized device.

``pending_graph`` is the lazy engine's pending graph on the dumping thread
(``core.lazy.pending_summary()``: node count, the last op names, the
deferred NaN/Inf checks not yet read).

Triggers wired in the port: the serving scheduler's crash path
(``serving_loop_error``), a supervisor's recovery
(``serving_supervisor_crash``/``_wedge``), ``fault.memory.post_mortem``
(``hbm_exhausted``), and, opt-in through :func:`install_excepthook` or
``with flight.on_crash():``, any uncaught exception.

Environment knobs (the reference's names):

* ``PADDLE_TPU_FLIGHT_CAPACITY``: ring size (default 256 spans);
* ``PADDLE_TPU_FLIGHT_DIR``: dump directory (default
  ``<tmp>/paddle_tpu_flight``);
* ``PADDLE_TPU_FLIGHT_DISABLE=1``: turn the recorder off.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import tempfile
import threading
import time
from typing import Optional

__all__ = [
    "record", "dump", "last_dump", "recent_spans", "capacity", "enabled",
    "install_excepthook", "on_crash", "clear", "add_context_provider",
    "remove_context_provider", "allocator_census",
]

_DISABLED = os.environ.get("PADDLE_TPU_FLIGHT_DISABLE", "").lower() in (
    "1", "true", "yes")
try:
    _CAPACITY = int(os.environ.get("PADDLE_TPU_FLIGHT_CAPACITY", "256") or 256)
except ValueError:  # a malformed diagnostics knob must not break the import
    _CAPACITY = 256
# lock-free: deque.append with a maxlen is atomic under the GIL, and record()
# is the per-span hot path
_ring: "collections.deque" = collections.deque(maxlen=max(_CAPACITY, 8))
_lock = threading.Lock()
_last_dump: Optional[str] = None  # guarded_by: _lock
_dump_seq = itertools.count(1)  # same-millisecond dumps must not collide


def enabled() -> bool:
    return not _DISABLED


def capacity() -> int:
    return _ring.maxlen


def record(sp) -> None:
    """Hot-path sink: one bounded-deque append per finished span."""
    if not _DISABLED:
        _ring.append(sp)


def recent_spans() -> list:
    """Snapshot of the ring, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def _dump_dir() -> str:
    return os.environ.get("PADDLE_TPU_FLIGHT_DIR") or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_flight")


# Subsystems register a provider so EVERY dump, whatever its trigger, carries
# their context. Providers run inside dump() and must be cheap; one that
# raises contributes an error marker instead of masking the dump.
_context_providers: dict = {}


def add_context_provider(name: str, fn) -> None:
    _context_providers[name] = fn


def remove_context_provider(name: str) -> None:
    _context_providers.pop(name, None)


def _provider_context() -> dict:
    out = {}
    for name, fn in list(_context_providers.items()):
        try:
            out[name] = fn()
        except Exception as e:
            out[name] = {"error": repr(e)}
    return out


def allocator_census() -> dict:
    """The caching allocator's counters of every CUDA device this process
    initialized, by device index ({} before CUDA is initialized: a dump
    must not be what initializes it). Reads host-side counters only."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out[str(i)] = {
            "allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "peak_allocated_bytes": int(st.get("allocated_bytes.all.peak",
                                               0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
            "active_blocks": int(st.get("active.all.current", 0)),
            "alloc_retries": int(st.get("num_alloc_retries", 0)),
            "ooms": int(st.get("num_ooms", 0)),
        }
    return out


def _pending_graph() -> dict:
    try:
        from ..core import lazy

        return lazy.pending_summary()
    except Exception as e:  # lint: ok(oom-handler) — a crash dump must never mask the crash
        return {"error": repr(e)}


def dump(reason: str, extra: Optional[dict] = None,
         path: Optional[str] = None) -> Optional[str]:
    """Write the post-mortem JSON; returns its path (None when disabled or
    the write itself failed: a crash dump must never mask the crash)."""
    global _last_dump
    if _DISABLED:
        return None
    from . import export as _export
    from .spans import active_spans

    try:
        from ..fault import inject

        fault_state = {"armed": inject.armed(),
                       "fired": inject.fired_counts()}
    except Exception:
        fault_state = {}
    try:
        allocator = allocator_census()
    except Exception as e:
        allocator = {"error": repr(e)}
    doc = {
        "reason": reason,
        "pid": os.getpid(),
        "active_spans": [sp.to_dict() for sp in active_spans()],
        "recent_spans": [sp.to_dict() for sp in recent_spans()],
        # one snapshot shape everywhere: traces, metrics export, crash dumps
        **_export.metrics_snapshot(),
        "pending_graph": _pending_graph(),
        "allocator": allocator,
        "fault_inject": fault_state,
        "context": _provider_context(),
        "extra": dict(extra or {}),
    }
    try:
        if path is None:
            d = _dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{os.getpid()}_{int(time.time() * 1000)}"
                   f"_{next(_dump_seq)}_{reason}.json")
        # tmp + os.replace: a monitoring agent tailing the dump dir must
        # never see a half-written document. Hand-rolled rather than
        # framework.io's atomic_open: the dumping process is often
        # mid-crash, and this path depends on nothing beyond os/json.
        tmp = f"{path}.tmp{os.getpid()}_{next(_dump_seq)}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except Exception:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
    except Exception:
        return None
    with _lock:
        _last_dump = path
    from . import counter_inc

    counter_inc("flight_dumps")
    return path


def last_dump() -> Optional[str]:
    """Path of the most recent dump this process wrote."""
    with _lock:
        return _last_dump


class on_crash:
    """``with flight.on_crash():`` around a loop: dumps (reason
    ``uncaught_exception``) before the exception propagates."""

    def __init__(self, reason: str = "uncaught_exception"):
        self.reason = reason

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and not issubclass(
                exc_type, (KeyboardInterrupt, SystemExit, GeneratorExit)):
            dump(self.reason, extra={"exception": repr(exc)})
        return False


_hook_installed = False


def install_excepthook() -> None:
    """Chain a ``sys.excepthook`` that dumps on any uncaught exception
    (opt-in: a library must not rewrite excepthook at import)."""
    global _hook_installed
    if _hook_installed:
        return
    prev = sys.excepthook

    def hook(exc_type, exc, tb):
        try:
            if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
                dump("uncaught_exception", extra={"exception": repr(exc)})
        finally:
            prev(exc_type, exc, tb)

    sys.excepthook = hook
    _hook_installed = True
