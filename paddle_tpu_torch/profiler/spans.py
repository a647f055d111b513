"""Structured span tracer: nested, attributed host spans (port of
``paddle_tpu/profiler/spans.py``).

Spans are the coarse skeleton of the work: ``train_step`` in the train step,
``schedule`` → ``admit``/``prefill``/``decode_step``/``evict`` in the
serving scheduler, ``serve_snapshot``/``serve_adopt``/``serve_handoff`` and
``supervise_restart`` around recovery. Each carries typed attributes (bucket
widths, row counts, the step index, the memory census) set at entry or with
``sp.set(...)`` before it closes.

A span measures host time. PyTorch queues device work and returns, so a span
covers the device work only where it ends in a host copy (the serving decode
step reads its tokens back); the device timeline of ``Profiler`` says where
device time goes.

Two sinks, different lifetimes:

* the **flight recorder** (:mod:`.flight`) receives every finished span,
  always: one bounded-deque append;
* the **profiler session** receives spans only while a
  :class:`~paddle_tpu_torch.profiler.Profiler` records: the native span
  ring (``core/csrc/trace.cc`` ``ptt_span_record``: name id, tid, start,
  end, span id, parent id), the one sink of the timing record, written
  from any thread without a lock. Attributes ride a bounded Python side
  table keyed by span id and are joined at export.
"""
from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "span", "current_span", "active_spans", "update_attrs",
           "add_span_observer", "remove_span_observer"]

_ids = itertools.count(1)  # GIL-atomic; 0 means "no parent"
_tls = threading.local()

# Compact per-thread display ids (chrome traces want small ints, and
# threading.get_ident() values are neither small nor stable across runs).
_tid_map: Dict[int, int] = {}
_tid_lock = threading.Lock()


def _tid() -> int:
    ident = threading.get_ident()
    t = _tid_map.get(ident)
    if t is None:
        with _tid_lock:
            t = _tid_map.setdefault(ident, len(_tid_map))
    return t


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = []
        _tls.stack = s
    return s


class Span:
    """One finished (or in-flight) span. ``attrs`` is a plain dict the owner
    may change until ``__exit__`` (``set``), or after it (``update_attrs``)."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "t0", "t1", "attrs")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = 0
        self.tid = 0
        self.t0 = 0
        self.t1 = 0
        self.attrs = attrs

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent_id = st[-1].span_id if st else 0
        self.tid = _tid()
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.t1 = time.perf_counter_ns()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:  # mis-nested exit (generator teardown): repair
            st.remove(self)
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        _emit(self)
        return False

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def dur_ns(self) -> int:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "tid": self.tid,
            "t0": self.t0,
            "t1": self.t1,
            "dur_us": (self.t1 - self.t0) / 1000.0,
            "attrs": dict(self.attrs),
        }

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, "
                f"dur_us={(self.t1 - self.t0) / 1000.0:.1f}, "
                f"attrs={self.attrs})")


def span(name: str, **attrs) -> Span:
    """``with span("decode_step", bucket=b) as sp: ... sp.set(rows=n)``"""
    return Span(name, **attrs)


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def active_spans() -> List[Span]:
    """The current thread's OPEN span stack, outermost first (a post-mortem
    dump names the span a failure happened inside)."""
    return list(getattr(_tls, "stack", ()) or ())


# -- session sink ------------------------------------------------------------
# The native span ring holds (name_id, tid, t0, t1, span_id, parent_id); the
# attributes of a recorded span wait here for export.
_span_attrs: Dict[int, dict] = {}  # span_id -> attrs
_SPAN_ATTRS_MAX = 1 << 16  # the native ring's capacity

_pkg = None  # the parent package module, bound lazily (import-order safe)

# Span observers (serving/observe.py request tracing): called with every
# FINISHED span, on the emitting thread. The empty-tuple probe is the whole
# disabled-path cost; an observer that raises is dropped from the fan-out,
# never from the sinks.
_observers: tuple = ()
_observers_lock = threading.Lock()


def add_span_observer(fn) -> None:
    global _observers
    with _observers_lock:
        if fn not in _observers:
            _observers = _observers + (fn,)


def remove_span_observer(fn) -> None:
    global _observers
    with _observers_lock:
        _observers = tuple(o for o in _observers if o is not fn)


def _emit(sp: Span) -> None:
    global _pkg
    if _pkg is None:
        _pkg = sys.modules[__package__]
    if _observers:
        for fn in _observers:
            try:
                fn(sp)
            except Exception:
                remove_span_observer(fn)
    _pkg.flight.record(sp)
    if not _pkg._enabled:
        return
    rec = _pkg._native_recorder()
    _pkg._native.ptt_span_record(rec, _pkg._name_id(rec, sp.name), sp.tid,
                                 sp.t0, sp.t1, sp.span_id, sp.parent_id)
    if sp.attrs:
        _keep_attrs(sp)


def _keep_attrs(sp: Span) -> None:
    # the ring keeps the NEWEST spans, so the table ages out the same way
    if sp.span_id not in _span_attrs and len(_span_attrs) >= _SPAN_ATTRS_MAX:
        _span_attrs.pop(next(iter(_span_attrs)))
    _span_attrs[sp.span_id] = dict(sp.attrs)


def update_attrs(sp: Span, **attrs) -> None:
    """Attach attributes to an ALREADY-FINISHED span. The flight ring holds
    the Span object itself; a span the session recorded gets its side-table
    entry refreshed."""
    sp.attrs.update(attrs)
    if sp.span_id in _span_attrs or (
            _pkg is not None and _pkg._enabled and sp.t1 and sp.attrs):
        _keep_attrs(sp)


def _reset_session() -> None:
    _span_attrs.clear()
