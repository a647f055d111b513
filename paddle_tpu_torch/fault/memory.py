"""Device-memory exhaustion: the classifier and the pressure-relief registry
(port of the serving side of ``paddle_tpu/fault/memory.py``).

* :func:`classify` / :func:`is_oom` — the one place that decides whether an
  exception is a device out-of-memory: ``torch.OutOfMemoryError`` (that is,
  ``torch.cuda.OutOfMemoryError``) or ``MemoryError``, or an exception whose
  text carries one of the reference's unambiguous status markers
  (``RESOURCE_EXHAUSTED``, ``out of memory``, ...), anywhere along the
  ``__cause__``/``__context__`` chain.
* :func:`register_pressure_handler` / :func:`free_pressure` — subsystems
  that can give memory back register a callback (weakly bound to an
  owner); the serving engine's parks KV blocks, which shrinks admission
  headroom.
* :func:`note_oom` counts (``hbm_oom_trips``) and records one classified
  exhaustion in a bounded event ring (:func:`recent_ooms`); the first one
  registers the ``hbm`` flight-recorder context provider, so every later
  post-mortem carries the event tail and the allocator census.
* :func:`post_mortem` writes the flight dump of an exhaustion recovery could
  not absorb (``hbm_exhausted``), with the recovery attempts and the
  device's allocator census (:func:`census`) where the reference carries its
  live-array census. The reference's admission budget and per-executable
  attributions belong to its cost model, which is not ported.
"""
from __future__ import annotations

import collections
import threading
import weakref
from typing import Callable, Dict, List, Optional

import torch

from ..profiler import counter_inc, flight, memory_stats

__all__ = ["HbmExhausted", "classify", "is_oom", "note_oom", "recent_ooms",
           "register_pressure_handler", "unregister_pressure_handler",
           "free_pressure", "census", "post_mortem"]

# the status-text markers the reference matches on its runtime error types,
# and the unambiguous subset it accepts on any other exception ("Failed to
# allocate" alone appears in plenty of errors that are not the device's)
_OOM_MARKERS = (
    "RESOURCE_EXHAUSTED", "Resource exhausted", "Out of memory",
    "out of memory", "OOM when allocating", "Failed to allocate",
)
_OOM_MARKERS_STRONG = (
    "RESOURCE_EXHAUSTED", "Resource exhausted", "Out of memory",
    "out of memory", "OOM when allocating",
)

_lock = threading.Lock()
_events: "collections.deque" = collections.deque(maxlen=32)  # guarded_by: _lock
_provider_installed = False  # guarded_by: _lock


class HbmExhausted(RuntimeError):
    """A device-memory exhaustion that recovery could not absorb. Carries
    the attempts made; ``__cause__`` is the original out-of-memory error."""

    def __init__(self, where: str, attempts: List[dict],
                 dump_path: Optional[str] = None):
        names = [a.get("action", "?") for a in attempts]
        super().__init__(
            f"HBM exhausted at '{where}' and the recovery ladder failed "
            f"(attempts: {names or ['none possible']}; post-mortem: "
            f"{dump_path or 'unavailable'})")
        self.where = where
        self.attempts = list(attempts)
        self.dump_path = dump_path


def classify(exc: BaseException) -> Optional[dict]:
    """``{"kind": "hbm_oom", "type": ..., "message": ...}`` when ``exc`` or
    an exception on its cause/context chain is a device-memory exhaustion,
    else None. The out-of-memory types match on their type alone; any other
    exception needs an unambiguous status marker in its text."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        msg = str(e)
        typename = type(e).__name__
        if isinstance(e, (torch.OutOfMemoryError, MemoryError)):
            return {"kind": "hbm_oom", "type": typename, "message": msg[:500]}
        if isinstance(e, Exception) \
                and any(m in msg for m in _OOM_MARKERS_STRONG):
            return {"kind": "hbm_oom", "type": typename, "message": msg[:500]}
        e = e.__cause__ or e.__context__
    return None


def is_oom(exc: BaseException) -> bool:
    return classify(exc) is not None


# Handlers run on the calling thread and must be cheap and thread-safe (the
# serving engine's only sets a request word its scheduler thread applies).
_pressure_handlers: Dict[str, Callable[[], Optional[dict]]] = {}


def register_pressure_handler(name: str, fn, owner=None) -> None:
    """Register a pressure-relief callback. With ``owner``, ``fn(owner)`` is
    called, and the entry drops out by itself once the owner is collected
    (an engine must not pin itself here)."""
    if owner is not None:
        wr = weakref.ref(owner,
                         lambda _r, _n=name: _pressure_handlers.pop(_n, None))
        orig = fn

        def fn(_wr=wr, _orig=orig):  # noqa: F811 — deliberate rebind
            o = _wr()
            return _orig(o) if o is not None else None

    _pressure_handlers[name] = fn


def unregister_pressure_handler(name: str) -> None:
    _pressure_handlers.pop(name, None)


def free_pressure(reason: str = "oom") -> dict:
    """Run every registered pressure handler (a serving engine parks KV
    blocks) and return what each answered."""
    handlers = {}
    for name, fn in list(_pressure_handlers.items()):
        try:
            handlers[name] = fn()
        except Exception as e:
            handlers[name] = {"error": repr(e)}
    return {"reason": reason, "handlers": handlers}


def note_oom(where: str, exc: BaseException) -> dict:
    """Count one classified exhaustion (``hbm_oom_trips``) and record it in
    the event ring. Returns the classification with ``where`` added."""
    info = classify(exc) or {"kind": "hbm_oom", "type": type(exc).__name__,
                             "message": str(exc)[:500]}
    info["where"] = where
    counter_inc("hbm_oom_trips")
    with _lock:
        _events.append(dict(info))
    _ensure_provider()
    return info


def recent_ooms() -> List[dict]:
    """The recorded exhaustions, oldest first (at most 32)."""
    with _lock:
        return [dict(e) for e in _events]


def census(device=None) -> dict:
    """The device-memory census a post-mortem carries: on an initialized
    CUDA device its entry of ``flight.allocator_census()`` (the caching
    allocator's current and peak allocated bytes, which are
    ``max_memory_allocated``, reserved bytes, which are
    ``memory_reserved``, active blocks, allocation retries and OOMs), read
    on the host without waiting on the device; elsewhere the profiler's
    last memory gauges. ``device=None`` is the current CUDA device."""
    by_dev = flight.allocator_census()
    if by_dev:
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda":
            idx = torch.cuda.current_device() if dev.index is None \
                else dev.index
            return dict(by_dev[str(idx)], device=f"cuda:{idx}")
    return dict(memory_stats(), device="cpu")


def post_mortem(where: str, attempts: List[dict],
                exc: Optional[BaseException] = None,
                device=None) -> Optional[str]:
    """Flight dump (``hbm_exhausted``) for an exhaustion recovery did not
    absorb: the device's :func:`census` and every recovery attempt made.
    Returns the dump's path (None when the recorder is off)."""
    try:
        c = census(device)
    except Exception as e:  # a post-mortem must not raise over the failure
        c = {"error": repr(e)}
    return flight.dump("hbm_exhausted", extra={
        "where": where,
        "census": c,
        "attempts": list(attempts),
        "exception": repr(exc) if exc is not None else None,
    })


def _context() -> dict:
    with _lock:
        events = list(_events)
    return {"recent_oom": events[-8:], "census": census()}


def _ensure_provider() -> None:
    """Register the flight context provider on the first classified
    exhaustion: every dump from then on carries the event tail and the
    census. Never registered by a process that met none."""
    global _provider_installed
    with _lock:
        if _provider_installed:
            return
        _provider_installed = True
    flight.add_context_provider("hbm", _context)
