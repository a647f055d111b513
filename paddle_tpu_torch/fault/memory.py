"""Device-memory exhaustion: preflight admission and the OOM recovery ladder
(port of ``paddle_tpu/fault/memory.py``).

* :func:`classify` / :func:`is_oom` — the one place that decides whether an
  exception is a device out-of-memory: ``torch.OutOfMemoryError`` (that is,
  ``torch.cuda.OutOfMemoryError``) or ``MemoryError``, or an exception whose
  text carries one of the reference's unambiguous status markers
  (``RESOURCE_EXHAUSTED``, ``out of memory``, ...), anywhere along the
  ``__cause__``/``__context__`` chain.
* **Preflight admission** (:func:`preflight`) — each step program measures
  its footprint on the first ``cost_model.MEASURED_CALLS`` calls of a
  signature (``cost_model.executable_memory`` over a
  ``cost_model.MeasuredStep``, noted here by :func:`analyze_compiled`; the
  first call builds the optimizer state and gradients that later calls
  find in the live census, so the last measurement is the one admitted
  with); before each later call the
  predicted extra footprint (temp + output - max(alias, donated) bytes)
  plus the live census and any ``hbm.pressure`` chaos bytes is compared
  against the device budget (:func:`budget_bytes`:
  ``FLAGS_hbm_budget_bytes``, else the card's capacity less
  ``FLAGS_hbm_reserve_bytes``). ``FLAGS_hbm_admission`` picks the policy:
  ``off`` (one flag probe a step, and this module is never reached),
  ``warn`` (once a site) or ``enforce`` (:class:`HbmBudgetExceeded` before
  the step touches the device). The reference admits its lazy flushes with
  numbers XLA predicts at compile time; the port admits its step programs
  (``jit.CompiledTrainStep``, ``distributed.engine.HybridParallelEngine``)
  with numbers measured on their first calls, and the lazy engine's
  flushes (``core/lazy.py``) from the measured warm-up replay of a
  signature: its capture, and every replay after it, is admitted first
  (an ``enforce`` rejection leaves the pending graph pending).
* :func:`register_pressure_handler` / :func:`free_pressure` — the ladder's
  give-memory-back rung: the handlers (a serving engine parks KV blocks),
  then the reference's cold-executable eviction: the lazy engine's cold
  CUDA graphs, whose pools pin memory (``core.lazy.evict_cold``, all but
  the most recently used; ``evicted_executables``). What a torch
  out-of-memory leaves pinned besides is the failed step's gradients and
  the caching allocator's reserved-but-free blocks, so the rung drops the
  given parameters' ``.grad``, collects garbage and empties the cache, and
  reports the bytes released.
* :func:`note_oom` counts (``hbm_oom_trips``) and records one classified
  exhaustion in a bounded event ring (:func:`recent_ooms`); the first use
  of the module's state registers the ``hbm`` flight-recorder context
  provider (budget, last prediction, event tail, attributions, census).
* :func:`post_mortem` writes the flight dump of an exhaustion recovery could
  not absorb (``hbm_exhausted``), with the device's allocator
  :func:`census`, the budget, the per-step-program attributions and every
  recovery attempt.
"""
from __future__ import annotations

import collections
import gc
import threading
import warnings
import weakref
from typing import Callable, Dict, List, Optional

import torch

from .. import profiler as _prof
from ..profiler import counter_inc, flight, memory_stats

__all__ = [
    "HbmBudgetExceeded", "HbmExhausted", "is_oom", "classify", "note_oom",
    "preflight", "free_pressure", "budget_bytes", "last_prediction",
    "attributions", "note_executable", "analyze_compiled", "post_mortem",
    "register_pressure_handler", "unregister_pressure_handler",
    "recent_ooms", "census",
]

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


class HbmBudgetExceeded(RuntimeError):
    """Preflight admission rejected a step: the predicted footprint would
    exceed the device budget. Raised BEFORE the step touches the device —
    nothing was launched and no state changed. Carries the numbers the
    message names so callers can react programmatically."""

    def __init__(self, where: str, predicted_bytes: int, live_bytes: int,
                 budget_bytes: int, peak_bytes: int = 0):
        super().__init__(
            f"HBM admission rejected dispatch at '{where}': predicted "
            f"{predicted_bytes} bytes (live census {live_bytes} + executable "
            f"peak {peak_bytes}) exceeds budget {budget_bytes} bytes "
            f"(FLAGS_hbm_admission=enforce; raise FLAGS_hbm_budget_bytes, "
            f"free buffers, or shrink the step)")
        self.where = where
        self.predicted_bytes = int(predicted_bytes)
        self.live_bytes = int(live_bytes)
        self.budget_bytes = int(budget_bytes)
        self.peak_bytes = int(peak_bytes)


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


# -- budget -------------------------------------------------------------------
_budget_cache: List[Optional[int]] = [None]  # resolved once per process


def budget_bytes(refresh: bool = False) -> int:
    """The device budget the admission check compares against:
    ``FLAGS_hbm_budget_bytes`` when set, else the current card's capacity
    (``torch.cuda.get_device_properties(d).total_memory``) less
    ``FLAGS_hbm_reserve_bytes``. 0 = no budget (no CUDA device): admission
    still predicts and attributes, never rejects. The capacity is the
    card's whole memory, of which the CUDA context takes a share the
    caching allocator can never have."""
    from ..framework import flags

    explicit = int(flags.flag("FLAGS_hbm_budget_bytes", 0) or 0)
    if explicit:
        return explicit
    if _budget_cache[0] is None or refresh:
        cap = 0
        if torch.cuda.is_available():
            cap = int(torch.cuda.get_device_properties(
                torch.cuda.current_device()).total_memory)
        if cap:
            cap = max(cap - int(flags.flag("FLAGS_hbm_reserve_bytes", 0)
                                or 0), 0)
        _budget_cache[0] = cap
    return _budget_cache[0]


# -- per-step-program attribution registry ------------------------------------
_ATTR_MAX = 256
_attr: "collections.OrderedDict" = collections.OrderedDict()  # guarded_by: _lock
_last: Dict[str, int] = {}  # most recent preflight numbers
_warned: set = set()  # guarded_by: _lock


def note_executable(key: str, mem: Optional[dict]) -> None:
    """Record one step program's footprint, keyed by its signature — the
    post-mortem's attribution table."""
    if mem is None:
        return
    with _lock:
        _attr[key] = dict(mem)
        _attr.move_to_end(key)
        while len(_attr) > _ATTR_MAX:
            _attr.popitem(last=False)
    _ensure_provider()


def analyze_compiled(compiled, key: Optional[str] = None) -> Optional[dict]:
    """``cost_model.executable_memory`` + registry note in one call; in the
    port ``compiled`` is the ``cost_model.MeasuredStep`` of one of a
    program's first calls."""
    from ..cost_model import executable_memory

    mem = executable_memory(compiled)
    if mem is not None and key is not None:
        note_executable(key, mem)
    return mem


def attributions(top: int = 16) -> List[dict]:
    """The per-step-program memory table, largest peak first."""
    with _lock:
        rows = [{"key": k, **v} for k, v in _attr.items()]
    rows.sort(key=lambda r: -r.get("peak_bytes", 0))
    return rows[:top]


def last_prediction() -> Dict[str, int]:
    """Most recent preflight numbers (predicted/live/budget bytes)."""
    return dict(_last)


# -- preflight admission ------------------------------------------------------
def preflight(mem: Optional[dict], where: str, span=None,
              donated_bytes: int = 0,
              device=None) -> Optional[Dict[str, int]]:
    """Compare a step program's predicted footprint against the device
    budget BEFORE the step runs. ``mem`` is the program's
    ``executable_memory`` dict (None predicts nothing and admits).

    Estimate = the live census (``profiler.memory_census(device)``) + temp
    + output - max(alias, donated) bytes, plus ``hbm.pressure`` chaos
    bytes while armed: the arguments are already IN the census, and
    outputs that reuse donated inputs must not count twice.

    Policy per ``FLAGS_hbm_admission``: ``warn`` warns once per site,
    ``enforce`` raises :class:`HbmBudgetExceeded`. Callers gate on the flag
    — this function is never reached when admission is ``off``."""
    from ..framework import flags

    _ensure_provider()
    live = int(_prof.memory_census(device).get("live_bytes", 0))
    if mem is None:
        if span is not None:
            span.set(hbm_live_bytes=live)
        return None
    extra = (int(mem.get("temp_bytes", 0)) + int(mem.get("output_bytes", 0))
             - max(int(mem.get("alias_bytes", 0)), int(donated_bytes)))
    extra = max(extra, 0)
    pressure = 0
    from . import inject as _inject

    if _inject._armed:
        pressure = _inject.pressure_bytes()
    predicted = live + extra + pressure
    budget = budget_bytes()
    peak = int(mem.get("peak_bytes", 0))
    counter_inc("hbm_admission_checks")
    _last.update(
        hbm_predicted_peak_bytes=predicted, hbm_live_bytes=live,
        hbm_extra_bytes=extra, hbm_budget_bytes=budget,
        hbm_exec_peak_bytes=peak)
    if span is not None:
        span.set(hbm_predicted_peak_bytes=predicted, hbm_live_bytes=live,
                 hbm_extra_bytes=extra, hbm_budget_bytes=budget)
    if budget and predicted > budget:
        counter_inc("hbm_admission_rejects")
        mode = str(flags.flag("FLAGS_hbm_admission", "off"))
        if mode == "enforce":
            raise HbmBudgetExceeded(where, predicted, live, budget, peak)
        with _lock:
            first = where not in _warned
            _warned.add(where)
        if first:
            warnings.warn(
                f"HBM admission: predicted {predicted} bytes exceeds budget "
                f"{budget} bytes at '{where}' (FLAGS_hbm_admission=warn — "
                f"dispatching anyway)", RuntimeWarning)
    return _last.copy()


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


def free_pressure(reason: str = "oom", params=(), device=None) -> dict:
    """The ladder's give-memory-back rung: run every registered pressure
    handler (a serving engine parks KV blocks), then drop the ``.grad`` of
    ``params`` (a failed step's partial gradients), collect garbage (a
    failed step's graph) and, on a CUDA device, return the caching
    allocator's free blocks to the device (``torch.cuda.empty_cache``).
    Returns a summary that joins the recovery-attempt record:
    ``evicted_executables`` (the lazy engine's cold graphs evicted),
    ``released_bytes`` (the allocator's reserved bytes given back, or on
    the CPU the census's drop), ``freed_grad_bytes`` and ``live_bytes``."""
    handlers = {}
    for name, fn in list(_pressure_handlers.items()):
        try:
            handlers[name] = fn()
        except Exception as e:
            handlers[name] = {"error": repr(e)}
    cuda = torch.device("cuda" if device is None else device).type \
        == "cuda" and torch.cuda.is_initialized()
    if cuda:
        reserved0 = torch.cuda.memory_reserved(device)
    else:
        reserved0 = int(_prof.memory_census("cpu")["live_bytes"])
    from ..core import lazy

    evicted = lazy.evict_cold(keep=1)
    freed = 0
    for p in params:
        if p.grad is not None:
            freed += p.grad.numel() * p.grad.element_size()
            p.grad = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        released = reserved0 - torch.cuda.memory_reserved(device)
        live = int(torch.cuda.memory_allocated(device))
    else:
        live = int(_prof.memory_census("cpu")["live_bytes"])
        released = reserved0 - live
    return {"reason": reason, "evicted_executables": int(evicted),
            "handlers": handlers, "released_bytes": int(max(released, 0)),
            "freed_grad_bytes": int(freed), "live_bytes": live}


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
    absorb: the device's :func:`census`, the budget, the per-step-program
    attributions and every recovery attempt made. Returns the dump's path
    (None when the recorder is off)."""
    try:
        c = census(device)
    except Exception as e:  # a post-mortem must not raise over the failure
        c = {"error": repr(e)}
    _ensure_provider()
    return flight.dump("hbm_exhausted", extra={
        "where": where,
        "census": c,
        "budget_bytes": budget_bytes(),
        "attributions": attributions(),
        "attempts": list(attempts),
        "exception": repr(exc) if exc is not None else None,
    })


def _context() -> dict:
    with _lock:
        events = list(_events)
    return {"budget_bytes": budget_bytes(), "last_prediction": dict(_last),
            "recent_oom": events[-8:], "attributions": attributions(top=8),
            "census": census()}


def _ensure_provider() -> None:
    """Register the flight context provider on the module's first real use
    (an admission check, a noted footprint, a classified exhaustion): every
    dump from then on carries the budget, the last prediction, the event
    tail, the attributions and the census. Never registered by an
    unconfigured loop that met no exhaustion."""
    global _provider_installed
    with _lock:
        if _provider_installed:
            return
        _provider_installed = True
    flight.add_context_provider("hbm", _context)
