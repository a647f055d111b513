"""Progress-aware heartbeat and collective watchdog (port of
``paddle_tpu/distributed/watchdog.py``).

One dead or wedged rank stalls every collective of its peers silently and
forever. This module turns that into bounded-time, attributed recovery:

* every rank **publishes progress** — ``(step, phase, last span, ts)`` —
  through the store (``PADDLE_TPU_STORE_DIR`` or an explicit store) and/or
  a per-rank file under ``PADDLE_TPU_PROGRESS_DIR`` (``spawn``/``launch``);
* every blocking collective, barrier and host sync runs under a
  **deadline** (``FLAGS_collective_timeout_s``; 0 disables). On expiry the
  rank writes a flight-recorder post-mortem naming the suspected straggler
  or dead rank from the progress table, then exits with the resumable code
  (75), so the launcher relaunches instead of hanging.

Disabled-path contract: with ``FLAGS_collective_timeout_s=0`` the watchdog
adds no host sync and no thread — ``guard`` is a flag probe, ``publish``
without a configured session is one attribute check.

A supervised serving engine publishes ``serve.step`` phase records through
``publish(unit=...)``: sub-records in this rank's progress entry, so the
table carries serving progress without clobbering the training step.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from ..framework import flags as _flags

__all__ = [
    "configure", "reset", "configured", "enabled", "timeout_s", "publish",
    "remove_unit", "local_progress", "progress_table", "suspect", "guard",
    "guarded_wait", "trip", "set_abort_fn",
]

_lock = threading.Lock()
_cfg: Optional[dict] = None          # guarded_by: _lock
_local: Dict[str, object] = {}       # guarded_by: _lock
_last_push = 0.0                     # guarded_by: _lock
_PUSH_INTERVAL_S = 0.2               # rate limit on store/file write-through

# token -> (deadline_monotonic, what)
_guards: Dict[int, Tuple[float, str]] = {}   # guarded_by: _lock
_guard_ids = iter(range(1, 1 << 62)).__next__
_monitor: Optional[threading.Thread] = None  # guarded_by: _lock
_monitor_wake = threading.Event()
_monitor_stop = threading.Event()

_PROGRESS_PREFIX = "wd/progress"


def _snapshot_local_locked() -> dict:
    """Copy of ``_local`` safe to serialize OUTSIDE ``_lock`` (caller must
    hold it): the ``units`` sub-dict is deep-copied, since another thread's
    unit insert during a later ``json.dumps`` on a shallow alias is a
    RuntimeError mid-train-step."""
    rec = dict(_local)
    if "units" in rec:
        rec["units"] = {k: dict(v) for k, v in rec["units"].items()}
    return rec


def _default_abort(code: int) -> None:
    # sys.exit only raises in the calling thread; the wedged thread is
    # blocked in a C call it will never return from. os._exit is the only
    # exit that works from the monitor thread — flush stdio first so the
    # worker's log survives.
    try:
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
    except Exception:
        pass
    os._exit(code)


_abort_fn = _default_abort


def set_abort_fn(fn) -> None:
    """Replace the process-abort action (tests). ``None`` restores os._exit."""
    global _abort_fn
    _abort_fn = fn if fn is not None else _default_abort


# -- session -----------------------------------------------------------------
def configure(
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    store=None,
    progress_dir: Optional[str] = None,
) -> None:
    """Bind this process to a supervision session. Missing values come from
    the launcher env (PADDLE_TRAINER_ID / PADDLE_TRAINERS_NUM /
    PADDLE_TPU_PROGRESS_DIR / PADDLE_TPU_STORE_DIR). Also registers the
    progress table as a flight-recorder context provider, so EVERY crash
    dump carries the cross-rank view."""
    global _cfg, _guards, _local
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if world_size is None:
        world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if progress_dir is None:
        progress_dir = os.environ.get("PADDLE_TPU_PROGRESS_DIR")
    if store is None:
        from .coord import store_from_env

        store = store_from_env()
    if progress_dir:
        os.makedirs(progress_dir, exist_ok=True)
    with _lock:
        # FLAGS_thread_checks: wrap the shared tables so an unguarded
        # mutation anywhere raises at the mutation site (identity when off
        # and when already wrapped)
        from ..analysis import thread_checks

        _guards = thread_checks.guarded(_guards, _lock, "watchdog._guards")
        _local = thread_checks.guarded(_local, _lock, "watchdog._local")
        _cfg = {
            "rank": int(rank),
            "world_size": int(world_size),
            "store": store,
            "progress_dir": progress_dir,
        }
        _local.clear()
        _local.update(rank=int(rank), step=-1, phase="init", span=None, ts=time.time())
    try:
        from ..profiler import flight

        flight.add_context_provider("watchdog", _dump_context)
    except Exception:
        pass


def reset() -> None:
    """Drop the session (tests). Outstanding guards are cleared and the
    monitor thread (if any) is stopped — after reset the process is back to
    the zero-thread disabled state the inert tripwire pins."""
    global _cfg, _monitor, _guards, _local
    with _lock:
        from ..analysis import thread_checks

        # drop configure()'s FLAGS_thread_checks proxies, so the disabled
        # state is the one a fresh import has
        _guards = thread_checks.unwrap(_guards)
        _local = thread_checks.unwrap(_local)
        _cfg = None
        _local.clear()
        _guards.clear()
    t = _monitor
    if t is not None and t.is_alive():
        _monitor_stop.set()
        _monitor_wake.set()
        t.join(timeout=2.0)
    with _lock:
        _monitor = None
    _monitor_stop.clear()
    _monitor_wake.clear()
    try:
        from ..profiler import flight

        flight.remove_context_provider("watchdog")
    except Exception:
        pass


def configured() -> bool:
    return _cfg is not None


def timeout_s() -> float:
    try:
        return float(_flags.flag("FLAGS_collective_timeout_s", 0.0) or 0.0)
    except (TypeError, ValueError):
        return 0.0


def enabled() -> bool:
    return timeout_s() > 0.0


# -- progress ----------------------------------------------------------------
def publish(step: Optional[int] = None, phase: Optional[str] = None,
            span: Optional[str] = None, force: bool = False,
            unit: Optional[str] = None) -> None:
    """Record this rank's progress. Called at step boundaries (engine /
    training loops) and phase transitions (checkpoint, drain). Near-zero
    when no session is configured; the store/file write-through is
    rate-limited to one per ``_PUSH_INTERVAL_S``. Chaos injection points
    ``rank.kill`` / ``rank.hang`` / ``rank.slow`` fire here.

    ``unit`` scopes the record to a named sub-unit of this rank — e.g. a
    supervised serving engine's scheduler thread publishing ``serve.step``
    phase records — landing under ``units[unit]`` in the rank's record
    instead of clobbering the training step/phase, so the progress table
    (and every flight dump carrying it) shows serving progress next to
    training progress."""
    from ..fault import inject as _inject

    cfg = _cfg
    rank = cfg["rank"] if cfg else None
    if _inject._armed and unit is None:
        # rank-level chaos (rank.kill/hang/slow) fires only on RANK-level
        # publishes: a serving engine's unit publish must not evaluate a
        # training-targeted `rank.hang:at=N` against the serving step
        # counter (the serving path has its own serve.* points)
        _inject.chaos(step=step, rank=rank, phase=phase)
    if cfg is None:
        return
    global _last_push
    now = time.time()       # record timestamp: peers compare it cross-process
    mono = time.monotonic()  # rate-limit clock: immune to wall-clock jumps
    with _lock:
        if unit is not None:
            units = _local.setdefault("units", {})
            rec_u = dict(units.get(unit) or {})
            if step is not None:
                rec_u["step"] = int(step)
            if phase is not None:
                rec_u["phase"] = str(phase)
            if span is not None:
                rec_u["span"] = str(span)
            rec_u["ts"] = now
            units[unit] = rec_u
        else:
            if step is not None:
                _local["step"] = int(step)
            if phase is not None:
                _local["phase"] = str(phase)
            if span is not None:
                _local["span"] = str(span)
            # rank-level freshness moves ONLY on rank-level publishes: a
            # live serving engine must not keep a hung training loop's
            # timestamp fresh (suspect() ranks stalest-ts among step ties);
            # unit records carry their own ts above
            _local["ts"] = now
        rec = _snapshot_local_locked()
        due = force or (mono - _last_push) >= _PUSH_INTERVAL_S
        if due:
            _last_push = mono
    if not due:
        return
    _push_record(rec, cfg)


def _push_record(rec: dict, cfg: dict) -> None:
    """Write one progress record through to the store and/or progress file
    (shared by publish and remove_unit)."""
    payload = json.dumps(rec)
    store = cfg["store"]
    if store is not None:
        try:
            store.set(f"{_PROGRESS_PREFIX}/{cfg['rank']}", payload)
        except Exception:
            pass  # progress is advisory; the heartbeat path has its own retry
    pdir = cfg["progress_dir"]
    if pdir:
        try:
            tmp = os.path.join(pdir, f".rank_{cfg['rank']}.tmp")
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, os.path.join(pdir, f"rank_{cfg['rank']}.json"))
        except Exception:
            pass


def remove_unit(unit: str) -> None:
    """Drop a sub-unit's progress record. A closed or quarantined serving
    engine must not leave a stale ``units`` entry riding every heartbeat
    merge, progress-file write, and flight dump forever — each supervisor
    restart would otherwise accumulate one dead unit per engine
    incarnation. The removal WRITES THROUGH immediately: waiting for the
    next publish would leave the dead unit persisted indefinitely in a
    process where the closed engine was the last publisher."""
    cfg = _cfg
    if cfg is None:
        return
    with _lock:
        units = _local.get("units")
        if not units or units.pop(unit, None) is None:
            return
        rec = _snapshot_local_locked()
    _push_record(rec, cfg)


def local_progress() -> dict:
    """This rank's latest record (merged into the elastic heartbeat value)."""
    with _lock:
        return _snapshot_local_locked()


def _read_progress_dir(pdir: str) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    try:
        names = os.listdir(pdir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("rank_") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(pdir, name)) as f:
                rec = json.load(f)
            out[int(name[len("rank_"):-len(".json")])] = rec
        except Exception:
            continue
    return out


def progress_table(cfg: Optional[dict] = None) -> Dict[int, dict]:
    """Every rank's last published record, keyed by rank. Store records win
    over progress-dir files at the same rank (fresher path)."""
    cfg = cfg or _cfg
    if cfg is None:
        return {}
    table: Dict[int, dict] = {}
    if cfg.get("progress_dir"):
        table.update(_read_progress_dir(cfg["progress_dir"]))
    store = cfg.get("store")
    if store is not None:
        for r in range(cfg["world_size"]):
            try:
                raw = store.get(f"{_PROGRESS_PREFIX}/{r}")
            except Exception:
                continue
            if raw:
                try:
                    table[r] = json.loads(raw)
                except Exception:
                    pass
    return table


def suspect(table: Optional[Dict[int, dict]] = None) -> Tuple[Optional[int], str]:
    """(rank, reason) for the most likely straggler/dead rank: a rank with
    NO record at all, else the rank furthest behind in step, ties broken by
    stalest timestamp. Returns (None, reason) when there is nothing to
    compare (single rank, no session)."""
    cfg = _cfg
    if table is None:
        table = progress_table()
    if cfg is not None:
        # never suspect the REPORTING rank (it is alive enough to be asking);
        # with several silent ranks, name them all — an early-startup hang
        # can predate everyone's first publish
        missing = [
            r for r in range(cfg["world_size"])
            if r not in table and r != cfg["rank"]
        ]
        if missing:
            return missing[0], (
                "no progress record published"
                + (f" (also missing: ranks {missing[1:]})" if missing[1:] else "")
            )
    others = {
        r: rec for r, rec in table.items()
        if cfg is None or r != cfg["rank"]
    } or table
    if not others:
        return None, "no progress records"
    sus = min(
        others,
        key=lambda r: (others[r].get("step", -1), others[r].get("ts", 0.0)),
    )
    rec = others[sus]
    return sus, (
        f"behind at step {rec.get('step')} phase {rec.get('phase')!r} "
        f"(last heard {time.time() - rec.get('ts', 0.0):.1f}s ago)"
    )


def _dump_context() -> dict:
    cfg = _cfg
    table = progress_table()
    sus, why = suspect(table)
    return {
        "rank": cfg["rank"] if cfg else None,
        "world_size": cfg["world_size"] if cfg else None,
        "local": local_progress(),
        "progress": {str(k): v for k, v in table.items()},
        "suspect_rank": sus,
        "suspect_reason": why,
    }


# -- deadline guard ----------------------------------------------------------
def trip(what: str, code: Optional[int] = None) -> None:
    """Watchdog verdict: dump the post-mortem naming the suspect, then abort
    with the resumable exit code so the launcher relaunches this rank. The
    terminal action of an expired guard; also callable from interruptible
    waits (store polls) that caught their own DeadlineExceeded."""
    from ..fault.preemption import RESUMABLE_EXIT_CODE

    try:
        from .. import profiler
        from ..profiler import flight

        profiler.counter_inc("watchdog_trips")
        table = progress_table()
        sus, why = suspect(table)
        flight.dump(
            "collective_timeout",
            extra={
                "what": what,
                "timeout_s": timeout_s(),
                "suspect_rank": sus,
                "suspect_reason": why,
            },
        )
    except Exception:
        pass
    _abort_fn(RESUMABLE_EXIT_CODE if code is None else code)


def _monitor_loop() -> None:
    while True:
        _monitor_wake.wait(timeout=0.1)
        _monitor_wake.clear()
        if _monitor_stop.is_set():
            return
        now = time.monotonic()
        expired = None
        with _lock:
            for tok, (deadline, what) in _guards.items():
                if now >= deadline:
                    expired = (tok, what)
                    break
            if expired is not None:
                _guards.pop(expired[0], None)
        if expired is not None:
            trip(expired[1])


def _ensure_monitor() -> None:
    global _monitor
    if _monitor is not None and _monitor.is_alive():
        return
    with _lock:
        if _monitor is not None and _monitor.is_alive():
            return
        t = threading.Thread(target=_monitor_loop, daemon=True, name="paddle-tpu-torch-watchdog")
        t.start()
        _monitor = t


class guard:
    """Deadline scope for an opaque blocking wait (a collective, a stream
    synchronize): arm before blocking, disarm after. When the wait
    never returns the monitor thread trips at the deadline. With the flag at
    0 this is a float compare and nothing else — no thread, no allocation
    beyond the instance."""

    __slots__ = ("what", "_tok")

    def __init__(self, what: str):
        self.what = what
        self._tok = None

    def __enter__(self):
        t = timeout_s()
        if t <= 0.0:
            return self
        # the collective.drop chaos point wedges THIS rank right before it
        # would enter the collective — the canonical "peer never arrives"
        from ..fault import inject as _inject

        if _inject._armed:
            cfg = _cfg
            _inject.chaos_drop(
                rank=cfg["rank"] if cfg else None,
                step=_local.get("step") if cfg else None,
            )
        tok = _guard_ids()
        with _lock:
            _guards[tok] = (time.monotonic() + t, self.what)
        self._tok = tok
        _ensure_monitor()
        return self

    def __exit__(self, *exc):
        if self._tok is not None:
            with _lock:
                _guards.pop(self._tok, None)
            self._tok = None
        return False


def guarded_wait(poll, what: str, timeout: Optional[float] = None,
                 interval_s: float = 0.05) -> None:
    """Interruptible wait with watchdog semantics: poll until truthy; past
    the deadline, dump + resumable abort (same verdict as an expired guard).
    ``timeout=None`` uses FLAGS_collective_timeout_s; both 0 → no deadline."""
    from .coord import DeadlineExceeded, wait_for

    t = timeout_s() if timeout is None else float(timeout)
    try:
        wait_for(poll, what, t, interval_s=interval_s)
    except DeadlineExceeded:
        trip(what)
