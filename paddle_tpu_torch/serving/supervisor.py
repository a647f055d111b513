"""Serving supervision: bounded-time crash and wedge detection with an
engine restart (port of ``paddle_tpu/serving/supervisor.py``).

:class:`ServingSupervisor` wraps an :class:`~.engine.Engine`:

* **detection** — a monitor thread (the supervisor's only thread) watches
  the scheduler thread's aliveness and heartbeat (``Engine._beat``) and
  declares the engine failed within ``FLAGS_serve_watchdog_s``: a *crash*
  (the loop raised; the engine wakes the monitor at once through
  ``_failed``) or a *wedge* (the thread alive, its heartbeat older than 3/4
  of the deadline; 10x that while a step function's first call runs);
* **recovery** — a fresh engine over the same model and configuration.
  After a CRASH the dead loop's state is frozen: queued requests and
  in-flight sequences are requeued, a mid-decode sequence continuing from
  its tokens through the engine's re-prefill path, so greedy outputs equal
  an uninterrupted run's. With ``FLAGS_serve_snapshot`` (or
  ``snapshot=True``) the dead engine's state is captured whole
  (``Engine.snapshot``) and the replacement re-attaches it
  (``Engine.adopt``): the survivors resume mid-decode with no token
  re-prefilled; a capture that fails validation falls back to the requeue.
  After a WEDGE the abandoned thread may still own its sequences, so
  in-flight work fails with a structured ``ServeError`` and the untouched
  queue is requeued (a live wedged thread could tear a capture, so the
  snapshot path is crash-only). ``max_restarts`` exhaustion fails
  everything and marks the supervisor broken;
* **probes and drain** — ``health()``/``ready()`` join the engine's probes
  with the supervisor's state; ``close(drain=True)`` completes the
  outstanding work before stopping;
* **telemetry** — the supervisor registers a flight-recorder context
  provider and writes a ``serving_supervisor_crash``/``_wedge`` post-mortem
  before each recovery (while the failed engine's provider still reports
  its in-flight table); with ``metrics_port`` it owns the telemetry
  endpoint, which keeps its port across restarts (engines are built with
  ``metrics_port=0``); a requeued continuation keeps the original's trace
  id, and its relay is the timeline's last hop.

The distributed watchdog's progress records are not part of this module.
"""
from __future__ import annotations

import copy
import itertools
import queue as _queue
import threading
import time
import weakref
from typing import List, Optional, Tuple

from ..fault import memory as _fmem
from ..framework import flags
from ..profiler import counter_inc, flight, span
from .engine import (DeadlineExceeded, Engine, Readiness, RequestHandle,
                     ServeError, SnapshotError, _finish)

__all__ = ["ServingSupervisor"]

_sup_ids = itertools.count(1)


def _drain_stream(req, inner) -> None:
    """Forward the continuation's streamed tokens into the original
    request's stream (the inner sentinel is skipped: the original's comes
    from its own ``_finish``)."""
    if req.stream_q is None or inner.stream_q is None:
        return
    while True:
        try:
            item = inner.stream_q.get_nowait()
        except _queue.Empty:
            return
        if item is not None:
            req.stream_q.put(item)


def _relay_many(pairs) -> None:
    """One relay thread per recovery: a polling multiplexer that forwards
    each continuation's stream tokens and terminal state into the client's
    ORIGINAL request, and passes late cancels on. A continuation caught by
    a second crash resolves through the next recovery's relay; this loop
    keeps waiting on its done event."""
    pending = list(pairs)
    while pending:
        still = []
        for req, handle in pending:
            inner = handle._req
            if req.cancelled and not inner.cancelled:
                handle.cancel()
            _drain_stream(req, inner)
            if inner.done.is_set():
                # the sentinel lands BEFORE done.set(): one more drain
                # cannot miss tokens; count=False, as the new engine
                # already counted the continuation's outcome
                _drain_stream(req, inner)
                if inner.error is not None:
                    _finish(req, error=inner.error, count=False)
                else:
                    _finish(req, tokens=inner.tokens, count=False)
                counter_inc("serve_relayed")
                if req.trace is not None:
                    # a recovered request's timeline: the relay is its last
                    # hop
                    from . import observe as _observe

                    _observe.on_relay(
                        req, len(inner.tokens or ()),
                        None if inner.error is None
                        else type(inner.error).__name__)
            else:
                still.append((req, handle))
        pending = still
        if pending:
            time.sleep(0.02)


def _monitor_loop(wr) -> None:
    """Monitor thread body; holds the supervisor through a weakref (an
    abandoned supervisor stays collectable and its ``__del__`` closes
    it)."""
    while True:
        sup = wr()
        if sup is None or sup._stop.is_set():
            return
        with sup._lock:
            eng = sup._engine
            broken = sup._broken
        kind = err = None
        if eng is not None and broken is None and not eng._stop:
            if eng._failed.is_set() or not eng._thread.is_alive():
                kind = "crash"
                err = eng._broken or ServeError(
                    "serving engine scheduler thread exited unexpectedly")
            else:
                age = time.monotonic() - eng._beat
                limit = sup._stale_s * (10.0 if eng._compiling else 1.0)
                if age > limit:
                    kind = "wedge"
                    err = ServeError(
                        f"serving engine scheduler thread wedged: heartbeat "
                        f"stale {age:.2f}s (watchdog {sup.watchdog_s}s"
                        + (", compile grace 10x exhausted)" if eng._compiling
                           else ")"))
        if kind is not None:
            try:
                sup._recover(eng, kind, err)
            except Exception as e:  # a failed recovery breaks the supervisor
                if _fmem.is_oom(e):
                    # the replacement's pool allocation can itself exhaust
                    _fmem.note_oom("serve.respawn", e)
                with sup._lock:
                    if sup._broken is None:
                        sup._broken = e
                sup._fail_all(ServeError(f"serving recovery failed: {e!r}"))
            continue  # re-evaluate at once against the fresh engine
        poll = sup._poll_s
        # wait on the crash event only while it can still trigger a
        # recovery: after exhaustion or a deliberate stop it stays set, and
        # waiting on it would spin this thread
        evt = (eng._failed if eng is not None and broken is None
               and not eng._stop and not eng._failed.is_set()
               else sup._stop)
        del sup, eng
        evt.wait(timeout=poll)


class ServingSupervisor:
    """Crash and wedge supervision over a serving :class:`Engine`:
    ``submit``/``generate``/``stats`` go to the current engine and survive
    restarts. ``model``, ``config`` and the keyword overrides are what each
    engine is built from (``device`` among them)."""

    def __init__(self, model, config=None, max_restarts: int = 3,
                 watchdog_s: Optional[float] = None,
                 snapshot: Optional[bool] = None, **overrides):
        self.watchdog_s = float(
            watchdog_s if watchdog_s is not None
            else flags.flag("FLAGS_serve_watchdog_s", 10.0))
        # crash-recovery re-attach, resolved once: unconfigured, the
        # snapshot/adopt code is never reached
        self._snapshot = bool(
            snapshot if snapshot is not None
            else flags.flag("FLAGS_serve_snapshot", False))
        if self.watchdog_s < 1.0:
            # an idle engine refreshes its heartbeat every 0.5 s (its
            # condition wait): a shorter limit would call it wedged
            raise ValueError("supervisor: watchdog_s must be >= 1.0")
        # staleness trips at 3/4 of the deadline and the poll adds at most
        # 1/5: detection within ~0.95 * watchdog_s
        self._stale_s = 0.75 * self.watchdog_s
        self._poll_s = max(0.02, min(0.5, self.watchdog_s / 5.0))
        self.max_restarts = int(max_restarts)
        self._model = model
        self._config = copy.copy(config) if config is not None else None
        self._overrides = dict(overrides)
        self._t_start = time.monotonic()
        # the SUPERVISOR owns the telemetry port: the probes must survive
        # engine restarts, and a replacement re-binding the port mid-recovery
        # would race the dying engine, so engines are built with port 0
        if self._config is not None:
            self._metrics_port = self._config.metrics_port
            self._config.metrics_port = 0
        else:
            self._metrics_port = self._overrides.pop("metrics_port", None)
            self._overrides["metrics_port"] = 0
        if self._metrics_port is None:
            self._metrics_port = flags.flag("FLAGS_serve_metrics_port", 0)
        self._metrics_port = int(self._metrics_port or 0)
        if self._metrics_port < 0:
            raise ValueError("supervisor: metrics_port must be >= 0 (0 = off)")
        self._lock = threading.Lock()
        self._engine: Optional[Engine] = self._spawn()  # guarded_by: _lock
        self._restarts = 0  # guarded_by: _lock
        self._broken: Optional[BaseException] = None  # guarded_by: _lock
        self._relays: List[threading.Thread] = []  # guarded_by: _lock
        # the latest recovery: mode "none" | "reattach" | "reprefill"
        self._last_recovery = {"mode": "none"}  # guarded_by: _lock
        self._stop = threading.Event()
        self._provider = f"paddle_tpu_torch_serving_supervisor_{next(_sup_ids)}"
        wr = weakref.ref(self)
        flight.add_context_provider(
            self._provider,
            lambda _wr=wr: (s._flight_context() if (s := _wr()) is not None
                            else {"closed": True}))
        self._monitor = threading.Thread(
            target=_monitor_loop, args=(wr,), daemon=True,
            name=self._provider)
        self._monitor.start()
        self._endpoint = None
        if self._metrics_port:
            from . import observe as _observe

            self._endpoint = _observe.start_endpoint(self, self._metrics_port)

    def _spawn(self) -> Engine:
        from ..distributed import watchdog

        eng = Engine(self._model, config=self._config, **self._overrides)
        eng._supervised = True
        eng._watchdog = watchdog
        return eng

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids, **kw) -> RequestHandle:
        """Submit to the current engine (any thread), waiting out a restart
        in progress (bounded by ~2x the watchdog deadline) rather than
        surfacing the dead engine's ServeError. Structured rejections
        (Overloaded, DeadlineExceeded, validation) pass through."""
        deadline = time.monotonic() + 2.0 * self.watchdog_s + 5.0
        while True:
            with self._lock:
                broken, eng = self._broken, self._engine
            if broken is not None or eng is None:
                raise ServeError("serving supervisor is broken") from broken
            try:
                return eng.submit(prompt_ids, **kw)
            except ServeError:
                if eng._broken is None and not eng._stop:
                    raise  # a real rejection (Overloaded, draining)
                if self._stop.is_set() or time.monotonic() >= deadline:
                    raise
                time.sleep(self._poll_s)  # the monitor is swapping engines

    def generate(self, prompt_ids, **kw):
        return self.submit(prompt_ids, **kw).result()

    def stats(self) -> dict:
        with self._lock:
            eng, restarts = self._engine, self._restarts
        st = eng.stats() if eng is not None else {}
        st["restarts"] = restarts
        return st

    @property
    def restarts(self) -> int:
        with self._lock:
            return self._restarts

    def health(self) -> dict:
        """The current engine's liveness joined with the supervisor's state;
        ``ok`` needs both. ``last_recovery`` is the supervisor's record (it
        also covers requeue-only and wedge recoveries)."""
        with self._lock:
            eng, restarts, broken = self._engine, self._restarts, self._broken
            last = dict(self._last_recovery)
        t_rec = last.pop("t", None)
        if t_rec is not None:
            last["age_s"] = round(time.monotonic() - t_rec, 3)
        h = eng.health() if eng is not None else {"ok": False}
        h.update(restarts=restarts, max_restarts=self.max_restarts,
                 watchdog_s=self.watchdog_s, supervisor_ok=broken is None,
                 supervisor_uptime_s=round(time.monotonic() - self._t_start,
                                           3),
                 last_recovery=last)
        h["ok"] = bool(h.get("ok") and broken is None)
        return h

    def ready(self) -> Readiness:
        with self._lock:
            broken, eng = self._broken, self._engine
        sup_up = round(time.monotonic() - self._t_start, 3)
        if broken is not None or eng is None:
            return Readiness(ready=False, reason="supervisor_broken",
                             supervisor_uptime_s=sup_up)
        r = eng.ready()
        r["supervisor_uptime_s"] = sup_up
        return r

    def debug_requests(self) -> list:
        with self._lock:
            eng = self._engine
        return [] if eng is None else eng.debug_requests()

    def close(self, timeout: float = 30.0, drain: bool = False) -> None:
        """Stop monitoring, then the engine (``drain=True`` completes the
        queued and running work first); outstanding relays are joined.
        Idempotent."""
        self._stop.set()
        if self._monitor is not None \
                and self._monitor is not threading.current_thread():
            self._monitor.join(timeout=max(1.0, 2.0 * self._poll_s))
        # looped: a recovery mid-flight when _stop landed may still install
        # a replacement (its install re-checks _stop, so this ends in <= 2)
        closed = set()
        while True:
            with self._lock:
                eng = self._engine
            if eng is None or id(eng) in closed:
                break
            closed.add(id(eng))
            eng.close(timeout=timeout, drain=drain)
        with self._lock:
            relays = list(self._relays)
        for t in relays:  # their continuation handles just resolved
            t.join(timeout=2.0)
        if self._endpoint is not None:
            self._endpoint.close()
            self._endpoint = None
        flight.remove_context_provider(self._provider)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close(timeout=2.0)
        except Exception:
            pass

    # ------------------------------------------------------------- recovery
    def _recover(self, old: Engine, kind: str, err: BaseException) -> None:
        t_detect = time.monotonic()
        with self._lock:
            if self._engine is not old or self._stop.is_set():
                return  # stale detection: recovered already, or closing
            exhausted = self._restarts >= self.max_restarts
            if exhausted:
                self._broken = ServeError(
                    f"serving supervisor: max_restarts={self.max_restarts} "
                    f"exhausted ({err})")
            else:
                self._restarts += 1
            restarts = self._restarts
        counter_inc("serve_wedge_detected" if kind == "wedge"
                    else "serve_crash_detected")
        # the post-mortem BEFORE the quarantine: the failed engine's context
        # provider still reports its in-flight table
        try:
            flight.dump(f"serving_supervisor_{kind}",
                        extra={"reason": str(err), "restarts": restarts,
                               "exhausted": exhausted})
        except Exception:
            pass  # a failed dump must not stop the recovery
        # quarantine: a bounded wedge that wakes later must exit at its next
        # check instead of driving a restarted request's stream
        old._broken = old._broken or err
        with old._cv:
            old._stop = True
        flight.remove_context_provider(old._provider)
        _fmem.unregister_pressure_handler(old._provider)
        if old._watchdog is not None:
            try:  # the dead engine's progress-table unit goes with it
                old._watchdog.remove_unit(old._provider)
            except Exception:
                pass
        # capture BEFORE the harvest empties the dead loop's lists; crash
        # only (a live wedged thread could tear it). A failed capture falls
        # back to the requeue, never breaks the recovery.
        snap = None
        if self._snapshot and kind == "crash" and not exhausted:
            try:
                snap = old.snapshot()
            except Exception as e:
                if _fmem.is_oom(e):
                    _fmem.note_oom("serve.snapshot", e)
                counter_inc("serve_snapshot_failed")
                snap = None
        work = self._harvest(old, kind, err)
        if exhausted:
            for req, _prefix, why in work:
                _finish(req, error=why or ServeError(
                    f"serving supervisor gave up after "
                    f"{self.max_restarts} restarts: {err}"))
            return
        with span("supervise_restart", kind=kind, restarts=restarts,
                  work=len(work), snapshot=snap is not None):
            try:
                info = self._restart(work, restarts, snap)
            except BaseException as e:
                # the harvest emptied the old engine's lists, so nothing else
                # can finish these handles: fail them here
                for req, _prefix, why in work:
                    _finish(req, error=why or ServeError(
                        f"serving engine restart failed: {e!r}"))
                raise  # the monitor marks the supervisor broken
        dur = time.monotonic() - t_detect
        counter_inc("serve_restart_mttr_ms", max(1, int(dur * 1000)))
        rec = {
            "mode": "none" if info is None
            else ("reattach" if info.get("adopted") else "reprefill"),
            "kind": kind,
            "reattached": 0 if info is None else info.get("reattached", 0),
            "blocks_reattached": (0 if info is None
                                  else info.get("blocks_reattached", 0)),
            "reprefill_tokens_saved": (
                0 if info is None else info.get("reprefill_tokens_saved", 0)),
            "requeued": 0 if info is None else info.get("requeued", 0),
            "duration_s": round(dur, 6),
            "t": time.monotonic(),  # health() reports it as age_s
        }
        with self._lock:
            self._last_recovery = rec

    def _restart(self, work, restarts: int, snap=None):
        """Spawn and install the replacement. With a snapshot it adopts that
        first (strictly: a ``SnapshotError`` falls back to the requeue for
        everything); re-attached requests live on in the new engine under
        their ORIGINAL handles, the rest go through the requeue and the
        relay. Returns the recovery info (None when a racing close()
        aborted it)."""
        new = self._spawn()
        installed: set = set()
        adopt_info = None
        if snap is not None:
            eligible = {req.id for req, _p, why in work if why is None}
            try:
                with span("serve_adopt_on_restart", restarts=restarts):
                    adopt_info = new.adopt(snap, only=eligible,
                                           fallback="raise")
                installed = set(adopt_info["installed"])
            except SnapshotError:
                adopt_info = None  # serve_snapshot_rejected counted in adopt
            except Exception as e:
                if _fmem.is_oom(e):
                    _fmem.note_oom("serve.adopt", e)
                counter_inc("serve_snapshot_failed")
                adopt_info = None
        with self._lock:
            # a close() that raced this recovery must not leave a live
            # replacement behind it
            aborted = self._stop.is_set()
            if not aborted:
                self._engine = new
        if aborted:
            new.close(timeout=5.0)
            for req, _prefix, why in work:
                _finish(req, error=why or ServeError(
                    "serving supervisor closed during recovery"))
            return None
        counter_inc("serve_restarts")
        pairs = []
        requeued = 0
        for req, prefix, why in work:
            if why is not None:
                _finish(req, error=why)
            elif req.id in installed:
                continue  # re-attached: live in the new engine
            else:
                requeued += 1
                pair = self._requeue(new, req, prefix)
                if pair is not None:
                    pairs.append(pair)
        if pairs:
            t = threading.Thread(target=_relay_many, args=(pairs,),
                                 daemon=True, name=f"serve-relay-r{restarts}")
            with self._lock:
                self._relays = [r for r in self._relays
                                if r.is_alive()] + [t]
            t.start()
        info = dict(adopt_info or {})
        info["adopted"] = adopt_info is not None
        info["requeued"] = requeued
        return info

    def _harvest(self, old: Engine, kind: str, err: BaseException
                 ) -> List[Tuple[object, Optional[list],
                                 Optional[BaseException]]]:
        """The failed engine's pending requests as ``(request, tokens or
        None, error or None)``. A crash freezes the loop's state, so
        everything requeues; a wedged thread may still hold its in-flight
        sequences, so those fail while the untouched queue requeues."""
        with old._cv:
            queued = list(old._waiting)
            old._waiting.clear()
        seqs = list(old._admitting) + list(old._running) + list(old._resume) \
            + list(old._prefilling)
        if kind == "crash":
            old._running, old._resume, old._admitting = [], [], []
            old._prefilling = []
        now = time.monotonic()
        work: List[Tuple[object, Optional[list],
                         Optional[BaseException]]] = []
        # a crash inside a prefill leaves landed rows in BOTH _admitting and
        # _running: dedupe by id, or a stream would get two relays
        seen = set()
        for req in queued:
            if req.done.is_set() or req.id in seen:
                continue
            seen.add(req.id)
            if req.deadline is not None and now >= req.deadline:
                work.append((req, None, DeadlineExceeded(
                    f"request {req.id} deadline expired during engine "
                    f"recovery", request_id=req.id)))
            else:
                work.append((req, None, None))
        for s in seqs:
            req = s.req
            if req.done.is_set() or req.id in seen:
                continue
            seen.add(req.id)
            if kind == "wedge":
                work.append((req, None, ServeError(
                    f"request {req.id} lost: engine scheduler thread wedged "
                    f"mid-flight ({s.generated}/{req.max_new_tokens} "
                    f"generated)")))
            elif req.deadline is not None and now >= req.deadline:
                work.append((req, None, DeadlineExceeded(
                    f"request {req.id} deadline expired during engine "
                    f"recovery", request_id=req.id)))
            else:
                work.append((req, list(s.tokens), None))
        return work

    def _requeue(self, new: Engine, req, prefix: Optional[list]):
        """Resubmit one harvested request on the fresh engine; returns the
        ``(original request, continuation handle)`` pair for the relay, or
        None when it resolved here. ``prefix`` is a mid-flight sequence's
        prompt + generated tokens: submitted as the continuation's prompt it
        re-prefills as the engine's own preemption does, so greedy decode
        continues unchanged."""
        prompt = list(prefix) if prefix is not None else list(req.prompt)
        generated = len(prompt) - len(req.prompt)
        remaining = req.max_new_tokens - generated
        # a crash during retirement can harvest a finished sequence: its
        # tokens are the result (a continuation past eos would be wrong)
        gen = prompt[len(req.prompt):]
        if req.eos_token_id is not None and req.eos_token_id in gen:
            cut = len(req.prompt) + gen.index(req.eos_token_id) + 1
            _finish(req, tokens=prompt[:cut])
            return None
        if remaining < 1:
            _finish(req, tokens=prompt)
            return None
        dl = (None if req.deadline is None
              else max(1e-3, req.deadline - time.monotonic()))
        try:
            # _shed_exempt: the old engine already accepted this work;
            # _trace: the continuation keeps the original's trace id, so the
            # recovered request has ONE timeline across engines
            h = new.submit(prompt, max_new_tokens=remaining,
                           eos_token_id=req.eos_token_id,
                           temperature=req.temperature,
                           stream=req.stream_q is not None,
                           deadline_s=dl, priority=req.priority,
                           _shed_exempt=True, _trace=req.trace)
        except Exception as e:
            _finish(req, error=e if isinstance(e, ServeError)
                    else ServeError(f"requeue after restart failed: {e!r}"))
            return None
        counter_inc("serve_requeued")
        if prefix is not None:
            # a mid-flight survivor re-prefilled: the tokens a snapshot
            # re-attach would have saved
            counter_inc("serve_reprefill_tokens", len(prompt))
        return (req, h)

    def _fail_all(self, err: BaseException) -> None:
        with self._lock:
            eng = self._engine
        if eng is not None:
            eng._fail_outstanding(err)

    # -- flight-recorder context ----------------------------------------------
    def _flight_context(self) -> dict:
        with self._lock:
            eng, restarts, broken = self._engine, self._restarts, self._broken
        return {
            "restarts": restarts,
            "max_restarts": self.max_restarts,
            "watchdog_s": self.watchdog_s,
            "supervisor_ok": broken is None,
            "engine": None if eng is None else {
                "thread_alive": eng._thread.is_alive(),
                "beat_age_s": round(time.monotonic() - eng._beat, 3),
                "broken": repr(eng._broken) if eng._broken else None,
            },
        }
