"""Elastic training: heartbeats, fault detection and relaunch (port of
``paddle_tpu/distributed/fleet/elastic/__init__.py``).

The reference's manager keeps membership on etcd (``manager.py``); here
the key-value substrate is a store with the ``set/get/add/delete_key``
surface (``distributed.TCPStore``, over ``torch.distributed.TCPStore``, or
``coord.FileStore``), so nothing outside the job is needed. Workers
register and heartbeat (``init_parallel_env`` does it under
``launch(elastic=True)``); the launcher's watch loop reads the heartbeats
and relaunches on a failure, and on a preemption drain's resumable exit
(75) without spending the failure budget.
"""
from __future__ import annotations

import json
import threading
import time
from enum import Enum
from typing import Callable, Dict, List, Optional

from ....fault import inject as _inject
from ....fault.preemption import RESUMABLE_EXIT_CODE
from ....fault.retry import retry_call


class ElasticStatus(Enum):
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"       # membership stable
    RESTART = "restart" # membership changed: relaunch with new world
    EXIT = "exit"


class ElasticManager:
    """Heartbeat-based membership tracking over a store.

    Workers call ``register()`` (spawns a heartbeat thread); the launcher-side
    watcher calls ``watch()`` each interval and reacts to scale events —
    the reference manager.py watch/_match/_update_hosts loop, minus etcd.
    """

    PREFIX = "elastic"

    def __init__(
        self,
        store,
        np_target: int,
        worker_id: Optional[str] = None,
        heartbeat_interval: float = 1.0,
        timeout: float = 5.0,
        min_np: Optional[int] = None,
        max_np: Optional[int] = None,
        store_retries: int = 3,
        retry_base_delay: float = 0.05,
    ):
        self.store = store
        self.np_target = int(np_target)
        self.min_np = int(min_np or np_target)
        self.max_np = int(max_np or np_target)
        self.worker_id = worker_id
        self.heartbeat_interval = float(heartbeat_interval)
        self.timeout = float(timeout)
        self.store_retries = int(store_retries)
        self.retry_base_delay = float(retry_base_delay)
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._last_world: Optional[List[str]] = None

    def _store_op(self, fn, *args):
        """Every store round-trip goes through the shared retry-with-backoff
        helper (fault/retry.py) behind the ``store.op`` injection point — one
        transient TCPStore error must not mark a worker dead or kill the
        heartbeat thread."""

        def op():
            _inject.check("store.op")
            return fn(*args)

        return retry_call(
            op,
            retries=self.store_retries,
            base_delay=self.retry_base_delay,
            exceptions=(OSError, ConnectionError, TimeoutError, RuntimeError),
        )

    # -- worker side -------------------------------------------------------
    def _hb_key(self, wid):
        return f"{self.PREFIX}/hb/{wid}"

    def register(self):
        """Join the membership and start heartbeating (reference
        collective.py worker register + manager heartbeat thread)."""
        assert self.worker_id is not None, "worker_id required to register"
        self._store_op(self.store.add, f"{self.PREFIX}/registered", 1)
        self._beat()
        self._stop.clear()
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True)
        self._hb_thread.start()
        return self

    def _beat(self):
        # the heartbeat is progress-AWARE: it carries the rank's last
        # published (step, phase, span) record, so the watcher can tell a
        # live-but-stuck rank (fresh ts, stale step) from a dead one (stale
        # ts) and the watchdog can name the straggler
        rec = {"ts": time.time()}
        try:
            from ...watchdog import local_progress

            rec.update(local_progress())
            rec["ts"] = time.time()  # heartbeat freshness wins over publish ts
        except Exception:
            pass
        self._store_op(self.store.set, self._hb_key(self.worker_id), json.dumps(rec))

    def _hb_loop(self):
        # each _beat already retries with backoff; only give up (and let the
        # watcher declare us dead) after several beats fail THROUGH their
        # retries — i.e. the store is persistently gone, not hiccuping
        consecutive = 0
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
                consecutive = 0
            except Exception:
                consecutive += 1
                if consecutive >= 3:
                    return

    def deregister(self):
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2)
            self._hb_thread = None
        try:
            self.store.delete_key(self._hb_key(self.worker_id))
        except Exception:
            pass

    # -- watcher side ------------------------------------------------------
    def alive_workers(self, known_ids: List[str]) -> List[str]:
        now = time.time()
        alive = []
        for wid in known_ids:
            try:
                raw = self._store_op(self.store.get, self._hb_key(wid))
            except Exception:
                continue  # persistent store failure: treat as no heartbeat
            if not raw:
                continue
            try:
                ts = json.loads(raw)["ts"]
            except Exception:
                continue
            if now - ts <= self.timeout:
                alive.append(wid)
        return alive

    def progress(self, known_ids: List[str]) -> Dict[str, dict]:
        """Watcher-side view of every worker's last heartbeat record
        (ts + the rank's step/phase/span progress): the launcher includes
        this in its failure report so a dead rank's last known position
        survives the relaunch."""
        out: Dict[str, dict] = {}
        for wid in known_ids:
            try:
                raw = self._store_op(self.store.get, self._hb_key(wid))
            except Exception:
                continue
            if not raw:
                continue
            try:
                out[wid] = json.loads(raw)
            except Exception:
                continue
        return out

    def watch(self, known_ids: List[str]) -> ElasticStatus:
        """One watch tick (reference manager.py:398 watch loop)."""
        alive = self.alive_workers(known_ids)
        if not self._last_world:
            # the world forms at the first tick that hears a heartbeat: a
            # worker still starting up (before its first beat) is not a
            # membership change
            self._last_world = alive
        if len(alive) == 0:
            return ElasticStatus.EXIT
        if len(alive) < self.min_np:
            # below the floor: fault — wait for relaunch
            self._last_world = alive
            return ElasticStatus.ERROR
        if set(alive) != set(self._last_world):
            self._last_world = alive
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def world(self) -> List[str]:
        return list(self._last_world or [])


class ElasticLauncher:
    """Supervise worker processes with elastic restarts (reference
    fleet/launch.py elastic mode + manager relaunch)."""

    def __init__(self, spawn_fn: Callable[[List[str]], Dict[str, object]],
                 manager: ElasticManager, watch_interval: float = 1.0,
                 max_restarts: int = 3, max_resumes: int = 32):
        self.spawn_fn = spawn_fn
        self.manager = manager
        self.watch_interval = watch_interval
        self.max_restarts = max_restarts
        # preemption-drain exits (RESUMABLE_EXIT_CODE) are normal operations,
        # not failures: they get their own (much larger) budget
        self.max_resumes = max_resumes

    def _respawn(self, procs, worker_ids):
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            p.wait()
        return self.spawn_fn(worker_ids)

    def run(self, worker_ids: List[str]):
        restarts = 0
        resumes = 0
        procs = self.spawn_fn(worker_ids)
        while True:
            time.sleep(self.watch_interval)
            # process exits take precedence over heartbeat staleness
            codes = {w: p.poll() for w, p in procs.items()}
            if all(c == 0 for c in codes.values()):
                return 0
            failed = [
                w for w, c in codes.items()
                if c not in (None, 0, RESUMABLE_EXIT_CODE)
            ]
            if not failed and any(c == RESUMABLE_EXIT_CODE for c in codes.values()):
                # clean preemption drain: the worker checkpointed and asked
                # for a restart — relaunch without consuming the failure
                # budget (resume comes from AutoCheckpoint on the worker side)
                resumes += 1
                if resumes > self.max_resumes:
                    for p in procs.values():
                        if p.poll() is None:
                            p.terminate()
                    raise RuntimeError(
                        f"elastic: exceeded max_resumes={self.max_resumes} "
                        "preemption restarts"
                    )
                procs = self._respawn(procs, worker_ids)
                continue
            status = self.manager.watch(worker_ids)
            if failed or status in (ElasticStatus.RESTART, ElasticStatus.ERROR):
                restarts += 1
                if restarts > self.max_restarts:
                    for p in procs.values():
                        if p.poll() is None:
                            p.terminate()
                    raise RuntimeError(
                        f"elastic: exceeded max_restarts={self.max_restarts}; failed={failed}"
                    )
                procs = self._respawn(procs, worker_ids)
