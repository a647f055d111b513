"""``paddle.distributed.spawn`` (port of ``paddle_tpu/distributed/spawn.py``).

Start ``nprocs`` worker processes that form one collective world, run
``func(*args)`` in each, join them and raise a failure. The port runs one
process a card: each child gets ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ENDPOINTS`` (its rendezvous on a
free local port), ``PADDLE_LOCAL_RANK`` (its card) and
``PADDLE_DISTRI_BACKEND``, so ``init_parallel_env()`` inside ``func``
forms the world: NCCL on the cards by default, gloo on the CPU with
``backend="gloo"``. The children start with the ``spawn`` method, as the
reference's do: a forked child of a process that touched CUDA cannot use
the card.

The join polls, so one crashed rank is seen while its peers sit blocked in
a collective waiting for it; past the deadline
(``PADDLE_TPU_SPAWN_JOIN_TIMEOUT_S``, 3600 s unset) the children are
reaped and the report names each one's last watchdog progress. A worker
whose rendezvous port was taken exits 98 and the world is started again
on a fresh port; a world that exits with the resumable code (75, a
preemption drain) is started again on its own budget.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys


def _free_port() -> int:
    """Probe for a free port. TOCTOU by construction: the socket closes
    before the child coordinator binds, so on busy hosts another process can
    grab the port in between — ``spawn`` retries the whole launch with a
    fresh port when a worker dies on a bind failure (exit ``_BIND_EXIT``)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Distinctive exit code for "coordinator port was taken" (EADDRINUSE=98):
# the parent's join maps it to a retry-with-fresh-port instead of a failure.
_BIND_EXIT = 98


def _is_bind_error(e: BaseException) -> bool:
    s = str(e).lower()
    return ("address already in use" in s or "eaddrinuse" in s
            or "failed to bind" in s or "errno 98" in s
            or "error binding" in s)


def _worker(func, args):
    # env is inherited from the parent's per-rank os.environ snapshot (set
    # around p.start()): it must be in place BEFORE this function body runs,
    # because unpickling the target itself imports the worker's modules.
    try:
        func(*args)
    except Exception as e:
        if _is_bind_error(e):
            sys.stderr.write(
                f"paddle_tpu_torch.distributed.spawn worker: rendezvous bind "
                f"failed ({e}); exiting {_BIND_EXIT} for port retry\n"
            )
            sys.exit(_BIND_EXIT)
        raise


def _default_join_timeout():
    """Default SpawnContext.join deadline in seconds (env-overridable via
    PADDLE_TPU_SPAWN_JOIN_TIMEOUT_S; 0 or unset-able to ``none`` disables).
    A wedged child must surface as a reaped, reported failure — never as a
    parent blocked forever."""
    raw = os.environ.get("PADDLE_TPU_SPAWN_JOIN_TIMEOUT_S", "")
    if not raw:
        return 3600.0
    try:
        t = float(raw)
    except ValueError:
        return 3600.0
    return t if t > 0 else None


def _last_progress(ranks, pdir=None):
    """Each rank's last watchdog progress record, read from the launch's
    PADDLE_TPU_PROGRESS_DIR (set by _launch for its children). The wedged-
    child report: WHERE each rank was when the parent gave up on it."""
    pdir = pdir or os.environ.get("PADDLE_TPU_PROGRESS_DIR")
    if not pdir:
        return {}
    try:
        from .watchdog import _read_progress_dir

        table = _read_progress_dir(pdir)
    except Exception:
        return {}
    return {r: table[r] for r in ranks if r in table}


class SpawnContext:
    def __init__(self, procs, progress_dir=None):
        self.processes = procs
        self.progress_dir = progress_dir
        # ranks that exited with the preemption drain's RESUMABLE_EXIT_CODE
        # (75) in the last join(): the world checkpointed cleanly and asked
        # for a restart — spawn() honors it the way launch_mod does
        self.resumable_ranks = []

    def join(self, timeout="default"):
        """Wait for all workers, POLLING so one crashed rank is detected even
        while its peers sit blocked in a collective waiting for it — the rest
        are then terminated and the failure raised (the reference's
        watch-and-kill loop in spawn.py).

        ``timeout="default"`` applies the env-overridable deadline
        (PADDLE_TPU_SPAWN_JOIN_TIMEOUT_S, 3600s unset): past it the parent
        REAPS the remaining children and raises a report carrying each
        wedged rank's last progress record instead of blocking forever.
        ``timeout=None`` waits indefinitely; a number is an explicit
        deadline past which join returns False (legacy polling contract).

        Exit code 75 (RESUMABLE_EXIT_CODE) is NOT a failure: those ranks are
        recorded in ``resumable_ranks`` and join returns True — the caller
        (``spawn``) relaunches the world, same as launch_mod."""
        import time

        from ..fault.preemption import RESUMABLE_EXIT_CODE

        reap_on_deadline = timeout == "default"
        if reap_on_deadline:
            timeout = _default_join_timeout()
        deadline = None if timeout is None else time.monotonic() + timeout
        self.resumable_ranks = []
        while True:
            bad = [(r, p.exitcode) for r, p in enumerate(self.processes)
                   if p.exitcode not in (0, RESUMABLE_EXIT_CODE, None)]
            if bad:
                for p in self.processes:  # one failure sinks the job
                    if p.is_alive():
                        p.terminate()
                for p in self.processes:
                    p.join(5)
                rank, code = bad[0]
                err = RuntimeError(
                    f"spawn worker rank {rank} exited with code {code} "
                    f"({len(bad)} of {len(self.processes)} workers failed)"
                )
                # a _BIND_EXIT rank means the probed coordinator port was
                # taken before the child bound it (TOCTOU) — spawn() retries
                err.bind_failure = any(c == _BIND_EXIT for _, c in bad)
                raise err
            alive = [p for p in self.processes if p.exitcode is None]
            if not alive:
                self.resumable_ranks = [
                    r for r, p in enumerate(self.processes)
                    if p.exitcode == RESUMABLE_EXIT_CODE
                ]
                return True
            if deadline is not None and time.monotonic() >= deadline:
                if not reap_on_deadline:
                    return False
                wedged = [r for r, p in enumerate(self.processes)
                          if p.exitcode is None]
                progress = _last_progress(wedged, self.progress_dir)
                for p in self.processes:
                    if p.is_alive():
                        p.terminate()
                for p in self.processes:
                    p.join(5)
                detail = "; ".join(
                    f"rank {r}: last progress "
                    + (f"step {progress[r].get('step')} phase "
                       f"{progress[r].get('phase')!r}" if r in progress
                       else "never published")
                    for r in wedged
                )
                raise RuntimeError(
                    f"spawn: workers {wedged} still running after "
                    f"{timeout:.0f}s join deadline — reaped ({detail}). "
                    "Raise PADDLE_TPU_SPAWN_JOIN_TIMEOUT_S for longer jobs."
                )
            alive[0].join(0.2)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, backend=None,
          **options):
    """Run ``func(*args)`` in ``nprocs`` processes forming one collective
    world (``-1``: one a visible card). ``nprocs <= 1`` runs inline.
    ``backend``: ``"nccl"`` (the default: one card a process) or
    ``"gloo"`` (the CPU). ``options``: ``bind_retries`` (3),
    ``max_resumes`` (32) and ``env`` (more variables for the children)."""
    if nprocs in (-1, 0):
        import torch

        nprocs = max(torch.cuda.device_count(), 1)
    if nprocs <= 1:
        func(*args)
        return None if join else SpawnContext([])
    if backend is None:
        backend = "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"spawn: backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    bind_retries = max(int(options.pop("bind_retries", 3)), 1)
    max_resumes = max(int(options.pop("max_resumes", 32)), 0)
    bind_attempt = 0
    resumes = 0
    while True:
        context = _launch(func, args, nprocs, backend, daemon, options)
        if not join:
            # caller owns the join — no bind-retry possible past this point
            return context
        try:
            context.join()
        except RuntimeError as e:
            if not getattr(e, "bind_failure", False) \
                    or bind_attempt >= bind_retries - 1:
                raise
            # coordinator port raced away (classic TOCTOU on busy hosts):
            # relaunch the whole world on a fresh probe port
            bind_attempt += 1
            continue
        if not context.resumable_ranks:
            return None
        # RESUMABLE_EXIT_CODE (75): the world drained + checkpointed and
        # wants a restart — honor it exactly like launch_mod, on a separate
        # (larger) budget than real failures
        resumes += 1
        if resumes > max_resumes:
            raise RuntimeError(
                f"spawn: workers asked for more than max_resumes="
                f"{max_resumes} restarts (ranks {context.resumable_ranks} "
                "exited resumably again)"
            )


def _launch(func, args, nprocs, backend, daemon, options):
    import tempfile

    port = _free_port()
    endpoints = ",".join(f"127.0.0.1:{port + r}" for r in range(nprocs))
    ctx = mp.get_context("spawn")
    procs = []
    # the children's supervision substrate: a shared progress dir (the
    # watchdog's publications, read by the wedged-child report) and a
    # FileStore dir (the coordinated checkpoint's commit barrier). A dir
    # the environment names already (a nested launch) wins.
    progress_dir = os.environ.get("PADDLE_TPU_PROGRESS_DIR") or tempfile.mkdtemp(
        prefix="paddle_tpu_torch_progress_")
    store_dir = os.environ.get("PADDLE_TPU_STORE_DIR") or tempfile.mkdtemp(
        prefix="paddle_tpu_torch_store_")
    # the children must see their variables before their first import (the
    # target is unpickled, importing its module, before func runs): set
    # os.environ around each p.start() (a child snapshots it) and restore
    child_env = {
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_TRAINER_ENDPOINTS": endpoints,
        "PADDLE_DISTRI_BACKEND": backend,
        "PADDLE_TPU_PROGRESS_DIR": progress_dir,
        "PADDLE_TPU_STORE_DIR": store_dir,
    }
    child_env.update(options.get("env", {}))
    saved = {k: os.environ.get(k) for k in (*child_env, "PADDLE_TRAINER_ID",
                                            "PADDLE_LOCAL_RANK",
                                            "PADDLE_CURRENT_ENDPOINT")}
    try:
        os.environ.update(child_env)
        for rank in range(nprocs):
            os.environ["PADDLE_TRAINER_ID"] = str(rank)
            os.environ["PADDLE_LOCAL_RANK"] = str(rank)
            os.environ["PADDLE_CURRENT_ENDPOINT"] = endpoints.split(",")[rank]
            p = ctx.Process(target=_worker, args=(func, args), daemon=daemon)
            p.start()
            procs.append(p)
    except BaseException:
        # a failed start() mid-loop must not orphan earlier ranks: they sit
        # in a rendezvous for a world that will never form
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
        raise
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return SpawnContext(procs, progress_dir=progress_dir)
