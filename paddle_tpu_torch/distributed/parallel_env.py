"""Parallel environment bootstrap (port of
``paddle_tpu/distributed/parallel_env.py``).

``init_parallel_env`` reads the launcher's variables as the reference does
(``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINER_ENDPOINTS``; ``PADDLE_LOCAL_RANK`` picks the card) and
runs ``torch.distributed.init_process_group``: NCCL on the card, gloo with
``device="cpu"``. The rendezvous is ``tcp://`` at the first endpoint. A
world of one still makes a group (on a free local port when no endpoint is
given), so the card launches the collectives on the one-rank path too.
It then binds the distributed watchdog's session (rank and world from the
launcher's variables, the progress directory and store when the launcher
provides them), and under ``launch(elastic=True)``
(``PADDLE_ELASTIC_STORE``, ``PADDLE_ELASTIC_WORKER_ID``) registers this
worker's heartbeat on the elastic store; a registration that fails warns
(rate-limited) and counts ``heartbeat_failures``, and training goes on.
"""
from __future__ import annotations

import os
import socket
import time
import warnings
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["init_parallel_env", "get_rank", "get_world_size", "ParallelEnv",
           "destroy_process_group"]

_init_done = False
_device = None  # the device the group's collectives run on
_heartbeat = None  # this worker's ElasticManager under launch(elastic=True)
_last_hb_warn = 0.0
_HB_WARN_INTERVAL_S = 60.0


def _warn_heartbeat_failure(e: Exception) -> None:
    """A failed heartbeat registration made visible: the elastic watcher
    will see this worker as dead while it trains, so warn (rate-limited)
    and count ``heartbeat_failures`` instead of passing silently."""
    global _last_hb_warn
    from .. import profiler

    profiler.counter_inc("heartbeat_failures")
    now = time.monotonic()
    if now - _last_hb_warn >= _HB_WARN_INTERVAL_S:
        _last_hb_warn = now
        warnings.warn(
            f"elastic heartbeat registration failed ({e!r}); training "
            "proceeds but the elastic watcher cannot see this worker — it "
            "may be declared dead and the job relaunched", RuntimeWarning)


def _initialized() -> bool:
    return _init_done


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_parallel_env(device=None, timeout_s: float = 300.0):
    """Join the job's process group and return a :class:`ParallelEnv`.
    ``device`` defaults to ``get_device()`` (the card unless the CPU was
    asked for, here or by the launcher's ``PADDLE_DISTRI_BACKEND=gloo``):
    NCCL on ``cuda``, gloo on ``cpu``. A second call returns at once."""
    global _init_done, _device
    if _init_done:
        return ParallelEnv()
    from ..core.place import resolve_device

    if device is None and os.environ.get("PADDLE_DISTRI_BACKEND") == "gloo":
        device = "cpu"
    dev = resolve_device(device)
    n = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if eps:
        host, _, port = eps.split(",")[0].strip().rpartition(":")
    elif n == 1:
        host, port = "127.0.0.1", str(_free_port())
    else:
        raise RuntimeError(
            f"init_parallel_env: a world of {n} ranks needs "
            "PADDLE_TRAINER_ENDPOINTS (host:port,...) for its rendezvous")
    if dev.type == "cuda":
        local = int(os.environ.get("PADDLE_LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{host or '127.0.0.1'}:{port}",
            world_size=n, rank=rank, timeout=timedelta(seconds=timeout_s))
    _device = dev
    from . import watchdog

    watchdog.configure(rank=rank, world_size=n)
    _register_heartbeat(n)
    _init_done = True
    return ParallelEnv()


def _register_heartbeat(n: int) -> None:
    """Under ``launch(elastic=True)``: this worker's heartbeat on the
    elastic store (advisory: a failure warns and training goes on)."""
    global _heartbeat
    est = os.environ.get("PADDLE_ELASTIC_STORE")
    wid = os.environ.get("PADDLE_ELASTIC_WORKER_ID")
    if not (est and wid):
        return
    try:
        from .coord import TCPStore
        from .fleet.elastic import ElasticManager

        host, _, port = est.rpartition(":")
        store = TCPStore(host=host, port=int(port), is_master=False)
        _heartbeat = ElasticManager(store, n, worker_id=wid).register()
    except Exception as e:
        _warn_heartbeat_failure(e)


def destroy_process_group() -> None:
    """Leave the process group ``init_parallel_env`` joined; the process is
    then a world of one again, and ``fleet``'s topology (whose groups died
    with it) is forgotten."""
    global _init_done, _device, _heartbeat
    from . import collective
    from .fleet.base import fleet_base

    if _heartbeat is not None:
        _heartbeat.deregister()
        _heartbeat = None
    if dist.is_initialized():
        dist.destroy_process_group()
    collective._reset()
    fleet_base._reset()
    _init_done = False
    _device = None


def get_rank(group=None) -> int:
    """This process's rank in the world, or in ``group`` (its index in the
    group's ranks; -1 outside it)."""
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if dist.is_initialized() else 1


class ParallelEnv:
    """Reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", get_rank()))

    @property
    def nranks(self):
        return get_world_size()

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def device_type(self):
        return "gpu" if _device is not None and _device.type == "cuda" \
            else "cpu"

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "127.0.0.1:6170")
        return eps.split(",")
