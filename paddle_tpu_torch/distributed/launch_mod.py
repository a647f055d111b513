"""The launcher: ``python -m paddle_tpu_torch.distributed.launch_mod``
(port of ``paddle_tpu/distributed/launch_mod.py``; the reference's
``fleet/launch.py`` and ``launch_utils.py`` ``get_cluster``).

It builds the job's topology (``Cluster`` of ``Pod``s of ``Trainer``s)
from ``--ips``, starts this node's workers and supervises them. The port
runs **one worker process a card** (the reference runs one a host), so
``nproc_per_node`` counts the node's cards: each worker gets its rank,
``PADDLE_LOCAL_RANK`` (its card), the world size and every trainer's
endpoint (``init_parallel_env`` meets the others at the first one).

A supervision directory (``<log_dir>/supervise`` or a temporary one) holds
``progress/`` (each worker's watchdog progress record) and ``store/`` (the
``FileStore`` of the coordinated checkpoint's commit barrier); a failure's
report names each dead rank's last progress. A worker that exits with the
resumable code (75, a preemption drain) is started again on its own budget
(``max_resumes``); with ``elastic=True`` the workers heartbeat on a
``TCPStore`` at ``coordinator_port - 1`` and ``ElasticLauncher`` relaunches
on a failure too (``max_restarts``).
"""
from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Trainer:
    endpoint: str
    rank: int
    local_rank: int


@dataclass
class Pod:
    """One host's workers (reference launch_utils.py Pod)."""

    addr: str
    node_rank: int
    trainers: List[Trainer] = field(default_factory=list)


@dataclass
class Cluster:
    """The whole-job topology (reference launch_utils.py Cluster)."""

    pods: List[Pod] = field(default_factory=list)

    @property
    def world_size(self):
        return sum(len(p.trainers) for p in self.pods)

    def trainer_endpoints(self):
        return [t.endpoint for p in self.pods for t in p.trainers]

    def pod_by_addr(self, addr):
        for p in self.pods:
            if p.addr == addr:
                return p
        return None


def get_cluster(ips: List[str], nproc_per_node: int, base_port: int = 8476) -> Cluster:
    """Build the topology (reference launch_utils.py get_cluster:272): one
    trainer a card, ``nproc_per_node`` of them a node."""
    cluster = Cluster()
    rank = 0
    for node_rank, ip in enumerate(ips):
        pod = Pod(addr=ip, node_rank=node_rank)
        for local in range(nproc_per_node):
            pod.trainers.append(
                Trainer(endpoint=f"{ip}:{base_port + 1 + local}", rank=rank, local_rank=local)
            )
            rank += 1
        cluster.pods.append(pod)
    return cluster


def _current_node_ip(ips: List[str]) -> str:
    explicit = os.environ.get("PADDLE_CURRENT_NODE") or os.environ.get("POD_IP")
    if explicit and explicit in ips:
        return explicit
    nr = os.environ.get("PADDLE_NODE_RANK")
    if nr is not None and int(nr) < len(ips):
        return ips[int(nr)]
    import socket

    names = {"127.0.0.1", "localhost", socket.gethostname()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for ip in ips:
        if ip in names:
            return ip
    if len(ips) == 1:
        return ips[0]
    # multi-node with no identity match: guessing node 0 would duplicate
    # ranks across hosts — demand explicit identification instead
    raise RuntimeError(
        f"cannot identify this host among --ips {ips}; set PADDLE_CURRENT_NODE "
        "or PADDLE_NODE_RANK"
    )


def launch(
    training_script: str,
    training_script_args: Optional[List[str]] = None,
    ips: str = "127.0.0.1",
    nproc_per_node: int = 1,
    coordinator_port: int = 8476,
    log_dir: Optional[str] = None,
    elastic: bool = False,
    max_restarts: int = 3,
    max_resumes: int = 32,
    hosts=None,
):
    """Launch this node's workers per the cluster topology; supervise them.

    Multi-node: run the same command on every host in ``ips`` — each node
    starts only its own pod's processes (reference launch.py behavior).
    """
    training_script_args = training_script_args or []
    if hosts is not None:  # backwards-compatible alias
        ips = hosts if isinstance(hosts, str) else ",".join(hosts)
    ip_list = [s.strip() for s in str(ips).split(",") if s.strip()]
    cluster = get_cluster(ip_list, int(nproc_per_node), coordinator_port)
    me = _current_node_ip(ip_list)
    pod = cluster.pod_by_addr(me)
    if pod is None:
        raise RuntimeError(f"current node {me} not in --ips {ip_list}")
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    # supervision substrate: workers publish watchdog progress here (and the
    # coordinated-checkpoint FileStore lives beside it), so the launcher's
    # failure report can name each dead rank's last known position
    import tempfile

    supervise_root = (
        os.path.join(log_dir, "supervise") if log_dir
        else tempfile.mkdtemp(prefix="paddle_tpu_torch_supervise_")
    )
    progress_dir = os.path.join(supervise_root, "progress")
    store_dir = os.path.join(supervise_root, "store")
    os.makedirs(progress_dir, exist_ok=True)
    os.makedirs(store_dir, exist_ok=True)

    def _progress_report():
        try:
            from .watchdog import _read_progress_dir

            table = _read_progress_dir(progress_dir)
        except Exception:
            return ""
        if not table:
            return ""
        return " | last progress: " + "; ".join(
            f"rank {r}: step {rec.get('step')} phase {rec.get('phase')!r}"
            for r, rec in sorted(table.items())
        )

    def spawn_all(_ids=None, _elastic_port=None):
        procs = {}
        for t in pod.trainers:
            env = dict(os.environ)
            env.update(
                {
                    "PADDLE_TRAINER_ID": str(t.rank),
                    "PADDLE_LOCAL_RANK": str(t.local_rank),
                    "PADDLE_TRAINERS_NUM": str(cluster.world_size),
                    "PADDLE_CURRENT_ENDPOINT": t.endpoint,
                    "PADDLE_TRAINER_ENDPOINTS": ",".join(cluster.trainer_endpoints()),
                    "PADDLE_NODE_RANK": str(pod.node_rank),
                    "PADDLE_NNODES": str(len(cluster.pods)),
                    "PADDLE_TPU_PROGRESS_DIR": progress_dir,
                    "PADDLE_TPU_STORE_DIR": store_dir,
                }
            )
            if _elastic_port is not None:
                # workers auto-register heartbeats in init_parallel_env
                env["PADDLE_ELASTIC_STORE"] = f"{ip_list[0]}:{_elastic_port}"
                env["PADDLE_ELASTIC_WORKER_ID"] = f"w{t.rank}"
            stdout = (
                open(os.path.join(log_dir, f"worker.{t.rank}.log"), "ab")
                if log_dir else None
            )
            p = subprocess.Popen(
                [sys.executable, training_script] + list(training_script_args),
                env=env, stdout=stdout, stderr=subprocess.STDOUT if stdout else None,
            )
            if stdout is not None:
                stdout.close()  # child holds its own copy of the fd
            procs[f"w{t.rank}"] = p
        return procs

    if elastic:
        from .coord import TCPStore
        from .fleet.elastic import ElasticLauncher, ElasticManager

        elastic_port = coordinator_port - 1
        store = TCPStore(
            host=ip_list[0], port=elastic_port,
            is_master=(pod.node_rank == 0),
        )
        manager = ElasticManager(store, cluster.world_size, timeout=10.0)
        launcher = ElasticLauncher(
            lambda ids: spawn_all(ids, _elastic_port=elastic_port),
            manager, max_restarts=max_restarts, max_resumes=max_resumes,
        )
        return launcher.run([f"w{t.rank}" for t in pod.trainers])

    # Non-elastic supervision still honors the preemption-drain contract: a
    # worker that exits with RESUMABLE_EXIT_CODE checkpointed cleanly and
    # wants a restart (it resumes from AutoCheckpoint), so respawn instead of
    # failing the job.
    from ..fault.preemption import RESUMABLE_EXIT_CODE

    resumes = 0
    procs = spawn_all()
    while True:
        codes = {w: p.wait() for w, p in procs.items()}
        if any(c not in (0, RESUMABLE_EXIT_CODE) for c in codes.values()):
            raise RuntimeError(
                f"workers exited with codes {codes}{_progress_report()}"
            )
        if all(c == 0 for c in codes.values()):
            return 0
        # preemption drains are normal operations, not failures: same
        # separate (larger) budget as ElasticLauncher.max_resumes
        resumes += 1
        if resumes > max_resumes:
            raise RuntimeError(
                f"workers preempted more than max_resumes={max_resumes} "
                f"times (codes {codes})"
            )
        procs = spawn_all()


def main():
    import argparse

    ap = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    ap.add_argument("--ips", default="127.0.0.1", help="comma-separated host list")
    ap.add_argument("--nproc_per_node", type=int, default=1,
                    help="workers on this node: one a card")
    ap.add_argument("--coordinator_port", type=int, default=8476)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--max_restarts", type=int, default=3)
    ap.add_argument("--max_resumes", type=int, default=32)
    ap.add_argument("script")
    ap.add_argument("script_args", nargs="...")
    args = ap.parse_args()
    launch(
        args.script, args.script_args, ips=args.ips,
        nproc_per_node=args.nproc_per_node, coordinator_port=args.coordinator_port,
        log_dir=args.log_dir, elastic=args.elastic, max_restarts=args.max_restarts,
        max_resumes=args.max_resumes,
    )


if __name__ == "__main__":
    main()
