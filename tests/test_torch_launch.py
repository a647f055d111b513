"""``spawn``, ``launch`` and ``fleet.elastic`` (``paddle_tpu_torch.
distributed``) on gloo, and their topology and supervision against the
reference's.

* ``spawn(train, nprocs=2, backend="gloo")`` and ``launch`` (plain and
  ``elastic=True``) of ``tests/torch_launch_worker.py`` with
  ``PADDLE_FAULT_INJECT=preempt.sigterm:step=3``: every worker drains
  after step 3 (a ``preempt_drain`` progress record, a synchronous
  checkpoint) and exits 75; the launcher starts the world again, each
  worker resumes from its checkpoint and finishes, and its 6 losses equal
  an uninterrupted run's bit for bit (the same run computed in this
  process, its gradients averaged as gloo averages them).
* ``get_cluster`` gives the reference's ``Cluster`` (one trainer a card
  here, a host there; the same ranks and endpoints), ``_last_progress``
  the reference's report, ``ElasticManager`` the reference's heartbeat,
  membership and retry answers over one store; at start-up, before the
  first heartbeat, a watch tick is not a membership change (the reference
  counts it as one and restarts a worker still starting up: ROADMAP §C).
"""
import importlib
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import launch_mod as jlaunch
from paddle_tpu.distributed.coord import FileStore as JFileStore
from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu.fault import inject as jinject
from paddle_tpu_torch.distributed import launch_mod as tlaunch
from paddle_tpu_torch.distributed.coord import FileStore as TFileStore
from paddle_tpu_torch.distributed.fleet import elastic as telastic
from paddle_tpu_torch.fault import inject as tinject
from torch_launch_worker import STEPS, train
from torch_port_util import free_port

# the packages' `spawn` attribute is the function: the modules by name
tspawn = importlib.import_module("paddle_tpu_torch.distributed.spawn")
jspawn = importlib.import_module("paddle_tpu.distributed.spawn")
HERE = Path(__file__).resolve().parent
INJECT = "preempt.sigterm:step=3"


def _uninterrupted():
    """Both ranks' losses of an uninterrupted run, in one process."""
    import paddle_tpu_torch as pt

    pt.seed(0)  # the initializer draws from the port's generators
    model = pt.nn.Linear(4, 2, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    losses = {0: [], 1: []}
    for step in range(1, STEPS + 1):
        grads = []
        for r in (0, 1):
            rng = np.random.RandomState(step * 10 + r)
            x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
            y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            grads.append([p.grad.clone() for p in model.parameters()])
            opt.clear_grad()
            losses[r].append(float(loss.detach()).hex())
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        opt.step()
        opt.clear_grad()
    return losses


def _check_resumed(d):
    want = _uninterrupted()
    for r in (0, 1):
        got = (d / f"losses_rank{r}.txt").read_text().split()
        assert got == want[r], r
        assert (d / f"phases_rank{r}.txt").read_text().split() \
            == ["preempt_drain"]


def test_spawn_relaunches_after_exit_75_and_resumes_bit_equal(
        tmp_path, monkeypatch):
    # one progress dir across the relaunch (spawn makes one a launch
    # unless the environment names it)
    monkeypatch.setenv("PADDLE_TPU_PROGRESS_DIR", str(tmp_path / "progress"))
    assert tspawn.spawn(train, args=(str(tmp_path),), nprocs=2,
                        backend="gloo",
                        env={"PADDLE_FAULT_INJECT": INJECT}) is None
    _check_resumed(tmp_path)


@pytest.mark.parametrize("elastic", [False, True])
def test_launch_relaunches_after_exit_75_and_resumes_bit_equal(
        tmp_path, monkeypatch, elastic):
    monkeypatch.setenv("PADDLE_DISTRI_BACKEND", "gloo")
    monkeypatch.setenv("PADDLE_FAULT_INJECT", INJECT)
    monkeypatch.delenv("PADDLE_TPU_PROGRESS_DIR", raising=False)
    monkeypatch.delenv("PADDLE_TPU_STORE_DIR", raising=False)
    port = free_port()
    rc = tlaunch.launch(str(HERE / "torch_launch_worker.py"),
                        [str(tmp_path)], nproc_per_node=2,
                        coordinator_port=port, elastic=elastic,
                        log_dir=str(tmp_path / "logs"))
    assert rc == 0
    _check_resumed(tmp_path)
    prog = tmp_path / "logs" / "supervise" / "progress"
    assert sorted(os.listdir(prog)) == ["rank_0.json", "rank_1.json"]


def _cluster(c):
    return [(p.addr, p.node_rank, [(t.endpoint, t.rank, t.local_rank)
                                   for t in p.trainers]) for p in c.pods]


def test_get_cluster_equals_the_reference():
    for ips, n in ((["127.0.0.1"], 1), (["10.0.0.1", "10.0.0.2"], 4)):
        got = tlaunch.get_cluster(ips, n, 9000)
        want = jlaunch.get_cluster(ips, n, 9000)
        assert _cluster(got) == _cluster(want)
        assert got.world_size == want.world_size == len(ips) * n
        assert got.trainer_endpoints() == want.trainer_endpoints()


def test_last_progress_reports_as_the_reference(tmp_path):
    (tmp_path / "rank_1.json").write_text('{"step": 4, "phase": "train"}')
    assert tspawn._last_progress([0, 1], str(tmp_path)) \
        == jspawn._last_progress([0, 1], str(tmp_path)) \
        == {1: {"step": 4, "phase": "train"}}


def _elastic_run(mod, store, inj):
    m = mod.ElasticManager(store, 2, worker_id="w0", heartbeat_interval=0.05,
                           timeout=5.0, retry_base_delay=0.001)
    m._beat()
    peer = mod.ElasticManager(store, 2, worker_id="w1", timeout=5.0)
    peer._beat()
    out = [sorted(m.alive_workers(["w0", "w1", "w2"])),
           sorted(m.progress(["w0", "w2"]))]
    watcher = mod.ElasticManager(store, 2, timeout=5.0, min_np=1)
    out.append(watcher.watch(["w0", "w1"]).value)
    out.append(watcher.watch(["w0"]).value)  # w1 left the watched set
    inj.arm({"store.op": {"at": 1}})
    m._beat()  # one transient store error, absorbed by the retry
    out.append(inj.fired_counts().get("store.op"))
    inj.disarm()
    peer.deregister()
    out.append(sorted(m.alive_workers(["w0", "w1"])))
    return out


def test_elastic_manager_answers_as_the_reference(tmp_path):
    got = _elastic_run(telastic, TFileStore(str(tmp_path / "t")), tinject)
    want = _elastic_run(jelastic, JFileStore(str(tmp_path / "r")), jinject)
    assert got == want == [["w0", "w1"], ["w0"], "hold", "restart", 1,
                           ["w0"]]


def test_elastic_watch_waits_for_the_first_heartbeat(tmp_path):
    store = TFileStore(str(tmp_path))
    watcher = telastic.ElasticManager(store, 1, timeout=5.0)
    assert watcher.watch(["w0"]) is telastic.ElasticStatus.EXIT
    telastic.ElasticManager(store, 1, worker_id="w0")._beat()
    assert watcher.watch(["w0"]) is telastic.ElasticStatus.HOLD
    time.sleep(0.01)
    assert watcher.world() == ["w0"]
