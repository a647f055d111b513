"""The distributed watchdog (``paddle_tpu_torch.distributed.watchdog``)
against the reference's (``paddle_tpu.distributed.watchdog``), and where
the port wires it.

Each case runs on both packages with the same inputs: the progress file a
``publish`` writes, the table that merges store records over files,
``suspect`` (a silent rank, else the one furthest behind, never the
reporter), unit records (``publish(unit=...)``/``remove_unit``), a
``guard`` whose deadline passes (the abort function gets the resumable
code 75 and the flight dump names the suspect), ``guarded_wait``, and the
disabled path (``FLAGS_collective_timeout_s=0``: a guard starts no
thread). The wiring is the port's: ``init_parallel_env`` configures the
session, ``collective.barrier`` runs under ``guard``,
``HybridParallelEngine.train_step`` publishes ``train_step`` and
``PreemptionGuard.drain`` publishes ``preempt_drain`` (checked against the
reference's drain too).
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.watchdog as jwd
import paddle_tpu.fault.inject as jinject
import paddle_tpu.framework.flags as jflags
import paddle_tpu.profiler.flight as jflight
import paddle_tpu_torch.distributed.watchdog as twd
import paddle_tpu_torch.fault.inject as tinject
import paddle_tpu_torch.framework.flags as tflags
import paddle_tpu_torch.profiler.flight as tflight
from paddle_tpu.distributed.coord import FileStore as JFileStore
from paddle_tpu_torch.distributed.coord import FileStore as TFileStore

PKGS = {"port": (twd, tflags, tinject, tflight, TFileStore),
        "ref": (jwd, jflags, jinject, jflight, JFileStore)}


@pytest.fixture(autouse=True)
def _clean():
    for wd, fl, inj, _, _ in PKGS.values():
        wd.reset()
        fl.set_flags({"FLAGS_collective_timeout_s": 0.0})
        inj.disarm()
    yield
    for wd, fl, inj, _, _ in PKGS.values():
        wd.set_abort_fn(None)
        wd.reset()
        fl.set_flags({"FLAGS_collective_timeout_s": 0.0})
        inj.disarm()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_publish_writes_the_progress_file(pkg, tmp_path):
    wd = PKGS[pkg][0]
    wd.configure(rank=0, world_size=2, store=None, progress_dir=str(tmp_path))
    wd.publish(step=7, phase="train_step", force=True)
    rec = json.loads((tmp_path / "rank_0.json").read_text())
    assert (rec["rank"], rec["step"], rec["phase"]) == (0, 7, "train_step")
    assert wd.local_progress()["step"] == 7


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_progress_table_merges_store_over_files(pkg, tmp_path):
    wd, _, _, _, Store = PKGS[pkg]
    store = Store(str(tmp_path / "store"))
    pdir = tmp_path / "progress"
    pdir.mkdir()
    (pdir / "rank_1.json").write_text(json.dumps({"rank": 1, "step": 3}))
    store.set("wd/progress/1", json.dumps({"rank": 1, "step": 9}))
    wd.configure(rank=0, world_size=2, store=store, progress_dir=str(pdir))
    assert wd.progress_table()[1]["step"] == 9


SUSPECT_TABLES = {
    "silent": (3, {0: 5, 1: 5}),
    "straggler": (3, {0: 10, 1: 10, 2: 4}),
    "nobody": (3, {}),
}


@pytest.mark.parametrize("case", sorted(SUSPECT_TABLES))
def test_suspect_names_the_reference_rank(case, tmp_path):
    world, steps = SUSPECT_TABLES[case]
    now = time.time()
    got = {}
    for pkg in ("port", "ref"):
        wd = PKGS[pkg][0]
        d = tmp_path / pkg
        d.mkdir()
        for r, s in steps.items():
            (d / f"rank_{r}.json").write_text(json.dumps(
                {"rank": r, "step": s, "phase": "train_step", "ts": now}))
        wd.configure(rank=0, world_size=world, store=None, progress_dir=str(d))
        sus, why = wd.suspect()
        got[pkg] = (sus, why.split(" (last heard")[0])
        wd.reset()
    assert got["port"] == got["ref"]
    assert got["port"][0] == {"silent": 2, "straggler": 2, "nobody": 1}[case]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_unit_records_ride_beside_the_rank_record(pkg, tmp_path):
    wd = PKGS[pkg][0]
    wd.configure(rank=0, world_size=1, store=None, progress_dir=str(tmp_path))
    wd.publish(step=3, phase="train_step", force=True)
    wd.publish(step=40, phase="serve.step", unit="eng0", force=True)
    rec = json.loads((tmp_path / "rank_0.json").read_text())
    assert rec["step"] == 3 and rec["phase"] == "train_step"
    assert rec["units"]["eng0"]["step"] == 40
    assert rec["units"]["eng0"]["phase"] == "serve.step"
    wd.remove_unit("eng0")
    rec = json.loads((tmp_path / "rank_0.json").read_text())
    assert rec["units"] == {}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_publish_without_session_is_a_noop(pkg):
    wd = PKGS[pkg][0]
    assert not wd.configured()
    wd.publish(step=1)
    assert wd.local_progress() == {}


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_guard_trips_with_the_resumable_code_and_names_the_suspect(
        pkg, tmp_path, monkeypatch):
    wd, fl, _, flight, _ = PKGS[pkg]
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    codes = []
    wd.set_abort_fn(codes.append)
    wd.configure(rank=0, world_size=2, store=None, progress_dir=str(tmp_path))
    wd.publish(step=9, phase="train_step", force=True)
    (tmp_path / "rank_1.json").write_text(json.dumps(
        {"rank": 1, "step": 2, "phase": "train_step",
         "ts": time.time() - 30}))
    fl.set_flags({"FLAGS_collective_timeout_s": 0.25})
    with wd.guard("allreduce:test"):
        deadline = time.time() + 10
        while not codes and time.time() < deadline:
            time.sleep(0.02)
    assert codes == [75]
    doc = json.loads(open(flight.last_dump()).read())
    assert doc["reason"] == "collective_timeout"
    assert doc["extra"]["suspect_rank"] == 1
    assert doc["extra"]["what"] == "allreduce:test"
    assert doc["context"]["watchdog"]["suspect_rank"] == 1


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_guarded_wait_trips_and_passes(pkg, tmp_path):
    wd = PKGS[pkg][0]
    codes = []
    wd.set_abort_fn(codes.append)
    wd.configure(rank=0, world_size=1, store=None, progress_dir=str(tmp_path))
    wd.guarded_wait(lambda: True, "instant", timeout=0.5)
    assert codes == []
    wd.guarded_wait(lambda: False, "peer ack", timeout=0.15, interval_s=0.02)
    assert codes == [75]


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_disabled_guard_starts_no_thread(pkg):
    wd, fl = PKGS[pkg][:2]
    assert fl.flag("FLAGS_collective_timeout_s") == 0.0
    assert not wd.enabled()
    before = {t.name for t in threading.enumerate()}
    for _ in range(100):
        with wd.guard("hot-path"):
            pass
    assert {t.name for t in threading.enumerate()} == before


def test_chaos_rank_slow_fires_at_publish(tmp_path):
    twd.configure(rank=1, world_size=2, store=None, progress_dir=str(tmp_path))
    tinject.arm("rank.slow:rank=1,ms=150")
    t0 = time.monotonic()
    twd.publish(step=1, force=True)
    assert time.monotonic() - t0 >= 0.15
    assert tinject.fired_counts() == {"rank.slow": 1}


# -- the port's wiring ---------------------------------------------------------
@pytest.fixture()
def world1():
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env(device="cpu")
    yield dist
    dist.destroy_process_group()


def test_init_parallel_env_configures_the_session_and_barrier_is_guarded(
        world1, monkeypatch):
    import torch.distributed as tdist

    assert twd.configured()
    assert twd.local_progress()["phase"] == "init"
    codes = []
    twd.set_abort_fn(codes.append)
    tflags.set_flags({"FLAGS_collective_timeout_s": 0.1})
    real = tdist.barrier

    def slow_barrier(*a, **k):  # a barrier that outlives the deadline
        time.sleep(0.6)
        return real(*a, **k)

    monkeypatch.setattr(tdist, "barrier", slow_barrier)
    world1.barrier()
    assert codes == [75]


def test_engine_train_step_publishes_its_step(world1, tmp_path):
    import paddle_tpu_torch as pt

    twd.configure(rank=0, world_size=1, store=None, progress_dir=str(tmp_path))
    lin = pt.nn.Linear(3, 1, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    eng = world1.HybridParallelEngine(
        lin, opt, lambda m, x, y: ((m(x) - y) ** 2).mean())
    x, y = torch.ones(4, 3), torch.zeros(4, 1)
    eng.train_step(x, y)
    eng.train_step(x, y)
    rec = twd.local_progress()
    assert rec["phase"] == "train_step" and rec["step"] == 1


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_preemption_drain_publishes_preempt_drain(pkg, tmp_path):
    if pkg == "port":
        from paddle_tpu_torch.fault.preemption import PreemptionGuard
    else:
        from paddle_tpu.fault.preemption import PreemptionGuard
    wd = PKGS[pkg][0]
    wd.configure(rank=0, world_size=1, store=None, progress_dir=str(tmp_path))
    saved = []

    class Ck:
        def save_now(self, step, state, sync=False):
            saved.append((step, sync))

    g = PreemptionGuard(checkpoint=Ck(), exit_fn=saved.append)
    g.preempt()
    assert g.check(4, {"w": np.zeros(1)}) is True
    rec = json.loads((tmp_path / "rank_0.json").read_text())
    assert (rec["step"], rec["phase"]) == (4, "preempt_drain")
    assert saved == [(4, True), 75]
