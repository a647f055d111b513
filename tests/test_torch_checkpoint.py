"""The distributed checkpoint (``paddle_tpu_torch.distributed.checkpoint``)
against the reference's (``paddle_tpu.distributed.checkpoint``, orbax).

* The manifest: for the same state (float32, bfloat16, int64, a nested
  dict, a python scalar, a ``Linear``'s ``state_dict``) the port's
  ``<path>.manifest.json`` tree equals the reference's key for key: the
  shapes, the reference's dtype names and each leaf's ``zlib.crc32``.
* Save and load: sync and async round trips are bit-equal and the
  restored tensors own their memory; one flipped byte in a leaf file makes
  ``load_state_dict`` raise ``CheckpointError`` naming that key; strict
  loading names missing and unexpected keys; an in-place re-save parks
  the old copy as ``.old`` until the new one commits.
* ``AutoCheckpoint``: the same sequence of saves, a failed write
  (``ckpt.write``), an uncommitted newest step, a protected anchor,
  ``invalidate`` and ``resume(max_step=...)`` leave the reference's steps
  on disk and resume to the reference's step.
* ``CoordinatedCheckpoint`` at world 2: the port as two gloo ranks
  (``tests/torch_a11_worker.py ckpt``), the reference as two threads over
  a ``FileStore``, driven the same way: 3 clean saves, a 4th with the
  crash point armed on one rank, then a resume. At each point
  (``ckpt.write``, ``.serialize``, ``.ack``, ``.commit`` x rank 0/1) each
  rank's save results, the resumed step, the step dirs left (GC keeps
  the same ones) and the restored state equal the reference's. Each wait
  has a fixed deadline: 60 s where its event comes, 0.5 s where the crash
  rules the event out, so no outcome hangs on a race with the clock; the
  reference's threads write and read their orbax files one at a time
  (orbax's temporary files race between two threads of one process).
  ``ckpt.write`` carries no rank in either package; the port arms it in
  the crashing rank's process only, the reference (one process) on both
  threads: the outcomes compared are the same either way.
* ``engine_state_dict``/``engine_load_state_dict`` on the port's engine:
  the reference's keys, shapes and dtypes, and a bit-equal continuation.
"""
import json
import os
import shutil
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.coord import FileStore as JFileStore
from paddle_tpu.fault import inject as jinject
from paddle_tpu_torch.distributed import checkpoint as tck
from paddle_tpu_torch.fault import inject as tinject
from torch_a11_worker import (CLEAN_TIMEOUT_S, CRASH_POINTS,
                              NEVER_TIMEOUT_S)
from torch_port_util import spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_a11_worker.py"
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _disarm():
    tinject.disarm()
    jinject.disarm()
    yield
    tinject.disarm()
    jinject.disarm()


def _arrays():
    rng = np.random.RandomState(0)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32),
            "i": np.arange(6, dtype=np.int64).reshape(2, 3)}


def _port_state(a):
    import paddle_tpu_torch as pt

    lin = pt.nn.Linear(3, 2, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(a["w"][:, :2].copy()))
        lin.bias.copy_(torch.from_numpy(a["b"][:2].copy()))
    return {"w": torch.from_numpy(a["w"].copy()),
            "nested": {"bf": torch.from_numpy(a["b"]).to(torch.bfloat16),
                       "i": torch.from_numpy(a["i"].copy())},
            "scalar": 3, "lin": lin}


def _ref_state(a):
    lin = paddle.nn.Linear(3, 2)
    lin.weight.set_value(a["w"][:, :2])
    lin.bias.set_value(a["b"][:2])
    return {"w": paddle.to_tensor(a["w"]),
            "nested": {"bf": paddle.Tensor(jnp.asarray(a["b"]).astype(
                jnp.bfloat16)), "i": paddle.to_tensor(a["i"])},
            "scalar": 3, "lin": lin}


def test_manifest_equals_the_reference(tmp_path):
    a = _arrays()
    tck.save_state_dict(_port_state(a), str(tmp_path / "t"), step=5)
    jck.save_state_dict(_ref_state(a), str(tmp_path / "r"), step=5)
    got, want = (tck.read_manifest(str(tmp_path / x)) for x in ("t", "r"))
    assert sorted(got) == sorted(want)
    assert got["tree"] == want["tree"]
    assert (got["step"], got["format"], got["committed"]) == (5, 1, True)
    assert got["tree"]["nested/bf"]["dtype"] == "bfloat16"
    assert got["tree"]["scalar"]["dtype"] == "int64"
    assert set(got["tree"]) == {"w", "nested/bf", "nested/i", "scalar",
                                "lin/weight", "lin/bias"}


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_is_bit_equal_and_owns_its_memory(tmp_path, async_save):
    a = _arrays()
    src = _port_state(a)
    want = src["w"].clone()
    pend = tck.save_state_dict(src, str(tmp_path / "c"), step=1,
                               async_save=async_save)
    if async_save:
        assert tck.read_manifest(str(tmp_path / "c")) is None  # uncommitted
        # the staged copy is the state as of the save call
        with torch.no_grad():
            src["w"].add_(1.0)
        pend.wait_until_finished()
    dst = _port_state({k: np.zeros_like(v) for k, v in a.items()})
    tck.load_state_dict(dst, str(tmp_path / "c"), strict=False)
    assert torch.equal(dst["w"], want)
    assert torch.equal(dst["nested"]["bf"], src["nested"]["bf"])
    assert torch.equal(dst["nested"]["i"], src["nested"]["i"])
    assert torch.equal(dst["lin"].weight, src["lin"].weight)
    flat = tck._read_leaves(str(tmp_path / "c"))
    ptrs = {t.untyped_storage().data_ptr() for t in flat.values()}
    assert len(ptrs) == len(flat)  # every leaf its own allocation


def _leaf_file(path, key):
    idx = json.load(open(os.path.join(path, "index.json")))["leaves"]
    return os.path.join(path, next(e["file"] for e in idx if e["key"] == key))


def test_a_flipped_byte_names_its_key(tmp_path):
    a = _arrays()
    p = str(tmp_path / "c")
    tck.save_state_dict(_port_state(a), p, step=1)
    f = _leaf_file(p, "nested/i")
    raw = bytearray(open(f, "rb").read())
    raw[3] ^= 0x40
    open(f, "wb").write(bytes(raw))
    with pytest.raises(tck.CheckpointError, match="'nested/i'"):
        tck.load_state_dict(_port_state(a), p)
    tck.load_state_dict(_port_state(a), p, verify=False)  # opted out


def test_strict_load_names_missing_and_unexpected_keys(tmp_path):
    a = _arrays()
    p = str(tmp_path / "c")
    tck.save_state_dict({"w": torch.zeros(2), "x": torch.ones(1)}, p)
    with pytest.raises(tck.CheckpointError) as e:
        tck.load_state_dict({"w": torch.zeros(2), "y": torch.ones(1)}, p)
    assert "['y']" in str(e.value) and "['x']" in str(e.value)
    st = {"w": torch.ones(2), "y": torch.ones(1)}
    tck.load_state_dict(st, p, strict=False)
    assert torch.equal(st["w"], torch.zeros(2))
    del a


def test_in_place_resave_keeps_the_old_copy_until_commit(tmp_path):
    p = str(tmp_path / "c")
    tck.save_state_dict({"w": torch.zeros(2)}, p, step=1)
    pend = tck.save_state_dict({"w": torch.ones(2)}, p, step=2,
                               async_save=True)
    assert tck.read_manifest(p + ".old")["step"] == 1
    pend.wait_until_finished()
    assert tck.read_manifest(p)["step"] == 2
    tck.save_state_dict({"w": torch.full((2,), 2.0)}, p, step=3)
    assert not os.path.exists(p + ".old")  # a sync save drops it
    st = {"w": torch.zeros(2)}
    tck.load_state_dict(st, p)
    assert torch.equal(st["w"], torch.full((2,), 2.0))


# -- AutoCheckpoint ----------------------------------------------------------
def _auto_run(pkg, d, tensor):
    """One scripted run: saves at 1..4 (keep_last 2, step 2 protected), a
    failed write at 5, a 6 whose manifest says uncommitted, resumes,
    invalidate 3. Returns what each call gave and the dirs left."""
    ck_mod, inj = (tck, tinject) if pkg == "port" else (jck, jinject)
    ck = ck_mod.AutoCheckpoint(str(d), interval_steps=1, keep_last=2,
                               save_retries=1)
    out = {"saves": []}
    ck.protect(2)
    for s in (1, 2, 3, 4):
        out["saves"].append(ck.maybe_save(s, {"w": tensor(s)}))
    inj.arm({"ckpt.write": {"from": 1}})
    with pytest.warns(UserWarning):
        out["saves"].append(ck.save_now(5, {"w": tensor(5)}))
    inj.disarm()
    out["saves"].append(ck.save_now(6, {"w": tensor(6)}))
    man = str(d / "step_6") + ".manifest.json"  # a save that died
    rec = json.load(open(man))
    rec["committed"] = False
    json.dump(rec, open(man, "w"))
    st = {"w": tensor(0)}
    out["resume"] = ck.resume(st)
    out["w"] = float(np.asarray(st["w"] if pkg == "port"
                                else st["w"].numpy())[0])
    out["resume_le_3"] = ck.resume({"w": tensor(0)}, max_step=3)
    ck.release(2)
    ck.invalidate(3)
    out["resume_le_3_after"] = ck.resume({"w": tensor(0)}, max_step=3)
    out["dirs"] = sorted(n for n in os.listdir(d) if n.startswith("step_"))
    return out


def test_auto_checkpoint_walks_and_collects_as_the_reference(tmp_path):
    got = _auto_run("port", tmp_path / "t",
                    lambda s: torch.full((3,), float(s)))
    want = _auto_run("ref", tmp_path / "r",
                     lambda s: paddle.to_tensor(np.full((3,), float(s),
                                                        np.float32)))
    assert got == want
    assert got["resume"] == 4 and got["w"] == 4.0
    # GC kept the protected step 2 and the last two; 3 went at save 4
    assert got["resume_le_3"] == 2 and got["resume_le_3_after"] == 2
    assert got["saves"] == [True, True, True, True, False, True]
    assert got["dirs"] == [f"step_{k}{x}" for k in (2, 4, 6)
                           for x in ("", ".manifest.json")]


# -- CoordinatedCheckpoint at world 2 ----------------------------------------
def _ref_state_of(step, rank):
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    return {"w": paddle.to_tensor(base + 100.0 * rank + step),
            "b": paddle.Tensor(jnp.full((4,), 0.5 * step + rank,
                                        jnp.bfloat16)),
            "n": {"k": paddle.Tensor(jnp.asarray(step * 10 + rank,
                                                 jnp.int64))}}


def _threads(fn):
    out = [None, None]

    def run(r):
        out[r] = fn(r)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    return out


def _ref_scenario(d, point, crash_rank):
    store = JFileStore(str(d / "store"))

    def ck(r, timeout):
        return jck.CoordinatedCheckpoint(
            str(d / "ckpt"), world_size=2, rank=r, store=store,
            interval_steps=1, keep_last=2, commit_timeout_s=timeout)

    results = [_threads(lambda r: ck(r, CLEAN_TIMEOUT_S).save_now(
        s, _ref_state_of(s, r))) for s in (1, 2, 3)]
    timeout = CLEAN_TIMEOUT_S if (point, crash_rank) == ("ckpt.commit", 1) \
        else NEVER_TIMEOUT_S
    jinject.arm({point: {"from": 1}} if point == "ckpt.write"
                else {point: {"rank": crash_rank}})
    try:
        results.append(_threads(lambda r: ck(r, timeout).save_now(
            4, _ref_state_of(4, r))))
    finally:
        jinject.disarm()
    states = [_ref_state_of(0, r) for r in range(2)]
    steps = _threads(lambda r: ck(r, CLEAN_TIMEOUT_S).resume(states[r]))
    return {"results": [[res[r] for res in results] for r in range(2)],
            "steps": steps, "states": states,
            "dirs": sorted(os.listdir(d / "ckpt"))}


def _one_at_a_time(fn, lock):
    def locked(*a, **k):
        with lock:
            return fn(*a, **k)
    return locked


@pytest.fixture(scope="module")
def coordinated(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    got = spawn_ranks(WORKER, ["ckpt", d], 2, d, RANK_TIMEOUT_S)
    ref = {}
    # orbax's writes from two threads of one process race on its temporary
    # files (a clean save then fails at random): the reference's rank
    # threads run the protocol concurrently but write and read one at a
    # time
    lock = threading.Lock()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("save_state_dict", "load_state_dict"):
            mp.setattr(jck, name, _one_at_a_time(getattr(jck, name), lock))
        for point in CRASH_POINTS:
            for r in (0, 1):
                sub = d / f"ref_{point}_{r}"
                sub.mkdir()
                ref[(point, r)] = _ref_scenario(sub, point, r)
    return got, ref


@pytest.mark.parametrize("crash_rank", [0, 1])
@pytest.mark.parametrize("point", CRASH_POINTS)
def test_coordinated_crash_point_resumes_as_the_reference(coordinated, point,
                                                          crash_rank):
    got, ref = coordinated
    want = ref[(point, crash_rank)]
    for r in range(2):
        res = got[r]["ckpt"][(point, crash_rank)]
        assert res["results"] == want["results"][r], r
        assert res["step"] == want["steps"][r], r
        assert res["dirs"] == want["dirs"]
        ws = want["states"][r]
        st = res["state"]
        np.testing.assert_array_equal(st["w"].numpy(), np.asarray(ws["w"]._data))
        assert torch.equal(st["b"].view(torch.int16), torch.from_numpy(
            np.array(ws["b"]._data).view(np.int16)))
        assert int(st["n"]["k"]) == int(np.asarray(ws["n"]["k"]._data))
    committed = want["steps"][0]
    assert want["steps"] == [committed, committed]
    assert committed == (4 if (point, crash_rank) == ("ckpt.commit", 1)
                         else 3)


# -- the engine's state --------------------------------------------------------
def test_engine_state_round_trip_continues_bit_equal(tmp_path):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import HybridParallelEngine

    def make():
        torch.manual_seed(0)
        lin = pt.nn.Linear(4, 3, device="cpu")
        opt = pt.optimizer.AdamW(learning_rate=0.01,
                                 parameters=lin.parameters())
        return lin, HybridParallelEngine(
            lin, opt, lambda m, x, y: ((m(x) - y) ** 2).mean())

    x, y = torch.randn(8, 4), torch.randn(8, 3)
    lin, eng = make()
    fresh = tck.engine_state_dict(eng)  # before a step: zero moments
    assert sorted(fresh) == ["accum_0_moment1", "accum_0_moment2",
                             "accum_1_moment1", "accum_1_moment2",
                             "opt_step", "param_0", "param_1"]
    eng.train_step(x, y)
    tck.save_state_dict(tck.engine_state_dict(eng), str(tmp_path / "e"),
                        step=1)
    want = [float(eng.train_step(x, y)) for _ in range(2)]
    lin2, eng2 = make()
    tck.engine_load_state_dict(eng2, str(tmp_path / "e"))
    assert eng2.optimizer._step_count == 1
    assert [float(eng2.train_step(x, y)) for _ in range(2)] == want
    assert torch.equal(lin2.weight, lin.weight)

    man = tck.read_manifest(str(tmp_path / "e"))
    jlin = paddle.nn.Linear(4, 3)
    jopt = paddle.optimizer.AdamW(learning_rate=0.01,
                                  parameters=jlin.parameters())
    from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
    from paddle_tpu.distributed.mesh import build_mesh

    jeng = JEngine(jlin, jopt, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                   mesh=build_mesh(("dp",), (1,)))
    jeng.train_step(paddle.to_tensor(x.numpy()), paddle.to_tensor(y.numpy()))
    jck.save_state_dict(jck.engine_state_dict(jeng), str(tmp_path / "j"),
                        step=1)
    jman = jck.read_manifest(str(tmp_path / "j"))
    assert {k: (v["shape"], v["dtype"]) for k, v in man["tree"].items()} \
        == {k: (v["shape"], v["dtype"]) for k, v in jman["tree"].items()}
    shutil.rmtree(tmp_path / "j", ignore_errors=True)


def test_coordinated_async_save_commits_in_wait(tmp_path):
    """The port's async coordinated save: ``save_now`` returns once the
    background write started; the step is invisible to resume until
    ``wait`` ran both phases; a later save waits for the pending one."""
    from paddle_tpu_torch.distributed.coord import TCPStore

    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=10)
    ck = tck.CoordinatedCheckpoint(str(tmp_path), world_size=1, rank=0,
                                   store=store, async_save=True,
                                   keep_last=0, commit_timeout_s=10)
    w = torch.arange(6, dtype=torch.float32)
    assert ck.save_now(1, {"w": w}) is True
    with torch.no_grad():
        w.add_(100.0)  # the staged copy is the state at the save call
    assert ck.wait() is True
    assert ck.save_now(2, {"w": w}) is True
    assert not ck._step_fully_committed(2)
    assert ck.save_now(3, {"w": w}, sync=True) is True  # waits for 2 first
    assert ck._step_fully_committed(2) and ck.wait() is None
    st = {"w": torch.zeros(6)}
    assert ck.resume(st, max_step=1) == 1
    assert torch.equal(st["w"], torch.arange(6, dtype=torch.float32))
    store.close()
