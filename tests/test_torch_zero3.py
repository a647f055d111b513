"""ZeRO-3 and the engine's sync group over four gloo ranks on the CPU,
against the reference (``paddle_tpu``) on its virtual meshes.

The four ranks (``tests/torch_hybrid_worker.py zero3``) are started once
for the file. Inputs are float32 numpy from seeds.

* The engine's sync group (ROADMAP C1): ``fleet.init`` at mp 2 x
  sharding 2 and ``HybridParallelEngine(..., dp_axes=("dp",
  "sharding"))`` on tiny GPT, each sharding rank on its half of a batch
  whose padding (``ignore_index``) falls mostly on the second half: 2 SGD
  (lr 0.1) steps and ``eval_step`` against the reference's engine on its
  mp 2 x sharding 2 virtual mesh with the same ``dp_axes`` on the whole
  batch. The gradients, the loss and the means over valid rows are taken
  over exactly the sharding group: losses and ``eval_step`` rtol 5e-7
  (measured 2.1e-7 on the first loss, 7.5e-8 on ``eval_step``'s: each
  rank divides its sum by the group's count over its size, and the two
  quotients are averaged, a few float32 roundings from one global mean),
  merged weights rtol 1e-4 / atol 1e-6. With the old sync group the losses
  are 1.1e-3 off.
* ``group_sharded_parallel(level="p_g_os")`` (``ShardingStage3``) at
  sharding 4 and at sharding 2 (x dp 2, whose ranks see the whole batch:
  ``dp_axes=()``) through the engine, 3 AdamW steps of the reference's
  ``Sequential(Linear(8, 16), Tanh(), Linear(16, 3))`` on a (16, 8) batch,
  against the reference's ``ShardingStage3`` engine with ``dp_axes=()``
  and against its plain single-device loop: losses rtol 1e-5, the logical
  ``state_dict()`` rtol 1e-4 / atol 1e-6. Each rank holds 1/n of every
  parameter along dim 0 and moments of that size; the (3,) bias, which no
  group of 2 or 4 divides, stays whole; ``get_all_parameters()`` gives
  the logical shapes.
* The eager loop through ``ShardingStage3`` with ``ClipGradByGlobalNorm``,
  ``ClipGradByNorm``, ``Lamb`` and ``LarsMomentum`` (their norms taken
  over the sharding group) against the reference's single-device loop, 2 steps: rtol 1e-4 /
  atol 1e-6.
"""
import json
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.collective import Group as JGroup
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.base import fleet_base as jfleet_base
from paddle_tpu.distributed.fleet.meta_parallel import sharding as jsharding
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     merge_state_dicts, mp_layouts)
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_position_embeddings", "hidden_dropout",
              "attention_dropout")
EAGER = {
    "global_norm": lambda ps: paddle.optimizer.SGD(
        learning_rate=0.5, parameters=ps,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.05)),
    "by_norm": lambda ps: paddle.optimizer.SGD(
        learning_rate=0.5, parameters=ps,
        grad_clip=paddle.nn.ClipGradByNorm(0.02)),
    "lamb": lambda ps: paddle.optimizer.Lamb(learning_rate=0.1, epsilon=1e-3,
                                             parameters=ps),
    "lars": lambda ps: paddle.optimizer.LarsMomentum(
        learning_rate=1.0, lars_coeff=0.1, parameters=ps),
}


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _odd():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 3))


def _reference_c1(inp, ref):
    rng = np.random.RandomState(3)
    cfg = jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    ids = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    labels[2:, 4:] = -100  # rank 1's half holds 8 valid labels, rank 0's 63
    labels[1, 31:] = -100
    inp["gpt_ids"], inp["gpt_labels_pad"] = ids, labels
    inp["gpt_config"] = np.array(json.dumps(
        {f: getattr(cfg, f) for f in GPT_FIELDS}))
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 2,
                               "sp_degree": 1}
    prev = jmesh._global_mesh
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        hcg = jfleet.get_hybrid_communicate_group()
        paddle.seed(21)
        jm = JGPT(cfg)
        inp.update({f"gpt.{k}": v for k, v in reference_state(jm).items()})
        eng = JEngine(jm, paddle.optimizer.SGD(learning_rate=0.1,
                                               parameters=jm.parameters()),
                      lambda m, i, l: m.loss(i, l), mesh=hcg.mesh,
                      dp_axes=("dp", "sharding"))
        tids, tlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
        ref["c1"] = {
            "losses": [float(eng.train_step(tids, tlab).numpy())
                       for _ in range(2)],
            "eval": float(eng.eval_step(lambda m, i, l: m.loss(i, l), tids,
                                        tlab).numpy()),
            "state": reference_state(jm)}
    finally:
        jfleet_base._hcg = None
        jmesh.set_global_mesh(prev)


def _reference_zero3(inp, ref):
    rng = np.random.RandomState(5)
    x = rng.rand(16, 8).astype(np.float32)
    y = rng.rand(16, 3).astype(np.float32)
    inp["z3_x"], inp["z3_y"] = x, y
    inp.update({f"z3.{k}": v for k, v in reference_state(_odd()).items()})
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
    for n in (2, 4):
        m3 = _odd()
        o3 = paddle.optimizer.AdamW(learning_rate=0.01,
                                    parameters=m3.parameters())
        s3 = jsharding.ShardingStage3(m3, o3, group=JGroup(
            axis_name="sharding", nranks=n))
        eng = JEngine(s3, o3, _mse, mesh=jbuild_mesh(("sharding",), (n,)),
                      dp_axes=())
        ref[f"engine_{n}"] = {
            "losses": [float(eng.train_step(tx, ty).numpy())
                       for _ in range(3)],
            "state": reference_state(m3)}
    m0 = _odd()
    o0 = paddle.optimizer.AdamW(learning_rate=0.01,
                                parameters=m0.parameters())
    losses = []
    for _ in range(3):
        loss = _mse(m0, tx, ty)
        loss.backward()
        o0.step()
        o0.clear_grad()
        losses.append(float(loss.numpy()))
    ref["plain"] = {"losses": losses, "state": reference_state(m0)}
    for name, make in EAGER.items():
        m = _odd()
        o = make(m.parameters())
        for _ in range(2):
            _mse(m, tx, ty).backward()
            o.step()
            o.clear_grad()
        ref[f"eager_{name}"] = reference_state(m)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero3")
    inp, ref = {}, {}
    old = jflags.flag("FLAGS_shard_weight_update")
    try:
        _reference_c1(inp, ref)
        _reference_zero3(inp, ref)
    finally:
        jflags.set_flags({"FLAGS_shard_weight_update": old})
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["zero3", d], 4, d, RANK_TIMEOUT_S), ref


def _layouts():
    cfg = jgpt_tiny()
    return mp_layouts(GPTForPretraining(
        GPTConfig(**{f: getattr(cfg, f) for f in GPT_FIELDS}), device="cpu"))


@pytest.mark.parametrize("what", ["train", "eval"])
def test_engine_syncs_over_the_axes_dp_axes_names(ranks, what):
    got, ref = ranks
    want = ref["c1"]
    for g in got:
        res = g["c1"]
        # the sharding group: the ranks of this mp rank
        assert res["sync_ranks"] == [res["mp_rank"], res["mp_rank"] + 2]
        if what == "eval":
            np.testing.assert_allclose(float(res["eval"]), want["eval"],
                                       rtol=5e-7)
        else:
            np.testing.assert_allclose(res["losses"].numpy(),
                                       want["losses"], rtol=5e-7)
    if what == "eval":
        return
    layouts = _layouts()
    for sh in (0, 1):
        pair = sorted((g["c1"] for g in got
                       if g["c1"]["sharding_rank"] == sh),
                      key=lambda r: r["mp_rank"])
        merged = merge_state_dicts([r["state"] for r in pair], layouts)
        for k, w in want["state"].items():
            np.testing.assert_allclose(merged[k].numpy(), w, rtol=1e-4,
                                       atol=1e-6, err_msg=f"{sh}:{k}")


@pytest.mark.parametrize("against", ["engine", "plain"])
@pytest.mark.parametrize("n", [2, 4])
def test_zero3_matches_the_reference(ranks, n, against):
    got, ref = ranks
    want = ref[f"engine_{n}" if against == "engine" else "plain"]
    for g in got:
        res = g[f"zero3_{n}"]
        assert res["wrapper"] == "ShardingStage3"
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        assert sorted(res["state"]) == sorted(want["state"])
        for k, w in want["state"].items():
            np.testing.assert_allclose(res["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_a_slice_of_every_shardable_parameter(ranks, n):
    got, ref = ranks
    logical = {k: v.shape for k, v in ref["plain"]["state"].items()}
    for g in got:
        res = g[f"zero3_{n}"]
        for (k, shape), moments in zip(res["local"].items(), res["moments"]):
            full = logical[k]
            want = full if k == "2.bias" else (full[0] // n,) + full[1:]
            assert shape == want, (k, shape)
            assert set(moments.values()) == {want}, (k, moments)
        assert res["all"] == list(logical.values())


@pytest.mark.parametrize("name", sorted(EAGER))
@pytest.mark.parametrize("n", [2, 4])
def test_zero3_norms_span_the_sharding_group(ranks, n, name):
    got, ref = ranks
    want = ref[f"eager_{name}"]
    for g in got:
        st = g[f"zero3_{n}"][f"eager_{name}"]
        for k, w in want.items():
            np.testing.assert_allclose(st[k].numpy(), w, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
