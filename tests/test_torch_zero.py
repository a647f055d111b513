"""ZeRO in the port over two gloo ranks on the CPU, against the reference
(``paddle_tpu``) on its two-device virtual mesh.

The two ranks (``tests/torch_hybrid_worker.py zero``) are started once for
the file. The model is the reference's ``Sequential(Linear(8, 16), Tanh(),
Linear(16, 4))`` on a (16, 8) batch, float32, from seeded numpy.

* ``ShardedWeightUpdate`` (ZeRO-1) through ``HybridParallelEngine`` at
  dp = 2 with AdamW, each rank on its half batch, plain and with
  ``FLAGS_quantized_allreduce`` plus error feedback, against the
  reference's engine with ``FLAGS_shard_weight_update`` on (the same
  flags): losses rtol 1e-5, the parameters and the logical optimizer state
  after 3 steps rtol 1e-4 / atol 1e-6 (float32 sum order; the int8 blocks
  round where the reference's do); each rank holds padded/2 elements of
  each moment and the optimizer's own accumulators stay empty until
  ``sync_optimizer_state``;
* ZeRO stage 1 (``group_sharded_parallel(level="os")`` and
  ``fleet.distributed_optimizer`` at sharding_degree = 2) and ``"os_g"``
  (stage 2: gradients reduce-scattered) through the engine, against the
  reference's ``ShardingOptimizerStage1``/``ShardingStage2`` on its
  ``sharding`` mesh (Adam): parameters and the gathered logical moments
  after 3 steps rtol 1e-5 / atol 1e-6, each rank's moments half the
  sharded dimension;
* one rank, no spawn: the sharded update over a group of one with a decay
  gate that varies inside a bucket equals the plain AdamW update (rtol
  1e-6 / atol 1e-7), and ``p_g_os`` (``ShardingStage3``) over no group of
  more than one rank leaves the model and its optimizer as they are (its
  multi-rank parity: tests/test_torch_zero3.py).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.collective import Group as JGroup
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.meta_parallel import sharding as jsharding
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.framework import flags as jflags
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
    ShardedWeightUpdate
from torch_port_util import spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
QFLAGS = ("FLAGS_shard_weight_update", "FLAGS_quantized_allreduce",
          "FLAGS_quantized_allreduce_error_feedback")


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))


def _state(m):
    return {k: np.asarray(v, np.float32) for k, v in m.state_dict().items()}


def _accums(opt):
    return [{k: np.asarray(v, np.float32)
             for k, v in opt._accumulators.get(id(p), {}).items()}
            for p in opt._parameter_list]


def _reference(inp):
    ref = {}
    rng = np.random.RandomState(5)
    x = rng.rand(16, 8).astype(np.float32)
    y = rng.rand(16, 4).astype(np.float32)
    inp["mlp_x"], inp["mlp_y"] = x, y
    inp.update({f"mlp.{k}": v for k, v in _state(_mlp()).items()})
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)
    old = {k: jflags.flag(k) for k in QFLAGS}
    try:
        for tag, quant in (("plain", False), ("quantized", True)):
            jflags.set_flags({"FLAGS_shard_weight_update": True,
                              "FLAGS_quantized_allreduce": quant,
                              "FLAGS_quantized_allreduce_error_feedback":
                                  quant})
            m = _mlp()
            o = paddle.optimizer.AdamW(learning_rate=0.01,
                                       parameters=m.parameters())
            eng = JEngine(m, o, _mse, mesh=jbuild_mesh(("dp",), (2,)))
            losses = [float(eng.train_step(tx, ty).numpy())
                      for _ in range(3)]
            assert eng._wus is not None
            eng.sync_optimizer_state()
            ref[f"wus_{tag}"] = {"losses": losses, "params": _state(m),
                                 "opt": _accums(o)}
    finally:
        jflags.set_flags(old)
    group = JGroup(axis_name="sharding", nranks=2)
    for level in ("os", "os_g"):
        m = _mlp()
        o = paddle.optimizer.Adam(learning_rate=0.01,
                                  parameters=m.parameters())
        s1 = jsharding.ShardingOptimizerStage1(o, group=group)
        model = m if level == "os" else jsharding.ShardingStage2(m, s1,
                                                                 group=group)
        eng = JEngine(model, o, _mse, mesh=jbuild_mesh(("sharding",), (2,)),
                      dp_axes=())
        losses = [float(eng.train_step(tx, ty).numpy()) for _ in range(3)]
        ref[f"stage_{level}"] = {"losses": losses, "params": _state(m),
                                 "opt": _accums(o)}
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("zero")
    inp = {}
    ref = _reference(inp)
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["zero", d], 2, d, RANK_TIMEOUT_S), ref


def _same_opt(got, want, **tol):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (i, sorted(g), sorted(w))
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], err_msg=f"{i}.{k}",
                                       **tol)


@pytest.mark.parametrize("tag", ["plain", "quantized"])
def test_sharded_weight_update_dp2_matches_reference(ranks, tag):
    got, ref = ranks
    want = ref[f"wus_{tag}"]
    tol = dict(rtol=1e-4, atol=1e-6)
    for g in got:
        res = g[f"wus_{tag}"]
        assert res["built"]
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(res["params"][k].numpy(), w,
                                       err_msg=k, **tol)
        _same_opt(res["opt"], want["opt"], **tol)


def test_each_rank_holds_half_the_moments(ranks):
    got, _ = ranks
    for g in got:
        for tag in ("plain", "quantized"):
            res = g[f"wus_{tag}"]
            want = sum(p // 2 * s for p, s in zip(res["padded"],
                                                   res["itemsize"]))
            assert res["shard_bytes"] == want * res["keys"] > 0
            assert res["base_accums_before_sync"] == 0


@pytest.mark.parametrize("level", ["os", "os_g", "fleet"])
def test_sharding_stage_matches_reference(ranks, level):
    got, ref = ranks
    want = ref["stage_os_g" if level == "os_g" else "stage_os"]
    tol = dict(rtol=1e-5, atol=1e-6)
    for g in got:
        res = g[f"stage_{level}"]
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["params"].items():
            np.testing.assert_allclose(res["params"][k].numpy(), w,
                                       err_msg=k, **tol)
        _same_opt(res["opt"], want["opt"], **tol)
        # every parameter's first dimension splits over 2: half a moment
        for shapes, p in zip(res["local_shapes"], want["params"].values()):
            for shape in shapes.values():
                assert shape == (p.shape[0] // 2,) + p.shape[1:]
    wrappers = {g[f"stage_{level}"]["wrapper"] for g in got}
    assert wrappers == {"ShardingStage2" if level == "os_g" else "MLP"}


def test_sharded_update_with_mixed_decay_gates_equals_plain_adamw():
    """A bucket holding decayed and excluded parameters: the rule runs once
    a run of equal gate on the flat shard, as the reference's per-element
    gate vector does."""
    torch.manual_seed(0)
    mk = lambda: [torch.nn.Parameter(torch.randn(*s))  # noqa: E731
                  for s in ((8, 16), (16,), (16, 4), (4,))]
    pa, pb = mk(), mk()
    with torch.no_grad():
        for a, b in zip(pa, pb):
            b.copy_(a)
    decay = lambda n: n.startswith("w")  # noqa: E731
    names = ["w0", "b0", "w1", "b1"]
    oa = pt.optimizer.AdamW(0.01, parameters=list(zip(names, pa)),
                            apply_decay_param_fun=decay)
    ob = pt.optimizer.AdamW(0.01, parameters=list(zip(names, pb)),
                            apply_decay_param_fun=decay)
    wus = ShardedWeightUpdate(ob, pb, None, 1)
    assert len(wus.plan) == 1 and len(set(wus.plan.buckets[0].wds)) == 2
    for step in range(3):
        grads = [torch.randn_like(p) for p in pa]
        for p, q, g in zip(pa, pb, grads):
            p.grad, q.grad = g.clone(), g.clone()
        oa._step(functional=True, with_params=True)
        ob._step_count += 1
        wus.apply()
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    wus.sync_back()
    for n in names:
        for k in ("moment1", "moment2"):
            np.testing.assert_allclose(ob._accumulators[n][k].numpy(),
                                       oa._accumulators[n][k].numpy(),
                                       rtol=1e-6, atol=1e-7)


def test_part2_raises():
    """ZeRO-3 and the wrappers that raised naming A11b, part 2 build: over
    no group of more than one rank ``p_g_os`` slices nothing, returns the
    raw optimizer, and its steps equal the plain model's bit for bit."""
    torch.manual_seed(0)
    x, y = torch.randn(6, 4), torch.randn(6, 4)
    plain = pt.nn.Linear(4, 4, device="cpu")
    m = pt.nn.Linear(4, 4, device="cpu")
    m.set_state_dict(plain.state_dict())
    opt = pt.optimizer.AdamW(0.1, parameters=m.parameters())
    popt = pt.optimizer.AdamW(0.1, parameters=plain.parameters())
    model, o, scaler = tmp.group_sharded_parallel(m, opt, "p_g_os")
    assert isinstance(model, tmp.ShardingStage3) and o is opt
    assert scaler is None and not model._held
    for _ in range(2):
        for mm, oo in ((model, opt), (plain, popt)):
            _mse(mm, x, y).backward()
            oo.step()
            oo.clear_grad()
    for k, v in model.state_dict().items():
        assert torch.equal(v, plain.state_dict()[k]), k
    assert [tuple(p.shape) for p in model.get_all_parameters()] == [
        (4, 4), (4,)]
    assert isinstance(tmp.ShardingStage3(m, opt), tmp.ShardingStage3)
    assert torch.equal(tmp.PipelineParallel(m, None, None)(x), m(x))
    with pytest.raises(ValueError, match="unknown sharding level"):
        tmp.group_sharded_parallel(m, opt, "p_g")
