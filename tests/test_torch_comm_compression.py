"""The DGC and LocalSGD meta-optimizers of the port against the
reference's rules (``paddle_tpu``'s ``DGCMomentumOptimizer`` and
``LocalSGDOptimizer``): on one rank in-process, and at dp = 2 over two
gloo ranks on the CPU against the reference's step inside a
``shard_map`` over ``"dp"`` on two virtual devices (where its ``_pmean``
and ``sync_params`` run ``lax.pmean``).

The model is the reference's ``Sequential(Linear(8, 16), Tanh(),
Linear(16, 4))`` under an MSE loss on a (16, 8) batch, float32, from
seeded numpy; each dp rank takes its half. 4 eager steps each; DGC ramps
up densely for one step, then keeps 50% and 75%... of ``|v|`` by its
sparsity schedule (0.5, 0.75 over 2 steps). Parameters after every step:
rtol 1e-5 / atol 1e-7 (float32; the mask is a threshold on values, so
``top_k``'s order of ties cannot change it).

* DGC and LocalSGD at world 1 against the reference's eager loop;
* at dp = 2: DGC directly and through ``fleet.distributed_optimizer``
  (``strategy.dgc``), and LocalSGD (``strategy.localsgd``, k_steps 2)
  against the reference's rules under ``shard_map``; the port's
  ``HybridParallelOptimizer`` leaves each rank's gradients local under
  both (no pre-sync), as the meta-optimizers communicate themselves;
* ``fleet.distributed_optimizer`` composes DGC first, then LocalSGD, then
  ``HybridParallelOptimizer``, and refuses AdamW under DGC with the
  reference's words; DGC's ``set_state_dict`` refuses stale keys.
"""
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from jax.sharding import Mesh, PartitionSpec as P
from paddle_tpu import nn as jnn
from paddle_tpu.core.compat import shard_map
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet.meta_optimizers.dgc_optimizer import \
    DGCMomentumOptimizer as JDGC
from paddle_tpu.distributed.fleet.meta_optimizers.localsgd_optimizer import \
    LocalSGDOptimizer as JLocalSGD
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.base import fleet_base
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    DGCMomentumOptimizer, LocalSGDOptimizer)
from torch_hybrid_worker import DGC_CFG, MLP, mse
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
NAMES = ("0.weight", "0.bias", "2.weight", "2.bias")
TOL = dict(rtol=1e-5, atol=1e-7)


def _mlp():
    paddle.seed(7)
    return jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))


def _data():
    rng = np.random.RandomState(5)
    return (rng.rand(16, 8).astype(np.float32),
            rng.rand(16, 4).astype(np.float32))


def _loss(params, x, y):
    w0, b0, w1, b1 = params
    return jnp.mean((jnp.tanh(x @ w0 + b0) @ w1 + b1 - y) ** 2)


class _Stub:
    """What the reference's rules read of a parameter, over traced
    arrays."""

    def __init__(self, name, data, grad):
        self.name, self._data, self.stop_gradient = name, data, False
        self.grad = types.SimpleNamespace(_data=grad)

    def _set_data(self, a):
        self._data = a


class _SGD:
    """A plain SGD step over stubs (LocalSGD's inner optimizer)."""

    def __init__(self, params, lr=0.1):
        self._parameter_list, self.lr = params, lr

    def step(self):
        for p in self._parameter_list:
            p._set_data(p._data - self.lr * p.grad._data)


def _reference_dp2(init, x, y, rule):
    """4 steps of ``rule`` at dp = 2 under shard_map, each rank from its
    own parameters: per step, each rank's parameters after it."""
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    params = [jnp.stack([jnp.asarray(init[n])] * 2) for n in NAMES]
    us = vs = [jnp.zeros_like(p) for p in params]
    out = []
    for step in range(4):
        def body(ps, xs, ys, us, vs, step=step):
            ps = [p[0] for p in ps]
            grads = jax.grad(_loss)(ps, xs, ys)
            stubs = [_Stub(n, p, g) for n, p, g in zip(NAMES, ps, grads)]
            if rule == "dgc":
                opt = JDGC(learning_rate=0.1, momentum=0.9, parameters=stubs,
                           axis_name="dp", **DGC_CFG)
                opt._step_count = step
                opt._u = {n: u[0] for n, u in zip(NAMES, us)}
                opt._v = {n: v[0] for n, v in zip(NAMES, vs)}
                opt.step()
                us = [opt._u[n][None] for n in NAMES]
                vs = [opt._v.get(n, v[0])[None] for n, v in zip(NAMES, vs)]
            else:
                opt = JLocalSGD(_SGD(stubs), k_steps=2, axis_name="dp")
                opt._local_steps = step
                opt.step()
            return [s._data[None] for s in stubs], us, vs

        spec = [P("dp")] * 4
        fn = shard_map(body, mesh=mesh,
                       in_specs=(spec, P("dp"), P("dp"), spec, spec),
                       out_specs=(spec, spec, spec), check_vma=False)
        params, us, vs = jax.jit(fn)(params, x, y, us, vs)
        out.append([[np.asarray(a)[r] for a in params] for r in range(2)])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("comm")
    x, y = _data()
    init = reference_state(_mlp())
    inp = {"mlp_x": x, "mlp_y": y}
    inp.update({f"mlp.{k}": v for k, v in init.items()})
    ref = {rule: _reference_dp2(init, x, y, rule)
           for rule in ("dgc", "localsgd")}
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["comm", d], 2, d, RANK_TIMEOUT_S), ref


@pytest.mark.parametrize("run", ["dgc", "dgc_fleet", "localsgd"])
def test_dp2_matches_the_reference_rule(ranks, run):
    got, ref = ranks
    want = ref["localsgd" if run == "localsgd" else "dgc"]
    for r, g in enumerate(got):
        for step, st in enumerate(g[run]["states"]):
            for n, w in zip(NAMES, want[step][r]):
                np.testing.assert_allclose(st[n].numpy(), w,
                                           err_msg=f"{step}:{n}", **TOL)
    # DGC's and the synced LocalSGD steps leave the ranks equal
    for step in (0, 1, 2, 3) if run != "localsgd" else (1, 3):
        for n in NAMES:
            assert torch.equal(got[0][run]["states"][step][n],
                               got[1][run]["states"][step][n])


@pytest.mark.parametrize("run", ["dgc_fleet", "localsgd"])
def test_no_gradient_pre_sync_under_the_meta_optimizers(ranks, run):
    got, _ = ranks
    for g in got:
        assert all(g[run]["local"])
        assert g[run]["kind"] == ("DGCMomentumOptimizer" if run == "dgc_fleet"
                                  else "LocalSGDOptimizer")
    assert got[0]["dgc"]["fraction"] < 0.3


def _port_mlp(init):
    from paddle_tpu_torch.models import load_reference_state_dict

    m = MLP()
    load_reference_state_dict(m, init)
    return m


@pytest.mark.parametrize("rule", ["dgc", "localsgd"])
def test_one_rank_matches_the_reference_eager_loop(rule):
    x, y = _data()
    jm = _mlp()
    tm = _port_mlp(reference_state(jm))
    if rule == "dgc":
        jo = JDGC(learning_rate=0.1, momentum=0.9,
                  parameters=jm.parameters(), **DGC_CFG)
        to = DGCMomentumOptimizer(0.1, 0.9, tm.parameters(), **DGC_CFG)
    else:
        jo = JLocalSGD(paddle.optimizer.SGD(learning_rate=0.1,
                                            parameters=jm.parameters()),
                       k_steps=2)
        to = LocalSGDOptimizer(pt.optimizer.SGD(0.1,
                                                parameters=tm.parameters()),
                               k_steps=2)
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for step in range(4):
        ((jm(jx) - jy) ** 2).mean().backward()
        jo.step()
        jo.clear_grad()
        mse(tm, tx, ty).backward()
        to.step()
        to.clear_grad()
        want = reference_state(jm)
        for n, p in tm.state_dict().items():
            np.testing.assert_allclose(p.numpy(), want[n],
                                       err_msg=f"{step}:{n}", **TOL)
    if rule == "dgc":
        assert to.last_comm_fraction == jo.last_comm_fraction
        with pytest.raises(ValueError, match="match no parameter"):
            to.set_state_dict({"u": {"stale": torch.zeros(1)}})


def _chain(opt):
    names = []
    while opt is not None:
        names.append(type(opt).__name__)
        opt = opt.__dict__.get("_inner_opt") or opt.__dict__.get("inner")
    return names


def test_distributed_optimizer_composes_as_the_reference():
    fleet_base._reset()
    jm, tm = _mlp(), _port_mlp(reference_state(_mlp()))
    for dgc, local in ((True, False), (False, True), (True, True)):
        js, ts = jfleet.DistributedStrategy(), fleet.DistributedStrategy()
        for s in (js, ts):
            s.dgc, s.localsgd = dgc, local
        jo = jfleet.distributed_optimizer(paddle.optimizer.Momentum(
            learning_rate=0.1, parameters=jm.parameters()), js)
        to = fleet.distributed_optimizer(pt.optimizer.Momentum(
            0.1, parameters=tm.parameters()), ts)
        assert _chain(to) == _chain(jo)[:len(_chain(to))]
        assert _chain(to)[-1] in ("DGCMomentumOptimizer", "Momentum")
        assert to.get_lr() == 0.1
    js, ts = jfleet.DistributedStrategy(), fleet.DistributedStrategy()
    js.dgc = ts.dgc = True
    with pytest.raises(ValueError) as je:
        jfleet.distributed_optimizer(paddle.optimizer.AdamW(
            parameters=jm.parameters()), js)
    with pytest.raises(ValueError) as te:
        fleet.distributed_optimizer(pt.optimizer.AdamW(
            parameters=tm.parameters()), ts)
    assert str(te.value) == str(je.value)
