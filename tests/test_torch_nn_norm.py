"""``paddle_tpu_torch.nn``'s normalisation functions and layers against the
JAX package's, on the same numpy inputs from a seed: outputs, gradients of a
weighted sum of them, and the batch norms' running statistics.

- The batch norms run two training steps (outputs, input and parameter
  gradients, ``_mean`` and ``_variance`` after each: Paddle's momentum is
  the weight of the old value) and then eval, in every layout.
- ``load_reference_state_dict`` carries the reference's persistable buffers
  (repaired: it carried parameters only, so a BatchNorm state was refused):
  a trained reference BatchNorm's state gives the same eval outputs.
- ``SyncBatchNorm`` at two gloo ranks, each on half the batch, equals the
  reference's ``BatchNorm2D`` on the whole batch (statistics, gradients,
  buffers).

Tolerances: f32 rtol 1e-5, atol 1e-6 (gradients atol 1e-5).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, carry, check, check_layer, reference_state
from torch_port_util import cpu_device, spawn_ranks

WORKER = Path(__file__).resolve().parent / "torch_nn_worker.py"


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(2)
IMG = (_R.randn(4, 6, 5, 3) * 2 + 1).astype(np.float32)
SEQ = _R.randn(4, 6, 7).astype(np.float32)
VOL = _R.randn(2, 6, 3, 4, 2).astype(np.float32)
VEC = _R.randn(8, 6).astype(np.float32)
C6 = _R.randn(6).astype(np.float32)
W = _R.randn(5, 4, 3).astype(np.float32)


def _nhwc(a):
    return np.moveaxis(a, 1, -1).copy()


FUNCTIONS = {
    "batch_norm_train": (JF.batch_norm, TF.batch_norm, lambda: (
        (A(IMG), A(np.zeros(6, np.float32), grad=False),
         A(np.ones(6, np.float32), grad=False), A(C6), A(C6 + 1)),
        {"training": True, "momentum": 0.7})),
    "batch_norm_eval": (JF.batch_norm, TF.batch_norm, lambda: (
        (A(IMG), A(C6, grad=False), A(np.abs(C6) + 0.5, grad=False), A(C6)),
        {"epsilon": 1e-3})),
    "batch_norm_nhwc": (JF.batch_norm, TF.batch_norm, lambda: (
        (A(_nhwc(IMG)), A(np.zeros(6, np.float32), grad=False),
         A(np.ones(6, np.float32), grad=False)),
        {"training": True, "data_format": "NHWC"})),
    "batch_norm_global_stats": (JF.batch_norm, TF.batch_norm, lambda: (
        (A(SEQ), A(C6, grad=False), A(np.abs(C6) + 0.5, grad=False)),
        {"training": True, "use_global_stats": True,
         "data_format": "NCL"})),
    "layer_norm": (JF.layer_norm, TF.layer_norm, lambda: (
        (A(SEQ), [6, 7]), {})),
    "group_norm": (JF.group_norm, TF.group_norm, lambda: (
        (A(IMG), 3), {"weight": A(C6), "bias": A(C6 * 2)})),
    "group_norm_nhwc": (JF.group_norm, TF.group_norm, lambda: (
        (A(_nhwc(IMG)), 2), {"weight": A(C6), "data_format": "NHWC"})),
    "instance_norm": (JF.instance_norm, TF.instance_norm, lambda: (
        (A(IMG),), {"weight": A(C6), "bias": A(C6), "eps": 1e-3})),
    "instance_norm_3d": (JF.instance_norm, TF.instance_norm, lambda: (
        (A(VOL),), {})),
    "local_response_norm": (JF.local_response_norm, TF.local_response_norm,
                            lambda: ((A(IMG), 3), {"alpha": 0.1, "k": 2.0})),
    "local_response_norm_even": (JF.local_response_norm,
                                 TF.local_response_norm,
                                 lambda: ((A(SEQ), 4), {"beta": 0.5})),
    "spectral_norm": (JF.spectral_norm, TF.spectral_norm, lambda: (
        (A(W),), {"dim": 1, "power_iters": 3})),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function(case):
    jfn, tfn, build = FUNCTIONS[case]
    args, kw = build()
    check(jfn, tfn, args, kw, atol=1e-5, what=case)


def test_batch_norm_updates_running_stats_with_paddles_momentum():
    rm, rv = torch.zeros(6), torch.ones(6)
    x = torch.tensor(IMG)
    TF.batch_norm(x, rm, rv, training=True, momentum=0.9)
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=True)
    np.testing.assert_allclose(rm.numpy(), (0.1 * mean).numpy(), rtol=1e-5)
    np.testing.assert_allclose(rv.numpy(), (0.9 + 0.1 * var).numpy(),
                               rtol=1e-5)


BATCH_NORMS = {
    "BatchNorm1D": (lambda m, **kw: m.BatchNorm1D(6, momentum=0.8, **kw),
                    SEQ),
    "BatchNorm1D_2d": (lambda m, **kw: m.BatchNorm1D(6, **kw), VEC),
    "BatchNorm2D": (lambda m, **kw: m.BatchNorm2D(6, epsilon=1e-3, **kw),
                    IMG),
    "BatchNorm2D_nhwc": (lambda m, **kw: m.BatchNorm2D(
        6, data_format="NHWC", **kw), _nhwc(IMG)),
    "BatchNorm3D": (lambda m, **kw: m.BatchNorm3D(6, **kw), VOL),
    "BatchNorm_act": (lambda m, **kw: m.BatchNorm(6, act="relu", **kw), IMG),
    "SyncBatchNorm": (lambda m, **kw: m.SyncBatchNorm(6, **kw), IMG),
}


@pytest.mark.parametrize("name", sorted(BATCH_NORMS))
def test_batch_norm_layer_two_steps_then_eval(name):
    build, x = BATCH_NORMS[name]
    jl, tl = build(jnn), build(tnn, device="cpu")
    assert [n for n, _ in tl.state_dict().items()] == \
        list(jl.state_dict().keys())
    assert tl._mean.dtype == torch.float32
    for step in range(2):
        xs = x * (1 + step) + step
        check_layer(jl, tl, (A(xs),), atol=1e-5, what=f"{name} {step}") \
            if step == 0 else check(jl, tl, (A(xs),), atol=1e-5)
        for buf in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tl, buf).numpy(),
                np.asarray(getattr(jl, buf).numpy()), rtol=1e-5, atol=1e-6,
                err_msg=f"{name} {buf} after step {step}")
    jl.eval()
    tl.eval()
    check(jl, tl, (A(x),), atol=1e-5, what=f"{name} eval")


def test_a_batch_norm_state_carries_across():
    """The reference's ``state_dict()`` holds the running statistics: the
    port loads them (and refuses a state without them)."""
    jl = jnn.BatchNorm2D(6, momentum=0.5)
    for s in range(3):
        jl(paddle.to_tensor(IMG * (s + 1)))
    jl.eval()
    state = reference_state(jl)
    assert {"_mean", "_variance"} <= set(state)
    tl = tnn.BatchNorm2D(6, device="cpu")
    carry(jl, tl)
    tl.eval()
    np.testing.assert_allclose(tl._mean.numpy(), state["_mean"])
    np.testing.assert_allclose(tl(torch.tensor(IMG)).detach().numpy(),
                               np.asarray(jl(paddle.to_tensor(IMG)).numpy()),
                               rtol=1e-5, atol=1e-5)
    from paddle_tpu_torch.models import load_reference_state_dict

    with pytest.raises(ValueError, match="missing.*_variance"):
        load_reference_state_dict(tl, {k: v for k, v in state.items()
                                       if k != "_variance"})


LAYERS = {
    "LayerNorm": (lambda m, **kw: m.LayerNorm([6, 7], epsilon=1e-4, **kw),
                  SEQ),
    "GroupNorm": (lambda m, **kw: m.GroupNorm(2, 6, **kw), IMG),
    "GroupNorm_nhwc": (lambda m, **kw: m.GroupNorm(
        3, 6, data_format="NHWC", **kw), _nhwc(IMG)),
    "InstanceNorm1D": (lambda m, **kw: m.InstanceNorm1D(6, **kw), SEQ),
    "InstanceNorm2D": (lambda m, **kw: m.InstanceNorm2D(6, **kw), IMG),
    "InstanceNorm3D": (lambda m, **kw: m.InstanceNorm3D(
        6, weight_attr=False, **kw), VOL),
    "LocalResponseNorm": (lambda m, **kw: m.LocalResponseNorm(5, **kw), IMG),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    build, x = LAYERS[name]
    jl, tl = build(jnn), build(tnn, device="cpu")
    check_layer(jl, tl, (A(x),), atol=1e-5, what=name)


def test_spectral_norm_layer():
    jl = jnn.SpectralNorm([5, 4, 3], dim=0, power_iters=2)
    tl = tnn.SpectralNorm([5, 4, 3], dim=0, power_iters=2, device="cpu")
    assert not list(tl.state_dict())
    check(jl, tl, (A(W),), atol=1e-5)


def test_convert_sync_batchnorm_shares_state():
    with cpu_device():
        net = tnn.Sequential(tnn.Conv2D(6, 6, 1), tnn.BatchNorm2D(6))
    bn = net[1]
    out = tnn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(out[1], tnn.SyncBatchNorm)
    assert out[1].weight is bn.weight and out[1]._mean is bn._mean
    assert set(out.state_dict()) == set(dict(net.named_parameters())) | {
        "1._mean", "1._variance"}


@pytest.fixture(scope="module")
def syncbn_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("syncbn")
    rng = np.random.RandomState(7)
    inp = {"x1": rng.randn(4, 3, 5, 5).astype(np.float32) * 2 + 1,
           "x2": rng.randn(4, 3, 5, 5).astype(np.float32) - 0.5,
           "g1": rng.randn(4, 3, 5, 5).astype(np.float32),
           "g2": rng.randn(4, 3, 5, 5).astype(np.float32),
           "w": rng.rand(3).astype(np.float32) + 0.5,
           "b": rng.randn(3).astype(np.float32)}
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["syncbn", d], 2, d, 240), inp


def test_sync_batch_norm_two_ranks_equals_whole_batch(syncbn_ranks):
    ranks, inp = syncbn_ranks
    jl = jnn.BatchNorm2D(3, momentum=0.8)
    jl.weight.set_value(inp["w"])
    jl.bias.set_value(inp["b"])
    for step in (1, 2):
        x = paddle.to_tensor(inp[f"x{step}"], stop_gradient=False)
        y = jl(x)
        (y * paddle.to_tensor(inp[f"g{step}"])).sum().backward()
        want = {"y": y, "dx": x.grad}
        for k, v in want.items():
            got = torch.cat([r[f"step{step}"][k] for r in ranks]).numpy()
            np.testing.assert_allclose(got, np.asarray(v.numpy()), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{k} {step}")
        for k, p in (("dw", jl.weight), ("db", jl.bias)):
            got = sum(r[f"step{step}"][k] for r in ranks).numpy()
            np.testing.assert_allclose(got, np.asarray(p.grad.numpy()),
                                       rtol=1e-4, atol=1e-4)
            p.clear_grad()
        for k, buf in (("mean", jl._mean), ("var", jl._variance)):
            for r in ranks:
                np.testing.assert_allclose(r[f"step{step}"][k].numpy(),
                                           np.asarray(buf.numpy()),
                                           rtol=1e-5, atol=1e-6)
    jl.eval()
    got = torch.cat([r["eval"] for r in ranks]).numpy()
    np.testing.assert_allclose(got, np.asarray(jl(paddle.to_tensor(
        inp["x1"])).numpy()), rtol=1e-5, atol=1e-5)
