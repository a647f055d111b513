"""The MoE layer and the expert all-to-all of the port against the
reference (``paddle_tpu``): in-process at ep = 1, and over four gloo ranks
on the CPU at ep = 2 (two groups of two) and ep = 4 against the
reference's ``moe_dispatch_combine`` inside a ``shard_map`` over ``"ep"``
on its virtual devices (as ``__graft_entry__.py`` drives it).

Inputs are float32 numpy from seeds, so no top-k tie changes a route.
Tolerances: float32 sum order, rtol 1e-5 / atol 1e-6 on outputs and the
auxiliary loss, rtol 1e-4 / atol 1e-6 on gradients.

* ``moe_dispatch_combine`` and ``MoELayer`` (d_model 8, d_hidden 16,
  8 experts, top 2) at ep = 1: combined output, auxiliary loss, and the
  gradients of ``mean(out ** 2) + 0.01 * aux`` with respect to x, the gate
  and the experts;
* at ep = 2 and 4 (16 tokens a rank): each rank's output rows, its
  auxiliary loss (over its own tokens, not reduced over ep), the gradient
  of its x rows, of the gate (its own), and of its experts' shards of
  ``w_up``/``w_down``; each rank holds 8/ep experts;
* ``global_scatter``/``global_gather``: the tiled all-to-all over the
  group and back, the identity without one;
* ``HybridParallelEngine`` over a (dp 2, ep 2) mesh runs ep as replicas
  of a MoE layer without an ep group, as the reference's engine does: 2
  SGD steps on each dp rank's half (capacity factor 4, so no token is
  dropped and a rank's routing is the logical batch's) against the
  reference's engine on the whole batch, losses rtol 1e-5, weights rtol
  1e-4 / atol 1e-6;
* capacity drops (capacity factor 0.5: the dropped count is the
  reference's routing's) and ``"gelu"`` as ``jax.nn.gelu``'s tanh form,
  with the other ``jax.nn`` names.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from jax.sharding import Mesh, PartitionSpec as P
from paddle_tpu.core.compat import shard_map
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.meta_parallel import moe_layer as jmoe
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu_torch.distributed import utils as tutils
from paddle_tpu_torch.distributed.fleet.meta_parallel import moe_layer as tmoe
from paddle_tpu_torch.models import (ep_merge_state_dicts,
                                     ep_split_state_dict,
                                     load_reference_state_dict)
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
D, H, E, T = 8, 16, 8, 16
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _jlayer(**kw):
    paddle.seed(13)
    return jmoe.MoELayer(D, H, E, top_k=2, **kw)


def _local_moe(x, gw, wu, wd, axis=None):
    """The reference's routed layer on local tokens and (local) experts;
    returns (loss, (out, aux))."""
    def expert_fn(buckets, local=False):
        rep = buckets.shape[0] // wu.shape[0]
        h = jnp.einsum("ecd,edh->ech", buckets, jnp.tile(wu, (rep, 1, 1)))
        return jnp.einsum("ech,ehd->ecd", jax.nn.gelu(h),
                          jnp.tile(wd, (rep, 1, 1)))

    out, aux = jmoe.moe_dispatch_combine(x, x @ gw, expert_fn, E,
                                         axis_name=axis, k=2)
    return jnp.mean(jnp.square(out)) + 0.01 * aux, (out, aux)


def _reference_ep(ep, weights, x):
    """Per rank (stacked): out, aux, dx, dgate, dw_up, dw_down."""
    mesh = Mesh(np.asarray(jax.devices()[:ep]), ("ep",))

    def body(x, gw, wu, wd):
        (_, (out, aux)), g = jax.value_and_grad(
            lambda *a: _local_moe(*a, axis="ep"), argnums=(0, 1, 2, 3),
            has_aux=True)(x, gw, wu, wd)
        return out, aux[None], g[0], g[1][None], g[2], g[3]

    fn = shard_map(body, mesh=mesh,
                   in_specs=(P("ep"), P(), P("ep"), P("ep")),
                   out_specs=(P("ep"),) * 6, check_vma=False)
    res = jax.jit(fn)(x, weights["gate.weight"], weights["w_up"],
                      weights["w_down"])
    return [np.asarray(r) for r in res]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe")
    weights = reference_state(_jlayer())
    x = np.random.RandomState(4).randn(4 * T, D).astype(np.float32)
    inp = {f"moe.{k}": v for k, v in weights.items()}
    inp["moe_x"], inp["moe_tokens"] = x, np.array(T)
    ref = {ep: _reference_ep(ep, weights, x[:ep * T]) for ep in (2, 4)}
    y = np.random.RandomState(8).randn(4 * T, D).astype(np.float32)
    inp["moe_y"] = y
    # the reference's engine over a (dp 2, ep 2) mesh: ep replicates
    jl = _jlayer(capacity_factor=4.0)
    eng = JEngine(jl, paddle.optimizer.SGD(learning_rate=0.1,
                                           parameters=jl.parameters()),
                  _mse, mesh=jbuild_mesh(("dp", "ep"), (2, 2)))
    tx, ty = paddle.to_tensor(x[:2 * T]), paddle.to_tensor(y[:2 * T])
    ref["engine"] = {"losses": [float(eng.train_step(tx, ty).numpy())
                                for _ in range(2)],
                     "state": reference_state(jl)}
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["moe", d], 4, d, RANK_TIMEOUT_S), ref


def _port_layer(weights, **kw):
    layer = tmoe.MoELayer(D, H, E, top_k=2, device="cpu", **kw)
    load_reference_state_dict(layer, weights)
    return layer


def test_moe_at_ep1_matches_the_reference():
    jl = _jlayer()
    weights = reference_state(jl)
    x = np.random.RandomState(2).randn(2, T // 2, D).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    ((jout ** 2).mean() + 0.01 * jl.aux_loss).backward()
    tl = _port_layer(weights)
    tx = torch.from_numpy(x).requires_grad_()
    tout = tl(tx)
    ((tout ** 2).mean() + 0.01 * tl.aux_loss).backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **OUT)
    np.testing.assert_allclose(float(tl.aux_loss.detach()),
                               float(jl.aux_loss.numpy()), **OUT)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **GRAD)
    for n, p in tl.named_parameters():
        jp = dict(jl.named_parameters())[n]
        np.testing.assert_allclose(p.grad.numpy(), jp.grad.numpy(),
                                   err_msg=n, **GRAD)


def test_dispatch_combine_at_ep1_matches_the_reference():
    weights = reference_state(_jlayer())
    x = np.random.RandomState(3).randn(T, D).astype(np.float32)
    (jl, (jout, jaux)), jg = jax.value_and_grad(
        _local_moe, argnums=(0, 1, 2, 3), has_aux=True)(
        x, weights["gate.weight"], weights["w_up"], weights["w_down"])
    ts = [torch.from_numpy(a).requires_grad_() for a in (
        x, weights["gate.weight"], weights["w_up"], weights["w_down"])]

    def experts(buckets, local=False):
        h = torch.nn.functional.gelu(
            torch.einsum("ecd,edh->ech", buckets, ts[2]), approximate="tanh")
        return torch.einsum("ech,ehd->ecd", h, ts[3])

    out, aux = tmoe.moe_dispatch_combine(ts[0], ts[0] @ ts[1], experts, E)
    ((out ** 2).mean() + 0.01 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **OUT)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **OUT)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **GRAD)


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_over_ep_ranks_matches_the_reference_shard_map(ranks, ep):
    got, ref = ranks
    out, aux, dx, dgate, dwu, dwd = ref[ep]
    local = E // ep
    for g in got:
        res = g[f"ep{ep}"]
        r = res["rank"]
        rows = slice(r * T, (r + 1) * T)
        ex = slice(r * local, (r + 1) * local)
        assert res["shapes"]["w_up"] == (local, D, H)
        np.testing.assert_allclose(res["out"].numpy(), out[rows], **OUT)
        np.testing.assert_allclose(float(res["aux"]), aux[r], **OUT)
        np.testing.assert_allclose(res["dx"].numpy(), dx[rows], **GRAD)
        np.testing.assert_allclose(res["grads"]["gate.weight"].numpy(),
                                   dgate[r], **GRAD)
        np.testing.assert_allclose(res["grads"]["w_up"].numpy(), dwu[ex],
                                   **GRAD)
        np.testing.assert_allclose(res["grads"]["w_down"].numpy(), dwd[ex],
                                   **GRAD)


@pytest.mark.parametrize("ep", [2, 4])
def test_global_scatter_and_gather_exchange_rows(ranks, ep):
    got, _ = ranks
    for g in got:
        r = g[f"ep{ep}"]["rank"]
        scattered, back = g[f"scatter{ep}"]
        want = np.concatenate([np.arange(4 * ep, dtype=np.float32)[
            4 * r:4 * r + 4] + 100 * j for j in range(ep)])
        np.testing.assert_array_equal(scattered.numpy(), want)
        np.testing.assert_array_equal(
            back.numpy(), np.arange(4 * ep, dtype=np.float32) + 100 * r)
    rows = torch.arange(6.0)
    assert tutils.global_scatter(rows) is rows
    assert tutils.global_gather(rows) is rows


def test_capacity_drops_as_the_reference_routes():
    weights = reference_state(_jlayer(capacity_factor=0.5))
    x = np.random.RandomState(6).randn(T, D).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(x @ weights["gate.weight"], axis=-1))
    idx = np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1])
    cap = int(math.ceil(2 * T * 0.5 / E))
    counts = np.bincount(idx.reshape(-1), minlength=E)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert dropped > 0
    tl = _port_layer(weights, capacity_factor=0.5)
    jl = _jlayer(capacity_factor=0.5)
    tout = tl(torch.from_numpy(x))
    assert tl.dropped_tokens() == dropped
    np.testing.assert_allclose(tout.detach().numpy(),
                               jl(paddle.to_tensor(x)).numpy(), **OUT)


@pytest.mark.parametrize("name", sorted(tmoe.ACTIVATIONS))
def test_activation_names_are_jax_nn(name):
    h = np.linspace(-4, 4, 33).astype(np.float32)
    want = np.asarray(getattr(jax.nn, name)(h))
    got = tmoe.ACTIVATIONS[name](torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_expert_state_splits_and_merges_along_dim0():
    weights = reference_state(_jlayer())
    parts = ep_split_state_dict(weights, 4)
    assert parts[1]["w_up"].shape == (2, D, H)
    np.testing.assert_array_equal(parts[1]["w_down"].numpy(),
                                  weights["w_down"][2:4])
    assert parts[3]["gate.weight"].shape == (D, E)
    back = ep_merge_state_dicts(parts)
    for k, v in weights.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)


def test_engine_runs_ep_as_replicas_as_the_reference(ranks):
    got, ref = ranks
    want = ref["engine"]
    for r, g in enumerate(got):
        res = g["engine_ep"]
        assert res["sync_ranks"] == [r % 2, r % 2 + 2]  # the dp group
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["state"].items():
            np.testing.assert_allclose(res["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
