"""``paddle_tpu_torch.incubate`` against the reference's
``paddle_tpu.incubate`` on the CPU, float32.

The cases of ``tests/test_incubate_operators.py``, of
``tests/test_components.py``'s custom-op and ASP tests, and of
``tests/test_optimizers.py``'s ``TestDistributedFusedLamb`` and
``TestIncubateOptimizerExtras``, run in both packages on the same numpy
inputs (weights copied by name), each held against the other at 1e-5
unless the case says why not. Then what the port adds: the clones where
the reference could alias an immutable array, ``graph_khop_sampler`` held
by structure (its generator is seeded from the framework's, which the two
packages do not share), and the ``torch.Tensor`` method rule of
``register_custom_op``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu import incubate as J
from paddle_tpu_torch import incubate as P
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import cpu_device, public_names

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _carry(tlayer, jlayer):
    load_reference_state_dict(tlayer, {k: np.array(v.numpy()) for k, v in
                                       jlayer.state_dict().items()})


@pytest.mark.parametrize("path,mod", [
    ("incubate/operators.py", "paddle_tpu_torch.incubate.operators"),
    ("incubate/asp.py", "paddle_tpu_torch.incubate.asp"),
    ("incubate/custom_op.py", "paddle_tpu_torch.incubate.custom_op"),
    ("incubate/distributed_fused_lamb.py",
     "paddle_tpu_torch.incubate.distributed_fused_lamb"),
    ("incubate/optimizer_extras.py",
     "paddle_tpu_torch.incubate.optimizer_extras"),
    ("incubate/nn/__init__.py", "paddle_tpu_torch.incubate.nn"),
    ("incubate/host_embedding.py",
     "paddle_tpu_torch.incubate.host_embedding"),
])
def test_every_public_name_has_its_counterpart(path, mod):
    import importlib
    import os

    names = public_names(os.path.join(os.path.dirname(paddle.__file__),
                                      path))
    port = importlib.import_module(mod)
    assert not sorted(n for n in names if not hasattr(port, n))


def test_the_namespace_exports_what_the_reference_does():
    want = [n for n in dir(J) if not n.startswith("_")]
    assert not sorted(n for n in want if not hasattr(P, n))
    assert P.sparse is tp.sparse and P.segment_sum is tp.segment_sum


# -- operators (tests/test_incubate_operators.py) ------------------------------
class TestGraphSendRecv:
    def test_sum_matches_loop_and_reference(self):
        xv = np.arange(12, dtype=np.float32).reshape(4, 3)
        src, dst = np.array([0, 1, 2, 0]), np.array([1, 2, 1, 0])
        out = P.graph_send_recv(torch.tensor(xv), torch.tensor(src),
                                torch.tensor(dst), "sum").numpy()
        want = np.zeros((4, 3), np.float32)
        for s, d in zip(src, dst):
            want[d] += xv[s]
        np.testing.assert_allclose(out, want)

    @pytest.mark.parametrize("pool", ["sum", "mean", "max", "min"])
    @pytest.mark.parametrize("out_size", [None, 9])
    def test_pools_match_reference(self, pool, out_size):
        rng = np.random.RandomState(0)
        xv = rng.randn(7, 5).astype(np.float32)
        src, dst = rng.randint(0, 7, 20), rng.randint(0, 6, 20)
        want = _np(J.graph_send_recv(
            paddle.to_tensor(xv), paddle.to_tensor(src),
            paddle.to_tensor(dst), pool, out_size))
        got = P.graph_send_recv(torch.tensor(xv), torch.tensor(src),
                                torch.tensor(dst), pool, out_size).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_mean_and_untouched_max(self):
        x = torch.ones(3, 2)
        src, dst = torch.tensor([0, 1]), torch.tensor([0, 0])
        np.testing.assert_allclose(
            P.graph_send_recv(x, src, dst, "mean").numpy()[0], 1.0)
        assert P.graph_send_recv(x, src, dst, "max").numpy()[2].sum() == 0

    @pytest.mark.parametrize("pool", ["sum", "mean"])
    def test_grad_matches_reference(self, pool):
        rng = np.random.RandomState(1)
        xv = rng.randn(6, 3).astype(np.float32)
        src, dst = rng.randint(0, 6, 9), rng.randint(0, 6, 9)
        jx = paddle.to_tensor(xv, stop_gradient=False)
        J.graph_send_recv(jx, paddle.to_tensor(src), paddle.to_tensor(dst),
                          pool).sum().backward()
        tx = torch.tensor(xv, requires_grad=True)
        P.graph_send_recv(tx, torch.tensor(src), torch.tensor(dst),
                          pool).sum().backward()
        np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), **TOL)

    def test_grad_flows(self):
        x = torch.tensor(np.random.RandomState(0).randn(4, 3)
                         .astype(np.float32), requires_grad=True)
        P.graph_send_recv(x, torch.tensor([0, 1]), torch.tensor([1, 1]),
                          "sum").sum().backward()
        g = x.grad.numpy()
        assert g[0].sum() == 3.0 and g[2].sum() == 0.0

    def test_bad_pool_raises(self):
        with pytest.raises(ValueError, match="pool_type"):
            P.graph_send_recv(torch.ones(2, 2), torch.tensor([0]),
                              torch.tensor([1]), "prod")


class TestKhopSampler:
    def _graph(self):
        colptr = np.array([0, 2, 3, 5, 6])
        row = np.array([1, 2, 0, 0, 3, 2])
        return row, colptr

    def test_samples_bounded_neighborhood(self):
        row, colptr = self._graph()
        es, ed, samp, re = P.graph_khop_sampler(
            torch.tensor(row), torch.tensor(colptr), torch.tensor([0]), [2])
        assert len(es) == 2 and len(ed) == 2
        uniq = samp.numpy()
        assert 0 in uniq
        assert es.max() < len(uniq) and ed.max() < len(uniq)

    @pytest.mark.parametrize("sizes", [[1], [2, 1], [1, 1, 1]])
    def test_structure_like_the_reference(self, sizes):
        """Held by structure, not bits: every sampled edge is an edge of
        the graph, at most k are taken a node, the reindexing is consistent
        and the seeds come first in their own order; the reference's
        output satisfies the same checks."""
        row, colptr = self._graph()
        seeds = np.array([0, 3])
        for pkg, mk in ((P, torch.tensor), (J, paddle.to_tensor)):
            es, ed, samp, re = (_np(t) for t in pkg.graph_khop_sampler(
                mk(row), mk(colptr), mk(seeds), sizes))
            g_src, g_dst = samp[es], samp[ed]
            edges = {(int(row[j]), v) for v in range(4)
                     for j in range(colptr[v], colptr[v + 1])}
            assert all((int(s), int(d)) in edges
                       for s, d in zip(g_src, g_dst))
            counts = np.bincount(g_dst, minlength=4)
            assert counts.max() <= sum(sizes)
            assert list(samp[re]) == list(seeds)
            assert np.all(np.diff(samp) > 0)

    def test_return_eids_refused(self):
        row, colptr = self._graph()
        with pytest.raises(NotImplementedError):
            P.graph_khop_sampler(row, colptr, np.array([0]), [1],
                                 return_eids=True)


class TestFusedSoftmax:
    def test_mask_fuse_matches_reference(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 3, 4, 5).astype(np.float32)
        m = (rng.rand(2, 1, 4, 5) < 0.3).astype(np.float32) * -1e4
        want = _np(J.softmax_mask_fuse(paddle.to_tensor(x),
                                       paddle.to_tensor(m)))
        got = P.softmax_mask_fuse(torch.tensor(x), torch.tensor(m)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)

    def test_upper_triangle_matches_reference(self):
        x = np.random.RandomState(0).randn(2, 6, 6).astype(np.float32)
        want = _np(J.softmax_mask_fuse_upper_triangle(paddle.to_tensor(x)))
        got = P.softmax_mask_fuse_upper_triangle(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert abs(got[0, 0, 0] - 1.0) < 1e-6 and got[0, 0, 1:].max() < 1e-6


class TestResNetUnit:
    @pytest.mark.parametrize("shortcut", [True, False])
    def test_forward_and_grad_match_reference(self, shortcut):
        paddle.seed(0)
        ju = J.ResNetUnit(3, 8, 3, stride=2, has_shortcut=shortcut,
                          num_channels_z=3)
        tu = P.ResNetUnit(3, 8, 3, stride=2, has_shortcut=shortcut,
                          num_channels_z=3)
        _carry(tu, ju)
        x = np.random.RandomState(0).randn(2, 3, 8, 8).astype(np.float32)
        z = x if shortcut else np.random.RandomState(1).randn(
            2, 8, 4, 4).astype(np.float32)
        jy = ju(paddle.to_tensor(x), z=paddle.to_tensor(z))
        ty = tu(torch.tensor(x), z=torch.tensor(z))
        assert tuple(ty.shape) == (2, 8, 4, 4) and float(ty.detach().min()) >= 0.0
        np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=1e-5,
                                   atol=1e-5)
        for k, v in ju.state_dict().items():  # BatchNorm's running stats
            np.testing.assert_allclose(tu.state_dict()[k].numpy(),
                                       np.asarray(v.numpy()), rtol=1e-5,
                                       atol=1e-6, err_msg=k)

    def test_refuses_nhwc_and_other_acts(self):
        with pytest.raises(NotImplementedError):
            P.ResNetUnit(3, 8, 3, data_format="NHWC")
        with pytest.raises(ValueError):
            P.ResNetUnit(3, 8, 3, act="gelu")


class TestFusedLayers:
    @pytest.mark.parametrize("before", [False, True])
    @pytest.mark.parametrize("kind", ["attn", "ffn", "encoder"])
    def test_matches_reference(self, kind, before):
        from paddle_tpu.incubate import nn as JN
        from paddle_tpu_torch.incubate import nn as PN

        make = {
            "attn": lambda n: n.FusedMultiHeadAttention(
                16, 4, 0.0, 0.0, normalize_before=before),
            "ffn": lambda n: n.FusedFeedForward(
                16, 32, 0.0, normalize_before=before),
            "encoder": lambda n: n.FusedTransformerEncoderLayer(
                16, 4, 32, 0.0, normalize_before=before),
        }[kind]
        paddle.seed(4)
        jl, tl = make(JN), make(PN)
        assert sorted(tl.state_dict()) == sorted(jl.state_dict())
        _carry(tl, jl)
        x = np.random.RandomState(2).randn(2, 5, 16).astype(np.float32)
        # a random projection: sum(y) would give a final LayerNorm's input a
        # gradient of 0 (rounding noise only)
        r = np.random.RandomState(3).randn(2, 5, 16).astype(np.float32)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jl(jx)
        (jy * paddle.to_tensor(r)).sum().backward()
        tx = torch.tensor(x, requires_grad=True)
        ty = tl(tx)
        (ty * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(ty.detach().numpy(), _np(jy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-4,
                                   atol=1e-5)


# -- custom ops (tests/test_components.py TestCustomOp) --------------------------
class TestCustomOp:
    def test_register_and_grad(self):
        import jax.numpy as jnp

        J.register_custom_op("tpt_softsign_ref",
                             lambda x: x / (1 + jnp.abs(x)))
        P.register_custom_op("tpt_softsign", lambda x: x / (1 + x.abs()))
        xv = np.array([1.0, -2.0, 0.5], np.float32)
        jx = paddle.to_tensor(xv, stop_gradient=False)
        paddle.tpt_softsign_ref(jx).sum().backward()
        x = torch.tensor(xv, requires_grad=True)
        y = tp.tpt_softsign(x)
        np.testing.assert_allclose(y.detach().numpy(), xv / (1 + np.abs(xv)),
                                   rtol=1e-6)
        y.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), _np(jx.grad), **TOL)

    def test_custom_vjp(self):
        import jax.numpy as jnp

        J.register_custom_op("tpt_sq_ref", jnp.square,
                             vjp=(lambda x: (jnp.square(x), x),
                                  lambda res, g: (g * 100.0,)))
        P.register_custom_op("tpt_sq", torch.square,
                             vjp=(lambda x: (torch.square(x), x),
                                  lambda res, g: (g * 100.0,)))
        jx = paddle.to_tensor(np.array([3.0], np.float32),
                              stop_gradient=False)
        paddle.tpt_sq_ref(jx).sum().backward()
        x = torch.tensor([3.0], requires_grad=True)
        tp.tpt_sq(x).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [100.0])
        np.testing.assert_allclose(x.grad.numpy(), _np(jx.grad))

    def test_attrs_nondiff_outputs_and_registry(self):
        def split(x, k=2):
            return x * k, torch.argmax(x).to(x.dtype)

        op = P.register_custom_op("tpt_split", split, nondiff_outputs=(1,))
        x = torch.tensor([1.0, 3.0], requires_grad=True)
        a, b = op(x, 3)  # a trailing positional is an attribute
        assert b.requires_grad is False and float(b) == 1.0
        a.sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
        assert P.get_custom_op("tpt_split") is op
        assert "tpt_split" in P.registered_custom_ops()
        with pytest.raises(ValueError, match="already registered"):
            P.register_custom_op("tpt_split", split)

    def test_tensor_method_only_where_torch_lacks_the_name(self):
        P.register_custom_op("tpt_twice", lambda x: x * 2,
                             tensor_method=True)
        assert torch.ones(2).tpt_twice().tolist() == [2.0, 2.0]
        abs_before = torch.Tensor.abs
        P.register_custom_op("abs", lambda x: x * 0, tensor_method=True)
        assert torch.Tensor.abs is abs_before
        assert tp.abs is not P.get_custom_op("abs")  # the top level's own


# -- ASP (tests/test_components.py TestASP) ----------------------------------
class TestASP:
    @pytest.mark.parametrize("case", ["random", "ties", "tail"])
    def test_mask_matches_reference(self, case):
        rng = np.random.RandomState(3)
        if case == "random":
            w = rng.randn(8, 16).astype(np.float32)
        elif case == "ties":  # many equal magnitudes: argsort's order rules
            w = rng.choice([-1.0, 0.0, 1.0, 2.0], (8, 16)).astype(np.float32)
        else:  # a last axis that does not divide stays dense
            w = rng.randn(4, 6).astype(np.float32)
        want = np.asarray(J.asp.compute_mask_nm(w, 2, 4))
        got = P.asp.compute_mask_nm(torch.tensor(w), 2, 4).numpy()
        np.testing.assert_array_equal(got, want)
        assert P.asp.check_mask_nm(w * got, 2, 4)

    def test_prune_and_guarantee_like_the_reference(self):
        paddle.seed(3)
        jm = jnn.Sequential(jnn.Linear(16, 8))
        tm = tp.nn.Sequential(tp.nn.Linear(16, 8))
        _carry(tm, jm)
        J.asp.prune_model(jm, n=2, m=4)
        P.asp.prune_model(tm, n=2, m=4)
        w = tm[0].weight.detach().numpy()
        np.testing.assert_array_equal(w, _np(jm[0].weight))
        assert P.asp.check_mask_nm(w, 2, 4) and (w == 0).mean() >= 0.5 - 1e-6
        rng = np.random.RandomState(0)
        x, y = rng.rand(4, 16).astype(np.float32), \
            rng.rand(4, 8).astype(np.float32)
        jo = J.asp.decorate(paddle.optimizer.SGD(
            learning_rate=0.1, parameters=jm.parameters()))
        to = P.asp.decorate(tp.optimizer.SGD(0.1,
                                             parameters=tm.parameters()))
        ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean() \
            .backward()
        jo.step()
        ((tm(torch.tensor(x)) - torch.tensor(y)) ** 2).mean().backward()
        to.step()
        w = tm[0].weight.detach().numpy()
        assert P.asp.check_mask_nm(w, 2, 4)
        np.testing.assert_allclose(w, _np(jm[0].weight), **TOL)

    def test_masks_follow_the_parameter_not_its_id(self):
        import gc

        m = tp.nn.Sequential(tp.nn.Linear(8, 4))
        P.asp.prune_model(m)
        key = id(m[0].weight)
        assert key in P.asp._MASKS
        del m
        gc.collect()
        P.asp.apply_masks([])
        assert key not in P.asp._MASKS


# -- DistributedFusedLamb (tests/test_optimizers.py) ---------------------------
def _fit_problem(d=8):
    rng = np.random.RandomState(0)
    X = rng.randn(32, d).astype(np.float32)
    return X, X @ rng.randn(d, 1).astype(np.float32)


def _train(pkg, m, opt, X, Y, steps):
    losses = []
    mk = paddle.to_tensor if pkg is paddle else torch.tensor
    for _ in range(steps):
        loss = ((m(mk(X)) - mk(Y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.item()))
    return losses


class TestDistributedFusedLamb:
    def _build(self):
        paddle.seed(4)
        jm = jnn.Linear(8, 1)
        tm = tp.nn.Linear(8, 1)
        _carry(tm, jm)
        return jm, tm

    def test_matches_lamb_and_resumes(self):
        X, Y = _fit_problem()
        _, m1 = self._build()
        l1 = _train(tp, m1, tp.optimizer.Lamb(
            learning_rate=0.05, parameters=m1.parameters()), X, Y, 6)
        _, m2 = self._build()
        o2 = P.DistributedFusedLamb(learning_rate=0.05,
                                    parameters=m2.parameters(),
                                    max_global_grad_norm=0.0)
        l2 = _train(tp, m2, o2, X, Y, 6)
        np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-6)
        _, m3 = self._build()
        l3 = _train(tp, m3, P.DistributedFusedLamb(
            learning_rate=0.05, parameters=m3.parameters(),
            max_global_grad_norm=0.1), X, Y, 6)
        assert abs(l3[-1] - l2[-1]) > 1e-6  # the clip engages
        sd = o2.state_dict()
        _, m4 = self._build()
        o4 = P.DistributedFusedLamb(learning_rate=0.05,
                                    parameters=m4.parameters(),
                                    max_global_grad_norm=0.0)
        with torch.no_grad():
            for p4, p2 in zip(m4.parameters(), m2.parameters()):
                p4.copy_(p2)
        o4.set_state_dict(sd)
        a = _train(tp, m2, o2, X, Y, 2)
        b = _train(tp, m4, o4, X, Y, 2)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("clip", [0.0, 0.1])
    def test_matches_reference(self, clip):
        X, Y = _fit_problem()
        jm, tm = self._build()
        want = _train(paddle, jm, J.DistributedFusedLamb(
            learning_rate=0.05, parameters=jm.parameters(),
            max_global_grad_norm=clip), X, Y, 6)
        got = _train(tp, tm, P.DistributedFusedLamb(
            learning_rate=0.05, parameters=tm.parameters(),
            max_global_grad_norm=clip), X, Y, 6)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tm.weight.detach().numpy(),
                                   _np(jm.weight), rtol=1e-5, atol=1e-6)

    def test_state_dict_is_a_copy_and_checks_the_layout(self):
        X, Y = _fit_problem()
        _, m = self._build()
        o = P.DistributedFusedLamb(learning_rate=0.05,
                                   parameters=m.parameters())
        _train(tp, m, o, X, Y, 1)
        sd = o.state_dict()
        frozen = {k: v.clone() for k, v in sd.items() if k != "@step"}
        _train(tp, m, o, X, Y, 1)  # the live buffers move in place
        for k, v in frozen.items():
            assert torch.equal(sd[k], v), k
        o.set_state_dict(sd)
        sd["fused_moment1"].add_(1.0)  # the installed buffer is a copy
        assert not torch.equal(o._m, sd["fused_moment1"])
        bad = dict(sd, fused_moment1=torch.zeros(3))
        with pytest.raises(ValueError, match="layout changed"):
            o.set_state_dict(bad)

    def test_bf16_parameters_keep_an_f32_master(self):
        X, Y = _fit_problem()
        m = tp.nn.Linear(8, 1)
        m.bfloat16()
        o = P.DistributedFusedLamb(learning_rate=0.05,
                                   parameters=m.parameters())
        x = torch.tensor(X).bfloat16()
        ((m(x).float() - torch.tensor(Y)) ** 2).mean().backward()
        o.step()
        assert o._master.dtype == torch.float32
        assert m.weight.dtype == torch.bfloat16
        assert torch.equal(m.weight, o._master[:8].reshape(8, 1).bfloat16())


# -- LookAhead / ModelAverage (tests/test_optimizers.py) --------------------------
class TestIncubateOptimizerExtras:
    def _linear(self, d, seed):
        paddle.seed(seed)
        jm = jnn.Linear(d, 1)
        tm = tp.nn.Linear(d, 1)
        _carry(tm, jm)
        return jm, tm

    def test_lookahead_interpolates_every_k_like_the_reference(self):
        X, Y = _fit_problem(6)
        jm, tm = self._linear(6, 1)
        jla = J.LookAhead(paddle.optimizer.SGD(learning_rate=0.05,
                                               parameters=jm.parameters()),
                          alpha=0.5, k=3)
        la = P.LookAhead(tp.optimizer.SGD(0.05, parameters=tm.parameters()),
                         alpha=0.5, k=3)
        want = _train(paddle, jm, jla, X, Y, 9)
        got = _train(tp, tm, la, X, Y, 9)
        np.testing.assert_allclose(got, want, **TOL)
        assert got[-1] < got[0] and la._slow
        sd = la.state_dict()
        la2 = P.LookAhead(tp.optimizer.SGD(0.05, parameters=tm.parameters()),
                          alpha=0.5, k=3)
        la2.set_state_dict(sd)
        assert la2._step_count == la._step_count
        for k, v in la._slow.items():
            assert torch.equal(la2._slow[k], v)
        m3 = tp.nn.Linear(6, 1)
        la3 = P.LookAhead(tp.optimizer.SGD(0.05, parameters=m3.parameters()))
        with pytest.raises(ValueError, match="slow-weight keys"):
            la3.set_state_dict(sd)

    def test_lookahead_first_sync_interpolates_from_init(self):
        X, Y = _fit_problem(6)

        def run(make, steps):
            _, m = self._linear(6, 6)
            w0 = m.weight.detach().clone().numpy()
            _train(tp, m, make(m), X, Y, steps)
            return w0, m.weight.detach().numpy()

        _, w_k = run(lambda m: tp.optimizer.SGD(0.05,
                                                parameters=m.parameters()), 3)
        w0, w_sync = run(lambda m: P.LookAhead(tp.optimizer.SGD(
            0.05, parameters=m.parameters()), alpha=0.5, k=3), 3)
        np.testing.assert_allclose(w_sync, w0 + 0.5 * (w_k - w0), rtol=1e-5,
                                   atol=1e-7)
        assert np.abs(w_sync - w_k).max() > 1e-6

    def test_lookahead_slow_weights_do_not_alias_the_parameters(self):
        """The reference seeds its slow copy from an immutable array; an
        aliased tensor here would move with every in-place SGD step and
        make the first sync a no-op."""
        _, m = self._linear(6, 2)
        la = P.LookAhead(tp.optimizer.SGD(0.05, parameters=m.parameters()),
                         alpha=0.5, k=5)
        w0 = m.weight.detach().clone()
        X, Y = _fit_problem(6)
        _train(tp, m, la, X, Y, 2)
        assert torch.equal(la._slow[m.weight.name], w0)
        assert not torch.equal(m.weight.detach(), w0)

    def test_model_average_apply_restore_like_the_reference(self):
        X, Y = _fit_problem(6)
        jm, tm = self._linear(6, 2)
        res = []
        for pkg, m, mod in ((paddle, jm, J), (tp, tm, P)):
            opt = (paddle.optimizer.SGD(learning_rate=0.1,
                                        parameters=m.parameters())
                   if pkg is paddle else
                   tp.optimizer.SGD(0.1, parameters=m.parameters()))
            ma = mod.ModelAverage(0.15, parameters=m.parameters(),
                                  min_average_window=2, max_average_window=10)
            mk = paddle.to_tensor if pkg is paddle else torch.tensor
            for _ in range(6):
                ((m(mk(X)) - mk(Y)) ** 2).mean().backward()
                opt.step()
                opt.clear_grad()
                ma.step()
            w_train = _np(m.weight).copy()
            ma.apply()
            w_avg = _np(m.weight).copy()
            assert not np.allclose(w_train, w_avg)
            ma.restore()
            np.testing.assert_array_equal(_np(m.weight), w_train)
            res.append(w_avg)
        np.testing.assert_allclose(res[1], res[0], **TOL)

    def test_model_average_constant_weights_unbiased(self):
        _, m = self._linear(4, 3)
        w = m.weight.detach().clone()
        ma = P.ModelAverage(0.15, parameters=m.parameters(),
                            min_average_window=2, max_average_window=4)
        for _ in range(7):
            ma.step()
        ma.apply()
        np.testing.assert_allclose(m.weight.detach().numpy(), w.numpy(),
                                   rtol=1e-6)
        ma.restore()
        assert torch.equal(m.weight.detach(), w)

    def test_model_average_state_round_trip_and_double_apply(self):
        _, m = self._linear(4, 3)
        ma = P.ModelAverage(0.5, parameters=m.parameters(),
                            min_average_window=2, max_average_window=4)
        ma.step()
        sd = ma.state_dict()
        with torch.no_grad():
            m.weight.add_(1.0)  # the sums are copies, not the parameter
        assert torch.equal(sd[f"sum@{m.weight.name}"],
                           ma._sum[m.weight.name])
        assert not torch.equal(ma._sum[m.weight.name], m.weight.detach())
        ma2 = P.ModelAverage(0.5, parameters=m.parameters())
        ma2.set_state_dict(sd)
        assert ma2._num == 1.0
        ma.apply()
        with pytest.raises(RuntimeError, match="twice"):
            ma.apply()
        ma.restore()
        with pytest.raises(ValueError, match="match no parameter"):
            P.ModelAverage(0.5, parameters=tp.nn.Linear(4, 1).parameters()) \
                .set_state_dict(sd)
