"""Port parity of the Paddle API below the top level, name by name: the
reference Tensor's attributes that torch's tensor lacks (``stop_gradient``
first: ``x.stop_gradient = False`` must record gradients), ``autograd``'s
``backward``/``jacobian``/``hessian``/``is_grad_enabled``/``PyLayerMeta``,
the flags ``set_flags`` accepts and ``register_flag``, the state-dict and
optimizer methods (``Layer.set_dict``/``load_dict``,
``Optimizer.load_state_dict``, the sharding optimizer's), the module names
ported in the same slice (``p2p_permute`` on two gloo ranks among them),
and the same-named Tensor methods: each is called once in Paddle's style in
both packages and is either "same" or in ``ops.TORCH_METHOD_CONFLICTS``.

Inputs are made from numpy seeds and go through both packages on the CPU.
Gradients and values of the small autograd cases are exact up to float32
rounding (rtol 1e-6); the resumed GPT's losses are held to rtol 1e-4, the
tolerance of ``tests/test_torch_paddle_api_train.py``.
"""
import ast
import copy
import inspect
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu_torch.core import tensor as core_tensor
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.ops import TORCH_METHOD_CONFLICTS
from test_torch_port_complete import reference_tensor_attrs
from torch_port_util import cpu_device, port_of

HERE = Path(__file__).resolve().parent
P2P_WORKER = HERE / "torch_p2p_worker.py"
RANK_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


def _np(t):
    if isinstance(t, paddle.Tensor):
        return t.numpy()
    return t.detach().numpy()


# -- autograd: tests/test_autograd.py:11-48 and :154 over both packages ------
def _scalar_chain(pkg):
    x = pkg.to_tensor(2.0, stop_gradient=False)
    (x * x * x).backward()
    return [x.grad]


def _multi_use(pkg):
    x = pkg.to_tensor(np.array([1.0, 2.0], np.float32), stop_gradient=False)
    (x * 2 + x * 3).sum().backward()
    return [x.grad]


def _repeated(pkg):
    x = pkg.to_tensor(1.0, stop_gradient=False)
    (x * 2).backward()
    (x * 3).backward()
    return [x.grad]


def _blocks(pkg):
    x = pkg.to_tensor(1.0, stop_gradient=False)
    y = pkg.to_tensor(2.0, stop_gradient=True)
    (x * y).backward()
    assert y.grad is None and y.stop_gradient
    return [x.grad]


def _detach(pkg):
    x = pkg.to_tensor(3.0, stop_gradient=False)
    y = (x * 2).detach()
    (y * x).backward()
    return [x.grad]


def _no_grad(pkg):
    x = pkg.to_tensor(1.0, stop_gradient=False)
    with pkg.no_grad():
        y = x * 2
    assert y.stop_gradient and not x.stop_gradient
    return [np.float32(y.stop_gradient)]


def _jacobian(pkg):
    x = pkg.to_tensor(np.array([1.0, 2.0], np.float32))
    return [pkg.autograd.jacobian(lambda t: t * t, x)]


def _set_false(pkg):
    """The fault this slice repairs: Paddle's own way to ask for a
    gradient, on a tensor made without one."""
    x = pkg.to_tensor([1.0, 2.0, 3.0])
    assert x.stop_gradient
    x.stop_gradient = False
    assert not x.stop_gradient
    (x * x).sum().backward()
    return [x.grad]


def _cut_intermediate(pkg):
    x = pkg.to_tensor([1.0, 2.0])
    x.stop_gradient = False
    y = x * 2
    y.stop_gradient = True  # from here on y is a constant
    assert y.stop_gradient
    (y * x).sum().backward()
    return [x.grad]


def _false_on_intermediate(pkg):
    x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.stop_gradient = False  # it already records: nothing changes
    (y * x).sum().backward()
    return [x.grad]


AUTOGRAD_CASES = {
    "scalar_chain": (_scalar_chain, [12.0]),
    "grad_accumulation_multi_use": (_multi_use, [[5.0, 5.0]]),
    "repeated_backward_accumulates": (_repeated, [5.0]),
    "stop_gradient_blocks": (_blocks, [2.0]),
    "detach": (_detach, [6.0]),
    "no_grad_context": (_no_grad, [1.0]),
    "jacobian": (_jacobian, [np.diag([2.0, 4.0])]),
    "stop_gradient_false_records": (_set_false, [[2.0, 4.0, 6.0]]),
    "stop_gradient_true_cuts_an_intermediate": (_cut_intermediate,
                                                [[2.0, 4.0]]),
    "stop_gradient_false_on_an_intermediate": (_false_on_intermediate,
                                               [[4.0, 8.0]]),
}


@pytest.mark.parametrize("case", sorted(AUTOGRAD_CASES))
def test_autograd_case_in_both_packages(case):
    fn, want = AUTOGRAD_CASES[case]
    for pkg in (paddle, tp):
        got = fn(pkg)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = g if isinstance(g, np.floating) else _np(g)
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(pkg))


def test_stop_gradient_reads_requires_grad():
    x = tp.to_tensor([1.0, 2.0])
    assert x.stop_gradient and not x.requires_grad
    x.stop_gradient = False
    assert x.requires_grad and not x.stop_gradient and x.is_leaf
    x.stop_gradient = True
    assert not x.requires_grad
    p = tp.Parameter(torch.ones(2))  # a leaf: requires_grad negated
    assert not p.stop_gradient
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable


def test_a_cut_is_not_undone():
    """The reference reconnects a cut intermediate when ``stop_gradient``
    goes back to False (its route still names the node: x.grad = 4x); torch
    cannot re-attach a detached tensor, so the port raises instead of
    giving another gradient."""
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.stop_gradient = True
    y.stop_gradient = False
    (y * x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [4.0, 8.0])
    tx = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    ty = tx * 2
    ty.stop_gradient = True
    with pytest.raises(RuntimeError, match="cannot reconnect"):
        ty.stop_gradient = False


def test_a_view_is_not_cut_in_place():
    """The reference cuts a slice of a recording tensor (x.grad = [0, 1]);
    torch cannot detach a view in place, so the port raises and names the
    way out."""
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    v = x[0:1]
    v.stop_gradient = True
    (v * x[1:]).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 1.0])
    tx = tp.to_tensor([1.0, 2.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="detach"):
        tx[0:1].stop_gradient = True


def test_hessian_of_one_input():
    a = np.array([1.0, 2.0, -0.5], np.float32)
    want = paddle.autograd.hessian(lambda t: (t ** 3).sum(),
                                   paddle.to_tensor(a))
    got = tp.autograd.hessian(lambda t: (t ** 3).sum(), tp.to_tensor(a))
    np.testing.assert_allclose(_np(got), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(_np(got), np.diag(6 * a), rtol=1e-6)


def test_hessian_and_jacobian_of_a_pair():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal(3).astype(np.float32) for _ in range(2))

    def f(ts):
        return (ts[0] * ts[1] * ts[0]).sum()

    def g(ts):
        return ts[0] * ts[1]

    for fn, op in ((f, "hessian"), (g, "jacobian")):
        want = getattr(paddle.autograd, op)(
            fn, [paddle.to_tensor(a), paddle.to_tensor(b)])
        got = getattr(tp.autograd, op)(fn, [tp.to_tensor(a),
                                            tp.to_tensor(b)])
        assert isinstance(got, tuple) and len(got) == len(want) == 2
        for gr, wr in zip(got, want):
            if op == "hessian":
                assert isinstance(gr, tuple) and len(gr) == 2
                for gg, ww in zip(gr, wr):
                    np.testing.assert_allclose(_np(gg), ww.numpy(),
                                               rtol=1e-6)
            else:
                np.testing.assert_allclose(_np(gr), wr.numpy(), rtol=1e-6)


def test_autograd_backward_with_a_list_and_grad_tensors():
    out = []
    for pkg in (paddle, tp):
        x = pkg.to_tensor([1.0, 2.0], stop_gradient=False)
        pkg.autograd.backward([(x * x).sum(), (x * 3).sum()])
        first = _np(x.grad).copy()
        pkg.autograd.backward([x * x], [pkg.to_tensor([1.0, 10.0])])
        out.append((first, _np(x.grad)))
    (wa, wb), (ga, gb) = out
    np.testing.assert_allclose(ga, wa)
    np.testing.assert_allclose(gb, wb)
    np.testing.assert_allclose(gb, [7.0, 47.0])


def test_grad_mode_names_and_pylayer_meta():
    for pkg in (paddle, tp):
        assert pkg.autograd.is_grad_enabled()
        with pkg.autograd.no_grad():
            assert not pkg.autograd.is_grad_enabled()
        assert isinstance(pkg.autograd.PyLayer, pkg.autograd.PyLayerMeta)

        class Double(pkg.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, g):
                return g * 2

        assert isinstance(Double, pkg.autograd.PyLayerMeta)
        x = pkg.to_tensor(3.0, stop_gradient=False)
        Double.apply(x).backward()
        np.testing.assert_allclose(_np(x.grad), 2.0)


# -- the other Tensor attributes ----------------------------------------------
def test_set_value_clear_grad_and_place():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    for pkg in (paddle, tp):
        x = pkg.to_tensor(np.zeros((2, 3), np.float32), stop_gradient=False)
        x.set_value(a)
        np.testing.assert_array_equal(_np(x), a)
        x.set_value(pkg.to_tensor(a * 2))
        np.testing.assert_array_equal(_np(x), a * 2)
        assert not x.stop_gradient  # a set value keeps the flag
        with pytest.raises(ValueError, match="shape"):
            x.set_value(np.zeros((3, 2), np.float32))
        (x * x).sum().backward()
        assert x.grad is not None
        x.clear_grad()
        assert x.grad is None
        (x * x).sum().backward()
        x.clear_gradient()
        assert x.grad is None
        assert x.place.device_type == "cpu" and x.place.device_id == 0
        assert x.persistable is False
        assert x.pspec is None and x.grad_pspec is None \
            and x.opt_state_pspec is None
    t = tp.to_tensor([1.0])
    t.persistable, t.pspec = True, ("dp",)
    assert t.persistable and t.pspec == ("dp",)
    assert tp.to_tensor([1.0]).persistable is False  # a class default
    assert tp.to_tensor([1.0]).place == tp.CPUPlace()
    assert tp.Parameter(torch.ones(2)).persistable is True


def test_the_attributes_are_set_only_where_torch_lacks_them():
    assert set(core_tensor.ATTACHED) == {
        "stop_gradient", "place", "persistable", "clear_grad",
        "clear_gradient", "set_value", "pspec", "grad_pspec",
        "opt_state_pspec"}
    assert core_tensor.attach_tensor_attributes() == []  # idempotent


# -- flags and framework --------------------------------------------------------
NEW_FLAGS = {
    "FLAGS_cudnn_deterministic": True,
    "FLAGS_eager_delete_tensor_gb": 1.5,
    "FLAGS_allocator_strategy": "naive_best_fit",
    "FLAGS_fraction_of_gpu_memory_to_use": 0.5,
    "FLAGS_use_bf16_matmul": False,
    "FLAGS_jit_cache_size": 16,
    "FLAGS_log_level": 3,
    "FLAGS_lazy_verify": True,
    "FLAGS_lazy_donate": False,
    "FLAGS_lazy_async": False,
    "FLAGS_lazy_bg_compile": True,
    "FLAGS_xla_persistent_cache": False,
    "FLAGS_xla_persistent_cache_dir": "cache",
    "FLAGS_xla_persistent_cache_min_compile_secs": 2.0,
}


def _literal_default(mod, name):
    """The default a flags module's ``_FLAGS`` literal gives ``name`` (the
    environment may have changed the live value)."""
    tree = ast.parse(Path(mod.__file__).read_text())
    lit = next(n.value for n in tree.body if isinstance(n, ast.AnnAssign)
               and n.target.id == "_FLAGS")
    return next(ast.literal_eval(v) for k, v in zip(lit.keys, lit.values)
                if k.value == name)


@pytest.mark.parametrize("name", sorted(NEW_FLAGS))
def test_set_flags_accepts_the_reference_flag(name):
    value = NEW_FLAGS[name]
    assert _literal_default(jflags, name) == _literal_default(tflags, name)
    old = tflags.get_flags(name)[name]
    cudnn = torch.backends.cudnn.deterministic
    try:
        tp.set_flags({name: value})
        assert tp.get_flags([name]) == {name: value}
        if name == "FLAGS_cudnn_deterministic":
            assert torch.backends.cudnn.deterministic is True
    finally:
        tp.set_flags({name: old})
    if name == "FLAGS_cudnn_deterministic":
        assert torch.backends.cudnn.deterministic is bool(old)
        torch.backends.cudnn.deterministic = cudnn


def test_register_flag_as_the_reference():
    name = "FLAGS_api_parity_probe"
    for mod in (jflags, tflags):
        try:
            with pytest.raises(KeyError, match="register_flag"):
                mod.set_flags({name: 1})
            mod.register_flag(name, 3)
            assert mod.get_flags(name) == {name: 3}
            mod.set_flags({name: 4})
            mod.register_flag(name, 5)  # an existing flag keeps its value
            assert mod.get_flags(name) == {name: 4}
        finally:
            mod._FLAGS.pop(name, None)


def test_framework_exports_the_reference_names():
    import paddle_tpu_torch.framework as tf

    for n in ("save", "load", "set_flags", "get_flags", "Parameter",
              "in_dygraph_mode", "flags"):
        assert hasattr(paddle.framework, n) and hasattr(tf, n), n
    assert tf.save is tp.save and tf.load is tp.load
    assert tf.Parameter is tp.Parameter and tf.set_flags is tp.set_flags
    assert tf.in_dygraph_mode() is paddle.framework.in_dygraph_mode() is True


# -- set_dict/load_dict and load_state_dict: a resumed 2-layer GPT -----------
STEPS, RESUME_AT, LR, B, T = 5, 3, 3e-3, 2, 32


def _tiny(pkg_cfg):
    return pkg_cfg(vocab_size=1024, hidden_size=64, num_layers=2,
                   num_heads=4, max_position_embeddings=256,
                   hidden_dropout=0.0, attention_dropout=0.0,
                   attention_impl="exact")


def _batch(pkg):
    rng = np.random.RandomState(7)
    return [pkg.to_tensor(rng.randint(0, 1024, (B, T)).astype(np.int64))
            for _ in range(2)]


def _adamw(pkg, model):
    sched = pkg.optimizer.lr.CosineAnnealingDecay(LR, T_max=8)
    return pkg.optimizer.AdamW(learning_rate=sched,
                               parameters=model.parameters(),
                               weight_decay=0.01), sched


@pytest.fixture(scope="module")
def reference_losses():
    paddle.seed(3)
    jm = JGPT(_tiny(JGPTConfig))
    with cpu_device():
        tm = port_of(jm, attention_impl="exact").train()
    opt, sched = _adamw(paddle, jm)
    ids, labels = _batch(paddle)
    out = []
    for _ in range(STEPS):
        loss = jm.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        out.append(float(loss.numpy()))
    return tm, out


@pytest.mark.parametrize("method", ["set_dict", "load_dict"])
def test_resume_through_set_dict_and_load_state_dict(reference_losses,
                                                     method):
    """3 steps, then ``state_dict()`` of the model and the optimizer into a
    fresh model (``set_dict``/``load_dict``) and optimizer
    (``load_state_dict``); one resumed backward goes through
    ``autograd.backward([loss])`` and one clear through each parameter's
    ``clear_grad()``; the 5 losses are the reference's uninterrupted
    ones."""
    tm, want = reference_losses
    first, fresh = copy.deepcopy(tm), copy.deepcopy(tm)  # names kept
    ids, labels = _batch(tp)
    opt, sched = _adamw(tp, first)
    got = []
    for _ in range(RESUME_AT):
        loss = first.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        got.append(loss.item())
    model_sd = copy.deepcopy(first.state_dict())
    opt_sd = copy.deepcopy(opt.state_dict())
    del first, opt
    assert getattr(fresh, method)(model_sd) == ([], [])
    wte = fresh.gpt.embeddings.word_embeddings.weight
    wte.set_value(torch.zeros_like(wte))
    wte.set_value(model_sd["gpt.embeddings.word_embeddings.weight"])
    assert torch.equal(wte, model_sd["gpt.embeddings.word_embeddings.weight"])
    opt2, sched2 = _adamw(tp, fresh)
    opt2.load_state_dict(opt_sd)
    assert sched2.last_epoch == RESUME_AT
    for i in range(STEPS - RESUME_AT):
        loss = fresh.loss(ids, labels)
        if i == 0:
            tp.autograd.backward([loss])
        else:
            loss.backward()
        opt2.step()
        if i == 1:
            for p in fresh.parameters():
                p.clear_grad()
        else:
            opt2.clear_grad()
        sched2.step()
        got.append(loss.item())
    assert all(p.grad is None for p in fresh.parameters())
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_use_mp_layers_off_builds_a_plain_embedding(reference_losses):
    tm, _ = reference_losses
    paddle.seed(3)
    jm = JGPT(_tiny(lambda **k: JGPTConfig(use_mp_layers=False, **k)))
    pm = port_of(jm, attention_impl="exact", use_mp_layers=False)
    assert type(pm.gpt.embeddings.word_embeddings) is tp.nn.Embedding
    assert type(tm.gpt.embeddings.word_embeddings).__name__ == \
        "VocabParallelEmbedding"
    ids, labels = _batch(paddle)
    want = float(jm.eval().loss(ids, labels).numpy())
    ids, labels = _batch(tp)
    np.testing.assert_allclose(pm.loss(ids, labels).item(), want, rtol=1e-5)
    assert sorted(pm.state_dict()) == sorted(tm.state_dict())


# -- the sharding optimizer at world 1 ----------------------------------------
def test_sharding_optimizer_minimize_and_set_lr_at_world_one():
    """``minimize`` gives the reference's update at world 1. ``set_lr`` and
    ``set_lr_scheduler`` reach the inner optimizer, whose rate ``get_lr``
    and ``step`` read; the reference's set the wrapper's own rate, which
    neither reads (pinned)."""
    from paddle_tpu.distributed.fleet.meta_parallel.sharding import \
        ShardingOptimizerStage1 as JStage1
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import \
        ShardingOptimizerStage1

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    x = rng.standard_normal((5, 4)).astype(np.float32)
    out, opts = [], []
    for pkg, Stage1 in ((paddle, JStage1), (tp, ShardingOptimizerStage1)):
        w = pkg.Parameter(np.zeros((4, 3), np.float32))
        w.set_value(w0)
        inner = pkg.optimizer.Adam(learning_rate=0.1, parameters=[w])
        opt = Stage1(inner)
        for _ in range(2):
            opt.minimize((pkg.matmul(pkg.to_tensor(x), w) ** 2).mean())
            opt.clear_grad()
        sd = opt.state_dict()
        opt.load_state_dict(sd)
        out.append(_np(w).copy())
        opts.append((opt, inner))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-6)
    (jopt, jinner), (opt, inner) = opts
    jopt.set_lr(0.05)
    assert jopt.get_lr() == jinner.get_lr() == 0.1
    opt.set_lr(0.05)
    assert opt.get_lr() == inner.get_lr() == 0.05
    opt.set_lr_scheduler(tp.optimizer.lr.StepDecay(0.2, step_size=1))
    assert opt.get_lr() == inner.get_lr() == 0.2


# -- module names -----------------------------------------------------------
def test_bucket_key_wd_scale_and_wd_vector_match_the_reference():
    from paddle_tpu.distributed.fleet import grad_buckets as jgb
    from paddle_tpu_torch.distributed.fleet import grad_buckets as tgb

    shapes = [(64, 32), (32,), (32, 16), (16,)]
    jps = [paddle.to_tensor(np.zeros(s, np.float32)) for s in shapes]
    tps = [torch.zeros(s) for s in shapes]
    gate = {2: 1.0, 1: 0.0, 4: 1.0}  # a bias is not decayed

    def wd(p):
        return gate[len(p.shape) if len(p.shape) == 2 else 1]

    jplan = jgb.build_bucket_plan(jps, nranks=2, bucket_bytes=1 << 20,
                                  block=128, wd_of=wd)
    tplan = tgb.build_bucket_plan(tps, nranks=2, bucket_bytes=1 << 20,
                                  block=128, wd_of=wd)
    assert len(jplan.buckets) == len(tplan.buckets) >= 1
    assert tplan.signature == jplan.signature
    for jb, tb in zip(jplan.buckets, tplan.buckets):
        assert tb.key() == jb.key()
        assert tb.wd_scale == jb.wd_scale
        jv, tv = jplan.wd_vector(jb), tplan.wd_vector(tb)
        assert (jv is None) == (tv is None)
        if tv is not None:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    one = tgb.build_bucket_plan(tps[:1], nranks=1, bucket_bytes=1 << 20,
                                block=128, wd_of=wd)
    assert one.buckets[0].wd_scale == 1.0 and one.wd_vector(
        one.buckets[0]) is None


def test_sharded_weight_update_state_specs():
    from paddle_tpu.distributed.fleet.meta_optimizers.\
        hybrid_parallel_optimizer import ShardedWeightUpdate as JWus
    from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
        hybrid_parallel_optimizer import ShardedWeightUpdate

    jw = paddle.to_tensor(np.zeros((8, 4), np.float32), stop_gradient=False)
    jopt = paddle.optimizer.AdamW(learning_rate=0.1, parameters=[jw])
    want = JWus(jopt, [jw], "dp", 2).state_specs()
    tw = tp.Parameter(torch.zeros(8, 4))
    topt = tp.optimizer.AdamW(learning_rate=0.1, parameters=[tw])
    got = ShardedWeightUpdate(topt, [tw], None, 2, "dp").state_specs()
    assert got["t"] == tuple(want["t"])
    assert got["accums"] == [{k: tuple(v) for k, v in a.items()}
                             for a in want["accums"]]
    assert got["ef"] == [tuple(v) for v in want["ef"]]


def test_shard_model_params_and_engine_place():
    from paddle_tpu_torch.distributed.engine import (HybridParallelEngine,
                                                     shard_model_params)

    m = tp.nn.Linear(4, 3)
    ws = [p for p in m.parameters()]
    assert shard_model_params(m, device="cpu") is m
    assert [p for p in m.parameters()] == ws  # moved in place, if at all
    opt = tp.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    eng = HybridParallelEngine(m, opt, lambda mod, x: mod(x).sum())
    eng.place()
    eng.place()  # once
    assert all(p.device.type == "cpu" for p in m.parameters())
    assert eng._placed


def test_native_names_fleet_and_monkey_patch():
    from paddle_tpu_torch.core import native
    from paddle_tpu_torch.distributed.fleet.base import fleet_base

    assert isinstance(native.HAS_EMBED, bool)
    store = native.TCPStore("127.0.0.1", 0, True, 10)
    store.set("k", b"v")
    assert store.get("k") == b"v" and store.add("n", 2) == 2
    assert isinstance(store, native.TCPStore)
    assert fleet_base.fleet is tp.distributed.fleet
    assert fleet_base.fleet.init is fleet_base.init
    assert tp.ops.monkey_patch_tensor is tp.ops.attach_tensor_methods
    assert tp.ops.monkey_patch_tensor() == []  # idempotent
    from paddle_tpu_torch.ops import kernels

    assert kernels.int8_matmul_mod.int8_matmul is kernels.int8_matmul


def test_tensor_nan_point_poisons_the_named_op():
    from paddle_tpu_torch.fault import inject

    x = torch.ones(2, 3)
    assert inject.poison_first_nan([torch.zeros(2, dtype=torch.int64), x])
    assert torch.isnan(x[0, 0]) and not torch.isnan(x[0, 1])
    assert not inject.poison_first_nan(torch.zeros(2, dtype=torch.int64))
    inject.arm("tensor.nan:op=aten.mul.Tensor")
    tp.set_flags({"FLAGS_check_nan_inf": True})
    try:
        torch.ones(2) + 1  # another op: not poisoned
        with pytest.raises(FloatingPointError, match="aten.mul.Tensor"):
            torch.ones(2) * 2
    finally:
        tp.set_flags({"FLAGS_check_nan_inf": False})
        inject.disarm()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_p2p_permute_on_two_gloo_ranks(tmp_path):
    """The collective permute over two ranks against the reference's
    ``p2p_permute`` inside ``shard_map`` on a 2-device mesh: a ring, one
    pair (the rank no pair names receives zeros) and the identity."""
    import jax
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.distributed import collective as jc
    from paddle_tpu.distributed.mesh import shard_map_compat

    perms = {"ring": [(0, 1), (1, 0)], "pair": [(0, 1)],
             "identity": [(0, 0), (1, 1)]}
    xs = np.stack([np.full((2, 3), r + 1.0, np.float32) for r in range(2)])
    shard_map, check = shard_map_compat()
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    want = {}
    for k, perm in perms.items():
        f = shard_map(lambda a, perm=perm: jc.p2p_permute(
            paddle.Tensor(a[0]), perm, "x")._data[None], mesh=mesh,
            in_specs=JP("x"), out_specs=JP("x"), **check)
        want[k] = np.asarray(f(xs))
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PADDLE_TRAINERS_NUM="2",
                   PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINER_ENDPOINTS=f"127.0.0.1:{port}",
                   OMP_NUM_THREADS="1", PYTHONPATH=str(HERE.parent))
        procs.append(subprocess.Popen(
            [sys.executable, str(P2P_WORKER), str(tmp_path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a gloo rank did not finish in {RANK_TIMEOUT_S}s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, logs[r][-4000:]
        got = torch.load(tmp_path / f"rank{r}.pt")
        for k in perms:
            np.testing.assert_array_equal(got[k].numpy(), want[k][r],
                                          err_msg=k)
    assert not want["pair"][0].any() and (want["pair"][1] == 1).all()


def test_p2p_permute_at_world_one_is_the_identity():
    from paddle_tpu_torch.distributed import collective as C

    x = torch.arange(6.0).reshape(2, 3)
    assert C.p2p_permute(x, [(0, 0)]) is x
    assert not C.p2p_permute(x, []).any()


# -- the same-named Tensor methods --------------------------------------------
def _torch_native(name):
    """Whether ``torch.Tensor`` has ``name`` of its own (not set by the
    port)."""
    v = inspect.getattr_static(torch.Tensor, name, None)
    if v is None or name in core_tensor.ATTACHED:
        return False
    f = getattr(v, "fget", v)
    f = getattr(f, "__func__", f)
    return not (getattr(f, "__module__", None) or "").startswith(
        "paddle_tpu_torch")


REF_TENSOR = sorted(a for a in dir(paddle.Tensor) if not a.startswith("_"))
SHARED = [n for n in REF_TENSOR if _torch_native(n)]

# Paddle's call of each shared method that takes arguments (the reference
# function's required ones, in Paddle's keywords): fn(pkg, x, y, a) ->
# (args, kwargs), with ``y`` a second seeded input and ``a`` x's array
_BINARY = {
    "add", "allclose", "atan2", "bitwise_and", "bitwise_or", "bitwise_xor",
    "bitwise_left_shift", "bitwise_right_shift", "bmm", "copy_", "cross",
    "dist", "divide", "divide_", "dot", "equal", "expand_as", "float_power",
    "floor_divide", "fmax", "fmin", "fmod", "greater_equal", "heaviside",
    "inner", "isclose", "kron", "less_equal", "logaddexp", "logaddexp2",
    "logical_and", "logical_or", "logical_xor", "maximum", "minimum",
    "multiply", "multiply_", "not_equal", "outer", "pow", "pow_",
    "remainder", "remainder_", "solve", "subtract", "subtract_", "add_",
    "true_divide", "xlogy"}


def _ix(pkg, v):
    return pkg.to_tensor(np.array(v))


_CALLS = {
    "addmm": lambda t, x, y, a: ((y, t.to_tensor(np.eye(3, dtype=a.dtype))),
                                 {}),
    "broadcast_to": lambda t, x, y, a: (([2, 2, 3],), {}),
    "expand": lambda t, x, y, a: (([2, 2, 3],), {}),
    "chunk": lambda t, x, y, a: ((3,), {"axis": 1}),
    "split": lambda t, x, y, a: ((3,), {"axis": 1}),
    "clip": lambda t, x, y, a: ((-0.5, 0.5), {}),
    "clip_": lambda t, x, y, a: ((-0.5, 0.5), {}),
    "fill_": lambda t, x, y, a: ((3,), {}),
    "fill_diagonal_": lambda t, x, y, a: ((), {"value": 5.0}),
    "flip": lambda t, x, y, a: (([1],), {}),
    "gather": lambda t, x, y, a: ((_ix(t, [1, 0]),), {}),
    "hsplit": lambda t, x, y, a: ((), {"sections": 3}),
    "index_select": lambda t, x, y, a: ((_ix(t, [2, 0]),), {"axis": 1}),
    "index_add": lambda t, x, y, a: ((_ix(t, [0, 2]), 1,
                                      t.to_tensor(a[:, :2].copy())), {}),
    "index_add_": lambda t, x, y, a: ((_ix(t, [0, 2]), 1,
                                       t.to_tensor(a[:, :2].copy())), {}),
    "index_fill": lambda t, x, y, a: ((_ix(t, [1]),), {"value": 5.0}),
    "index_put": lambda t, x, y, a: ((_ix(t, [1, 0]), y), {}),
    "item": lambda t, x, y, a: ((1,), {}),
    "kthvalue": lambda t, x, y, a: ((), {"k": 2}),
    "lerp": lambda t, x, y, a: ((y, 0.25), {}),
    "lerp_": lambda t, x, y, a: ((y, 0.25), {}),
    "masked_fill": lambda t, x, y, a: ((t.to_tensor(a > 0), 7), {}),
    "masked_fill_": lambda t, x, y, a: ((t.to_tensor(a > 0), 7), {}),
    "masked_scatter": lambda t, x, y, a: ((t.to_tensor(a > 0), y), {}),
    "masked_select": lambda t, x, y, a: ((t.to_tensor(a > 0),), {}),
    "matmul": lambda t, x, y, a: ((t.to_tensor(a.T.copy()),), {}),
    "matrix_power": lambda t, x, y, a: ((2,), {}),
    "mm": lambda t, x, y, a: ((t.to_tensor(a.T.copy()),), {}),
    "moveaxis": lambda t, x, y, a: ((0, 1), {}),
    "nanquantile": lambda t, x, y, a: ((), {"q": 0.5}),
    "polygamma": lambda t, x, y, a: ((), {"n": 1}),
    "renorm": lambda t, x, y, a: ((), {"p": 2, "axis": 0, "max_norm": 1.0}),
    "renorm_": lambda t, x, y, a: ((), {"p": 2, "axis": 0, "max_norm": 1.0}),
    "repeat_interleave": lambda t, x, y, a: ((2,), {"axis": 1}),
    "reshape": lambda t, x, y, a: (([3, 2],), {}),
    "roll": lambda t, x, y, a: ((1,), {"axis": 1}),
    "scatter": lambda t, x, y, a: ((_ix(t, [1, 0]),
                                    t.to_tensor(a[::-1].copy())), {}),
    "scatter_": lambda t, x, y, a: ((_ix(t, [1, 0]),
                                     t.to_tensor(a[::-1].copy())), {}),
    "select_scatter": lambda t, x, y, a: ((t.to_tensor(a[1].copy()),), {}),
    "slice_scatter": lambda t, x, y, a: ((t.to_tensor(a[:1].copy()),), {}),
    "take": lambda t, x, y, a: ((_ix(t, [0, 4]),), {}),
    "tensor_split": lambda t, x, y, a: ((), {"sections": 3, "axis": 1}),
    "tile": lambda t, x, y, a: (([2, 1],), {}),
    "to": lambda t, x, y, a: (("float64",), {}),
    "topk": lambda t, x, y, a: ((2,), {}),
    "transpose": lambda t, x, y, a: (([1, 0],), {}),
    "unflatten": lambda t, x, y, a: ((), {"axis": 1, "sizes": [3, 1]}),
    "unfold": lambda t, x, y, a: ((), {"axis": 1, "size": 2, "step": 1}),
    "unsqueeze": lambda t, x, y, a: ((0,), {}),
    "unsqueeze_": lambda t, x, y, a: ((0,), {}),
}
# the integer ops take int64 inputs, the rest float32; the shapes other ops
# need (square matrices, a batch of them, vectors); the random refills take
# 4096 draws (from seeded generators), compared by their sign, mean and
# spread
_INT = {"bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
        "bitwise_left_shift", "bitwise_right_shift", "bincount"}
_RANDOM = {"uniform_", "normal_", "exponential_"}
_SHAPES = {"bmm": (2, 3, 3), "matrix_power": (3, 3), "cholesky": (3, 3),
           "inverse": (3, 3), "solve": (3, 3), "matrix_exp": (3, 3),
           "bincount": (6,), "dot": (3,), "outer": (3,), "dsplit": (2, 2, 4),
           **dict.fromkeys(_RANDOM, (64, 64))}
_GRAD_NAMES = {"backward", "register_hook", "grad", "grad_fn", "is_leaf"}


def _inputs(name, seed):
    rng = np.random.default_rng(seed)
    shape = _SHAPES.get(name, (2, 3))
    if name in _INT:
        a = rng.integers(-5, 6, shape).astype(np.int64)
        return np.abs(a) if name == "bincount" else a
    a = rng.standard_normal(shape).astype(np.float32)
    if name == "cholesky":
        a = (a @ a.T + 3 * np.eye(3)).astype(np.float32)
    return a


def _result(v):
    """A comparable form: arrays for tensors, lists for sequences (a
    ``torch.Size`` stays itself), Python values as they are."""
    if isinstance(v, (paddle.Tensor, torch.Tensor)):
        return ("array", _np(v))
    if isinstance(v, np.ndarray):
        return ("array", v)
    if isinstance(v, (tuple, list)) and not isinstance(v, torch.Size):
        return ("seq", [_result(e) for e in v])
    return ("value", v)


def _agree(a, b):
    """Same shape, same kind of dtype and values within 1e-5 (NaN equal);
    sequences item by item; other values by type and ``==``."""
    if a[0] != b[0]:
        return False
    if a[0] == "array":
        x, y = a[1], b[1]
        if x.shape != y.shape or x.dtype.kind != y.dtype.kind:
            return False
        if x.dtype.kind in "fc":
            return np.allclose(x, y, rtol=1e-5, atol=1e-6, equal_nan=True)
        return np.array_equal(x, y)
    if a[0] == "stats":  # 4096 draws: the mean and spread within 0.1
        return a[1][0] == b[1][0] and np.allclose(a[1], b[1], atol=0.1)
    if a[0] == "seq":
        return len(a[1]) == len(b[1]) and all(
            _agree(p, q) for p, q in zip(a[1], b[1]))
    if type(a[1]) is not type(b[1]):
        return False
    try:
        return bool(a[1] == b[1])
    except Exception:
        return False


def _paddle_call(pkg, name, method=None):
    """``x.<name>(...)`` in Paddle's style on seeded inputs, as a comparable
    result; ``method`` replaces the bound method (a function form)."""
    a, b = _inputs(name, 0), _inputs(name, 1)
    pkg.seed(0)
    if name in _GRAD_NAMES:
        x = pkg.to_tensor(a, stop_gradient=False)
        if name == "backward":
            (x * x).sum().backward()
            return _result(x.grad)
        z = x * 2
        if name == "register_hook":
            z.register_hook(lambda g: g * 3)
            z.sum().backward()
            return _result(x.grad)
        if name == "grad":
            return _result(x.grad)
        return _result(getattr(z, name) is None if name == "grad_fn"
                       else getattr(z, name))
    x, y = pkg.to_tensor(a), pkg.to_tensor(b)
    attr = getattr(x, name) if method is None else method
    if not callable(attr):
        return _result(attr)
    if name in _BINARY:
        args, kwargs = (y,), {}
    elif name in _CALLS:
        args, kwargs = _CALLS[name](pkg, x, y, a)
    else:
        args, kwargs = (), {}
    if method is not None:
        args = (x,) + args
    out = attr(*args, **kwargs)
    if name.endswith("_") and out is None:
        out = x
    if name in _RANDOM:
        v = _np(out)
        return ("stats", np.array([v.min() < 0, v.mean(), v.std()]))
    if name == "pin_memory":
        return ("value", out is x)
    return _result(out)


# a conflict's value that is one call of a port function on x (the others
# describe an attribute's counterpart)
_FORM = re.compile(r"paddle_tpu_torch\.([\w.]+)\(x(, [^()]*)?\)")


def test_the_shared_names_are_read():
    assert len(REF_TENSOR) == 346 and len(SHARED) > 200
    assert {"transpose", "split", "max", "size", "stop_gradient"} & set(
        SHARED) == {"transpose", "split", "max", "size"}
    assert set(TORCH_METHOD_CONFLICTS) <= set(SHARED)


def test_the_reference_tensor_attributes_are_read_from_its_source():
    """The completeness test reads the reference Tensor's attributes from
    the source (it imports no JAX): they are the live ones."""
    assert reference_tensor_attrs() == set(REF_TENSOR)


@pytest.mark.parametrize("name", SHARED)
def test_same_named_method_is_same_or_a_named_conflict(name):
    want = _paddle_call(paddle, name)
    try:
        agree = _agree(want, _paddle_call(tp, name))
    except Exception:
        agree = False
    conflict = name in TORCH_METHOD_CONFLICTS
    assert agree != conflict, (
        f"{name}: {'agrees with the reference' if agree else 'differs'} "
        f"but is {'' if conflict else 'not '}in TORCH_METHOD_CONFLICTS")
    form = _FORM.fullmatch(TORCH_METHOD_CONFLICTS.get(name, ""))
    if form:  # the function form gives Paddle's result
        fn = tp
        for part in form.group(1).split("."):
            fn = getattr(fn, part)
        assert _agree(want, _paddle_call(tp, name, method=fn)), name
