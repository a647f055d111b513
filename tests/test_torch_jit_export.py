"""``jit.to_static``/``save``/``load`` (``paddle_tpu_torch/jit``) against the
reference's (``paddle_tpu/jit/__init__.py``), on the CPU, float32.

- ``to_static`` of a layer against eager and against the reference's
  ``to_static``, outputs and gradients within 1e-5 (weights copied by name).
- ``save``/``load`` of an MLP and of the tiny GPT with a dynamic batch: the
  loaded layer at two batch sizes against the eager model (bit for bit:
  the same ATen ops) and against the reference's own save/load round trip
  (MLP 1e-5; GPT 1e-4, the tolerance of ``tests/test_torch_gpt.py``: the
  two frameworks sum in different orders through 4 layers).
- The artifact's weights: the port's ``.pdiparams`` loads in the
  reference's ``framework.io.load`` with the same keys and values, and the
  reference's in the port's; each package refuses the other's program
  (StableHLO against ``torch.export``) with an error.
- The tiny GPT at ``attention_impl="flash"``: the saved program carries one
  ``paddle_tpu_torch::flash_attention_fwd`` node a layer (the CPU
  implementation runs the plain version), its logits match the reference's
  (1e-4), and the gradients through the loaded ``.pdtrain`` program (the
  operator's registered backward) match autograd through the exact
  attention (1e-5).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import cpu_device, port_of

TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_OP = "paddle_tpu_torch.flash_attention_fwd.default"


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(6, 16), pkg.nn.Tanh(),
                             pkg.nn.Linear(16, 3))


def _pair():
    """(reference MLP, port MLP with its weights)."""
    paddle.seed(7)
    jm = _mlp(paddle)
    tm = _mlp(tp)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    return jm, tm


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_to_static_layer_matches_eager_and_reference_with_grads():
    jm, tm = _pair()
    eager = _mlp(tp)
    eager.set_state_dict(tm.state_dict())
    x = _x(4, 6)
    js = paddle.jit.to_static(jm)
    ts = tp.jit.to_static(tm)
    assert isinstance(ts.forward, tp.jit.StaticFunction)
    jout, tout, eout = (js(paddle.to_tensor(x)), ts(tp.to_tensor(x)),
                        eager(tp.to_tensor(x)))
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  eout.detach().numpy())
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), **TOL)
    for out in (jout, tout, eout):
        (out * out).sum().backward()
    for (n, p), (_, e) in zip(tm.named_parameters(),
                              eager.named_parameters()):
        np.testing.assert_array_equal(p.grad.numpy(), e.grad.numpy())
        np.testing.assert_allclose(p.grad.numpy(),
                                   dict(jm.named_parameters())[n].grad.numpy(),
                                   **TOL)


def test_enable_to_static_false_runs_the_original():
    calls = []

    def fn(x):
        calls.append(1)
        if x.sum() > 0:
            y = x + 1.0
        else:
            y = x - 1.0
        return y

    st = tp.jit.to_static(fn)
    assert st._fn is not fn  # converted
    tp.jit.enable_to_static(False)
    try:
        np.testing.assert_allclose(st(torch.ones(2)).numpy(), [2.0, 2.0])
    finally:
        tp.jit.enable_to_static(True)
    np.testing.assert_allclose(st(torch.ones(2)).numpy(), [2.0, 2.0])
    assert len(calls) == 2


def test_save_load_mlp_dynamic_batch(tmp_path):
    jm, tm = _pair()
    tspec = [tp.static.InputSpec([None, 6], "float32", "x")]
    jspec = [paddle.static.InputSpec([None, 6], "float32", "x")]
    tp.jit.save(tm, str(tmp_path / "t"), input_spec=tspec)
    paddle.jit.save(jm, str(tmp_path / "j"), input_spec=jspec)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{p}{s}" for p in "jt"
        for s in (".pdmodel", ".pdiparams", ".pdtrain", ".pdtrain.json"))
    tl = tp.jit.load(str(tmp_path / "t"), device="cpu")
    jl = paddle.jit.load(str(tmp_path / "j"))
    assert not tl.program.graph_signature.parameters  # weights beside it
    for b in (1, 5):
        x = _x(b, 6, seed=b)
        got = tl(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, tm(torch.from_numpy(x)).detach().numpy())
        want = jl(paddle.to_tensor(x))
        want = want[0] if isinstance(want, (list, tuple)) else want
        np.testing.assert_allclose(got, want.numpy(), **TOL)


def test_save_requires_input_spec(tmp_path):
    with pytest.raises(ValueError, match="input_spec"):
        tp.jit.save(_mlp(tp), str(tmp_path / "m"))


class _GradOnlyBranch(tp.nn.Layer):
    """An MLP whose forward reads a tensor's value only with grad on: the
    inference export (no grad) traces, the trainable one cannot."""

    def __init__(self, error=None):
        super().__init__()
        self.net = _mlp(tp)
        self.error = error

    def forward(self, x):
        y = self.net(x)
        if torch.is_grad_enabled():
            if self.error is not None:
                raise self.error
            if y.sum() > 0:
                y = y * 2.0
        return y


def test_save_warns_when_the_trainable_export_cannot_trace(tmp_path):
    """A forward that ``torch.export`` cannot trace with grad on: the
    inference artifact is written and loads, no ``.pdtrain``, and a warning
    names the forward."""
    m = _GradOnlyBranch()
    prefix = str(tmp_path / "m")
    with pytest.warns(UserWarning, match="_GradOnlyBranch.forward"):
        tp.jit.save(m, prefix,
                    input_spec=[tp.static.InputSpec([None, 6], "float32")])
    assert sorted(os.listdir(tmp_path)) == ["m.pdiparams", "m.pdmodel"]
    x = torch.from_numpy(_x(3, 6))
    with torch.no_grad():
        want = m(x)
    np.testing.assert_array_equal(
        tp.jit.load(prefix, device="cpu")(x).numpy(), want.numpy())


def test_save_propagates_other_trainable_export_errors(tmp_path):
    """Any other error of the trainable export (here one the forward
    raises) fails ``jit.save`` and leaves no ``.pdtrain``."""
    m = _GradOnlyBranch(error=RuntimeError("grad-mode forward failed"))
    with pytest.raises(RuntimeError, match="grad-mode forward failed"):
        tp.jit.save(m, str(tmp_path / "m"),
                    input_spec=[tp.static.InputSpec([2, 6], "float32")])
    assert not any(f.startswith("m.pdtrain") for f in os.listdir(tmp_path))


def _gpts(**config):
    paddle.seed(1)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    jm.eval()
    return jm, port_of(jm, **config)


def _ids(B, T, V, seed=3):
    return np.random.RandomState(seed).randint(0, V, (B, T)).astype(np.int64)


def test_save_load_tiny_gpt_dynamic_batch(tmp_path):
    jm, tm = _gpts()
    V = jm.config.vocab_size
    prefix = str(tmp_path / "gpt")
    tp.jit.save(tm, prefix, input_spec=[
        tp.static.InputSpec([None, 16], "int64", "input_ids")])
    layer = tp.jit.load(prefix, device="cpu")
    ep, meta = tp.jit.read_program(prefix + ".pdmodel")
    assert meta["dynamic"]
    for b in (1, 3):
        ids = _ids(b, 16, V, seed=b)
        got = layer(torch.from_numpy(ids)).numpy()
        with torch.no_grad():
            eager = tm(torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got, eager)
        ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_pdiparams_cross_readable(tmp_path):
    from paddle_tpu.framework import io as jio
    from paddle_tpu_torch.framework import io as tio

    jm, tm = _pair()
    tp.jit.save(tm, str(tmp_path / "t"), input_spec=[
        tp.static.InputSpec([2, 6], "float32", "x")])
    paddle.jit.save(jm, str(tmp_path / "j"), input_spec=[
        paddle.static.InputSpec([2, 6], "float32", "x")])
    tmeta = jio.load(str(tmp_path / "t.pdiparams"))
    jmeta = tio.load(str(tmp_path / "j.pdiparams"), device="cpu")
    assert set(tmeta["state"]) == set(tm.state_dict())
    assert set(jmeta["state"]) == set(jm.state_dict())
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(np.asarray(tmeta["state"][k].numpy()),
                                      v.numpy())
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(jmeta["state"][k].numpy(),
                                      np.asarray(v.numpy()))
    assert [tuple(s[0]) for s in tmeta["specs"]] == [(2, 6)]
    assert [s[1:] for s in tmeta["specs"]] == [("float32", "x")]
    assert [list(s) for s in jmeta["specs"]] == [[[2, 6], "float32", "x"]]


def test_each_package_refuses_the_others_program(tmp_path):
    jm, tm = _pair()
    tp.jit.save(tm, str(tmp_path / "t"), input_spec=[
        tp.static.InputSpec([2, 6], "float32")])
    paddle.jit.save(jm, str(tmp_path / "j"), input_spec=[
        paddle.static.InputSpec([2, 6], "float32")])
    with pytest.raises(ValueError, match="StableHLO"):
        tp.jit.load(str(tmp_path / "j"), device="cpu")
    with pytest.raises(ValueError, match="StableHLO"):
        tp.inference.create_predictor(_cpu_config(str(tmp_path / "j")))
    with pytest.raises(Exception):
        paddle.jit.load(str(tmp_path / "t"))


def _cpu_config(prefix):
    cfg = tp.inference.Config(prefix)
    cfg.disable_gpu()
    return cfg


def test_flash_gpt_export_carries_the_operator(tmp_path):
    jm, tm = _gpts(attention_impl="flash")
    L, V = jm.config.num_layers, jm.config.vocab_size
    prefix = str(tmp_path / "gpt")
    tp.jit.save(tm, prefix, input_spec=[
        tp.static.InputSpec([None, 32], "int64", "input_ids")])
    for suffix in (".pdmodel", ".pdtrain"):
        ep, _ = tp.jit.read_program(prefix + suffix)
        nodes = [n for n in ep.graph.nodes if str(n.target) == FLASH_OP]
        assert len(nodes) == L
    layer = tp.jit.load(prefix, device="cpu")
    ids = _ids(2, 32, V)
    got = layer(torch.from_numpy(ids)).numpy()
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_flash_gpt_program_gradients_match_the_plain_attention(tmp_path):
    _, flash = _gpts(attention_impl="flash")
    jm, exact = _gpts(attention_impl="exact")
    V = jm.config.vocab_size
    prefix = str(tmp_path / "gpt")
    tp.jit.save(flash, prefix, input_spec=[
        tp.static.InputSpec([None, 32], "int64", "input_ids")])
    prog = tp.static.load_program(prefix, device="cpu")
    ids = torch.from_numpy(_ids(2, 32, V, seed=5))
    labels = torch.from_numpy(_ids(2, 32, V, seed=6))

    def loss_fn(outs, y):
        return tp.nn.functional.cross_entropy(
            outs[0].reshape(-1, V), y.reshape(-1))

    prog.append_backward(loss_fn)
    loss, grads = prog.gradients([ids], [labels])
    want = loss_fn([exact(ids)], labels)
    want.backward()
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    named = dict(exact.named_parameters())
    assert set(grads) == set(named)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), named[n].grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=n)
