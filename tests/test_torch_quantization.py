"""``paddle_tpu_torch.quantization`` (QAT and PTQ) against the reference's
``paddle_tpu.quantization`` on the CPU, float32.

Inputs are numpy from a seed; weights are copied by name. The primitives
(the fake quant, its STE gradient, ``quantize_to_int8``, PTQ's scales and
int8 grid) are held bit for bit: the port takes the reference's compiled
``/ 127`` as XLA does, a multiply by the constant's reciprocal. A
``QuantedLayer`` fed the same input is held at 1e-6.

A whole quantized model is not held that tightly, and the tests say so:
fake quantization is a step function, so a value that one package's
matmul rounds one ulp across a grid boundary moves a whole level (scale /
127) there, and the next layer's inputs differ by more than rounding. On
``gpt_tiny`` the first layers agree exactly and flips appear from the
second block on (the level-flip test below pins this); the losses of the
compiled and eager QAT steps are held at 2e-2 and the moving averages at
2e-2, measured 1.2e-2 and 1.4e-2 at most.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as tp
from paddle_tpu import quantization as JQ
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import cpu_device, port_of, public_names

MP = ["ColumnParallelLinear", "RowParallelLinear"]


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.numpy())


def _carry(tlayer, jlayer):
    """The reference's state by name (``_data``: its ``numpy()`` gives a
    0-d buffer shape [1], Paddle's scalar convention)."""
    load_reference_state_dict(tlayer, {k: np.array(v._data) for k, v in
                                       jlayer.state_dict().items()})


def test_every_public_name_has_its_counterpart():
    import os

    names = public_names(os.path.join(os.path.dirname(paddle.__file__),
                                      "quantization/__init__.py"))
    assert not sorted(n for n in names if not hasattr(Q, n))
    assert tp.quantization is Q


# -- primitives ------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_fake_quant_and_ste_match_reference(seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(257) * rng.rand() * 10).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = JQ.fake_quantize_dequantize_abs_max(jx)
    (jy * jy).sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    ty = Q.fake_quantize_dequantize_abs_max(tx)
    (ty * ty).sum().backward()
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))


def test_fake_quant_ste_grad():
    """tests/test_components.py's case: the int8 grid of max|x| and a
    straight-through gradient."""
    x = torch.tensor([0.5, -0.25, 0.9], requires_grad=True)
    y = Q.fake_quantize_dequantize_abs_max(x)
    xv = x.detach().numpy()
    np.testing.assert_allclose(_np(y), np.round(xv / 0.9 * 127) * 0.9 / 127,
                               rtol=1e-5)
    y.sum().backward()
    np.testing.assert_allclose(_np(x.grad), np.ones(3), rtol=1e-6)


def test_ste_masks_values_outside_the_scale():
    x = torch.tensor([0.5, -3.0, 2.0, 1.0], requires_grad=True)
    y = Q._FakeQuantSTE.apply(x, torch.tensor(1.0))
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 0.0, 0.0, 1.0]
    assert y.detach().tolist()[1:3] == [-1.0, 1.0]  # clipped


@pytest.mark.parametrize("shape", [(5,), (33, 7), (2, 3, 4)])
def test_quantize_to_int8_matches_reference(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jq, js = JQ.quantize_to_int8(paddle.to_tensor(x))
    tq, ts = Q.quantize_to_int8(torch.tensor(x))
    assert tq.dtype == torch.int8 and js == ts
    np.testing.assert_array_equal(_np(tq), _np(jq))


# -- QAT ---------------------------------------------------------------------
def _seq(pkg, seed=0):
    paddle.seed(seed)
    return pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                             pkg.nn.Linear(16, 4))


def test_qat_wraps_and_trains_like_the_reference():
    jm, tm = _seq(paddle), _seq(tp)
    _carry(tm, jm)
    JQ.ImperativeQuantAware().quantize(jm)
    Q.ImperativeQuantAware().quantize(tm)
    assert isinstance(tm[0], Q.QuantedLayer) and isinstance(tm[2],
                                                            Q.QuantedLayer)
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    assert tm[0].act_quantizer.scale.dtype == torch.float64
    rng = np.random.RandomState(0)
    x, y = rng.rand(16, 8).astype(np.float32), rng.rand(16, 4).astype(
        np.float32)
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jm.parameters())
    topt = tp.optimizer.SGD(0.1, parameters=tm.parameters())
    jl, tl = [], []
    for _ in range(12):
        loss = ((jm(paddle.to_tensor(x)) - paddle.to_tensor(y)) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = ((tm(torch.tensor(x)) - torch.tensor(y)) ** 2).mean()
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
    assert tl[-1] < tl[0] * 0.8, tl
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(_np(tm.state_dict()[k]), _np(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("eager_steps", [1, 3])
def test_quanted_layer_matches_reference(eager_steps):
    """One Linear under QAT fed the same input: outputs, input and weight
    gradients, and the moving average (the reference's float64 host
    arithmetic) after each eager step."""
    paddle.seed(5)
    jl = JQ.QuantedLayer(jnn.Linear(12, 6))
    tl = Q.QuantedLayer(tp.nn.Linear(12, 6))
    _carry(tl, jl)
    rng = np.random.RandomState(6)
    for _ in range(eager_steps):
        x = (rng.randn(5, 12) * 2).astype(np.float32)
        jx = paddle.to_tensor(x, stop_gradient=False)
        jy = jl(jx)
        (jy * jy).sum().backward()
        tx = torch.tensor(x, requires_grad=True)
        ty = tl(tx)
        (ty * ty).sum().backward()
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), rtol=1e-6,
                                   atol=1e-6)
        assert float(tl.act_quantizer.scale) == float(
            np.asarray(jl.act_quantizer.scale.numpy()))
    np.testing.assert_allclose(_np(tl.inner.weight.grad),
                               _np(jl.inner.weight.grad), rtol=1e-6,
                               atol=1e-6)


def test_input_gradient_is_taken_against_the_quantized_weight():
    """The backward must see the weight the forward used: g @ wq^T, not
    g @ w^T (a ``.data`` swap would leave autograd the float weight)."""
    lin = tp.nn.Linear(8, 3)
    ql = Q.QuantedLayer(lin)
    x = torch.randn(4, 8, requires_grad=True)
    y = ql(x)
    g = torch.randn_like(y)
    y.backward(g)
    wq = Q.fake_quantize_dequantize_abs_max(lin.weight.detach())
    mask = (x.detach().abs() <= ql.act_quantizer.scale.float()).float()
    torch.testing.assert_close(x.grad, (g @ wq.t()) * mask)
    assert not torch.allclose(x.grad, (g @ lin.weight.detach().t()) * mask)
    xq = Q.fake_quantize_dequantize_abs_max(x.detach())
    torch.testing.assert_close(lin.weight.grad, xq.t() @ g)


def test_compiled_step_takes_the_per_batch_branch():
    """Inside ``compile_train_step`` the moving average stays untouched
    (the reference's traced branch); the eager loop moves it."""
    jm, tm = _seq(paddle, 2), _seq(tp, 2)
    _carry(tm, jm)
    JQ.ImperativeQuantAware().quantize(jm)
    Q.ImperativeQuantAware().quantize(tm)
    rng = np.random.RandomState(3)
    x, y = rng.rand(16, 8).astype(np.float32), rng.rand(16, 4).astype(
        np.float32)
    loss_fn = lambda m, a, b: ((m(a) - b) ** 2).mean()  # noqa: E731
    jstep = paddle.jit.compile_train_step(
        jm, loss_fn, paddle.optimizer.SGD(learning_rate=0.1,
                                          parameters=jm.parameters()))
    tstep = tp.jit.compile_train_step(
        tm, loss_fn, tp.optimizer.SGD(0.1, parameters=tm.parameters()))
    want = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
            for _ in range(3)]
    got = [tstep(torch.tensor(x), torch.tensor(y)).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not tp.jit.in_compiled_step()
    for q in (tm[0].act_quantizer, tm[2].act_quantizer):
        assert float(q.scale) == 1.0 and not q._initialized
    for k, v in jm.state_dict().items():
        np.testing.assert_allclose(_np(tm.state_dict()[k]), _np(v),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def _gpt_pair():
    kw = dict(attention_impl="flash", fused_lm_loss=True)
    paddle.seed(1)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, **kw))
    tm = port_of(jm, **kw).train()
    JQ.ImperativeQuantAware(quantizable_layer_type=MP).quantize(jm)
    Q.ImperativeQuantAware(quantizable_layer_type=MP).quantize(tm)
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    labels = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    return jm, tm, ids, labels


def test_gpt_tiny_qat_over_the_mp_linears_matches_reference():
    """3 steps through ``compile_train_step`` (the per-batch branch), then
    2 eager steps (the moving averages), AdamW, on the flash attention
    (the reference in interpret mode, the port's plain version)."""
    jm, tm, ids, labels = _gpt_pair()
    assert sum(isinstance(m, Q.QuantedLayer) for m in tm.modules()) == 16
    assert sorted(tm.state_dict()) == sorted(jm.state_dict())
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    topt = tp.optimizer.AdamW(1e-3, parameters=tm.named_parameters())
    jstep = paddle.jit.compile_train_step(jm, lambda m, i, l: m.loss(i, l),
                                          jopt)
    tstep = tp.jit.compile_train_step(tm, lambda m, i, l: m.loss(i, l),
                                      topt)
    want = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
                  .numpy()) for _ in range(3)]
    got = [tstep(ids, labels).item() for _ in range(3)]
    for _ in range(2):
        loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        want.append(float(loss.numpy()))
        loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        topt.step()
        topt.clear_grad()
        got.append(loss.item())
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert got[-1] < got[0]
    scales = {k: v for k, v in tm.state_dict().items()
              if k.endswith("act_quantizer.scale")}
    assert len(scales) == 16
    for k, v in scales.items():
        assert v.dtype == torch.float64 and float(v) != 1.0
        np.testing.assert_allclose(float(v), float(_np(jm.state_dict()[k])),
                                   rtol=2e-2, err_msg=k)


def test_gpt_tiny_level_flips_start_after_exact_layers():
    """Step 0 in train mode (each quantizer's first moving average is the
    batch's abs-max): the first block's quantizers see the same levels in
    both packages; later ones differ by at most one level, in a small
    share of their elements."""
    jm, tm, ids, labels = _gpt_pair()
    jlev, tlev = {}, {}

    def hook(store, tag):
        def h(layer, inputs, out):
            x, s = _np(inputs[0]), float(_np(layer.scale))
            store[tag] = np.clip(np.round(x / np.float32(s) * 127), -127, 127)
        return h

    for pkg_model, store in ((jm, jlev), (tm, tlev)):
        for n, m in pkg_model.named_sublayers():
            if type(m).__name__ == "FakeQuantMovingAverageAbsMax":
                m.register_forward_post_hook(hook(store, n))
    jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    assert jlev.keys() == tlev.keys() and len(jlev) == 16
    for n in jlev:
        diff = np.abs(jlev[n] - tlev[n])
        if n.startswith("gpt.layers.0."):
            assert diff.max() == 0, n
        assert diff.max() <= 1 and (diff > 0).mean() < 0.05, n


# -- PTQ ---------------------------------------------------------------------
@pytest.mark.parametrize("algo", ["abs_max", "avg"])
def test_ptq_calibrates_and_quantizes_like_the_reference(algo):
    paddle.seed(1)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.Tanh(), jnn.Linear(8, 2))
    tm = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.Tanh(),
                          tp.nn.Linear(8, 2))
    _carry(tm, jm)
    rng = np.random.RandomState(1)
    data = [rng.rand(4, 4).astype(np.float32) for _ in range(4)]
    w_before = _np(tm[0].weight).copy()
    jp = JQ.PostTrainingQuantization(
        jm, data_loader=[(paddle.to_tensor(d),) for d in data],
        batch_nums=4, algo=algo)
    jp.quantize()
    tpq = Q.PostTrainingQuantization(
        tm, data_loader=[(torch.tensor(d),) for d in data], batch_nums=4,
        algo=algo)
    tpq.quantize()
    assert tpq.act_scales and tpq.weight_scales
    # the activations' scales read each package's matmul (1 ulp apart);
    # the weights' are the same numbers
    for mine, ref in ((tpq.act_scales, jp.act_scales),
                      (tpq.in_scales, jp.in_scales)):
        assert mine.keys() == ref.keys()
        for k in ref:
            np.testing.assert_allclose(mine[k], ref[k], rtol=1e-6)
    assert tpq.weight_scales == jp.weight_scales
    w_after = _np(tm[0].weight)
    assert len(np.unique(w_after)) <= 255
    assert np.abs(w_after - w_before).max() < np.abs(w_before).max() / 32
    for k, v in jm.state_dict().items():
        np.testing.assert_array_equal(_np(tm.state_dict()[k]), _np(v),
                                      err_msg=k)


def test_ptq_stops_at_batch_nums_and_removes_its_hooks():
    m = tp.nn.Sequential(tp.nn.Linear(4, 3))
    seen = []
    loader = [(torch.full((2, 4), float(i)),) for i in range(6)]
    m.register_forward_pre_hook(lambda layer, inp: seen.append(1))
    Q.PostTrainingQuantization(m, data_loader=loader, batch_nums=2).quantize()
    assert len(seen) == 2
    assert not m[0]._forward_hooks
