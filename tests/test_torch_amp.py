"""Port parity: ``paddle_tpu_torch.amp`` against the reference's
``paddle_tpu.amp``.

The same numpy inputs go through both packages under ``auto_cast``:
- each listed function the port implements gives the reference's output
  dtype under O1 and O2 for float32 and bfloat16 inputs (values within
  rtol = atol = 1e-5 for float32 outputs, 2e-2 for bfloat16);
- custom lists join for the block and are restored after it;
- a tiny GPT and a tiny ERNIE (dropout 0) with float32 parameters under O1
  bfloat16: loss within rtol 1e-2, every gradient float32 and within a
  relative norm of 2e-2 (GPT) or 5e-2 (ERNIE, see its test) of the
  reference's (bfloat16 rounding at the same cast points);
- ``decorate(level="O2")`` casts the parameters as the reference does;
- ``GradScaler``: a scripted run of finite and non-finite gradients gives
  the reference's ``state_dict`` after every step, its stepped-or-skipped
  decisions and bit-equal float32 unscaled gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import dtype as jdtypes
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.core import dispatch
from paddle_tpu_torch.core import dtype as tdtypes
from torch_port_util import port_of, port_of_ernie

RNG = np.random.RandomState(0)


def _arr(*shape, positive=False):
    a = RNG.standard_normal(shape).astype(np.float32)
    return np.abs(a) + 0.5 if positive else a


# name -> (numpy inputs, reference call, port call)
X34, Y45 = _arr(3, 4), _arr(4, 5)
LIN = (_arr(2, 3, 4), _arr(4, 5), _arr(5))
LN = (_arr(2, 4), _arr(4, positive=True), _arr(4))
CE = _arr(4, 6)
LAB = np.array([0, 3, 5, 1], np.int64)
QKV = (_arr(1, 4, 2, 8), _arr(1, 4, 2, 8), _arr(1, 4, 2, 8))
OPS = {
    "linear": (LIN, lambda p, a: JF.linear(*a), lambda a: TF.linear(*a)),
    "matmul": ((X34, Y45), lambda p, a: p.matmul(*a),
               lambda a: pt.matmul(*a)),
    "sum": ((X34,), lambda p, a: p.sum(a[0]), lambda a: pt.sum(a[0])),
    "mean": ((X34,), lambda p, a: p.mean(a[0]), lambda a: pt.mean(a[0])),
    "exp": ((X34,), lambda p, a: p.exp(a[0]), lambda a: pt.exp(a[0])),
    "log": ((np.abs(X34) + 0.5,), lambda p, a: p.log(a[0]),
            lambda a: pt.log(a[0])),
    "square": ((X34,), lambda p, a: p.square(a[0]),
               lambda a: pt.square(a[0])),
    "layer_norm": (LN, lambda p, a: JF.layer_norm(a[0], [4], a[1], a[2]),
                   lambda a: TF.layer_norm(a[0], [4], a[1], a[2])),
    "cross_entropy": ((CE,), lambda p, a: JF.cross_entropy(
        a[0], p.to_tensor(LAB)), lambda a: TF.cross_entropy(
        a[0], torch.from_numpy(LAB))),
    "scaled_dot_product_attention": (
        QKV, lambda p, a: JF.scaled_dot_product_attention(
            *a, is_causal=True, impl="exact"),
        lambda a: TF.scaled_dot_product_attention(*a, is_causal=True,
                                                  impl="exact")),
}


def _ref_in(a, dt):
    t = paddle.to_tensor(a)
    return t.astype("bfloat16") if dt == "bfloat16" else t


def _port_in(a, dt):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dt == "bfloat16" else t


@pytest.mark.parametrize("in_dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_output_dtype_matches_reference(name, level, in_dt):
    arrays, ref_fn, port_fn = OPS[name]
    jin = [_ref_in(a, in_dt) for a in arrays]
    tin = [_port_in(a, in_dt) for a in arrays]
    try:
        with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
            want = ref_fn(paddle, jin)
    except RecursionError:
        # the reference's O2 hook casts through ``cast``, an op its hook
        # casts again: a float32 input to any op off the black list
        # recurses without end. Its result is then the op's on the inputs
        # the hook would have handed it: cast to bfloat16.
        assert (level, in_dt) == ("O2", "float32")
        assert name not in paddle.amp.BLACK_LIST
        jin = [_ref_in(a, "bfloat16") for a in arrays]
        with paddle.amp.auto_cast(level=level, dtype="bfloat16"):
            want = ref_fn(paddle, jin)
    with pt.amp.auto_cast(level=level, dtype="bfloat16"):
        got = port_fn(tin)
    assert dispatch._amp_hook is None  # restored on exit
    want_dt = jdtypes.dtype_name(want.dtype)
    assert tdtypes.dtype_name(got.dtype) == want_dt
    tol = 1e-5 if want_dt == "float32" else 2e-2
    np.testing.assert_allclose(
        got.detach().float().numpy(),
        np.asarray(want.astype("float32").numpy()), rtol=tol, atol=tol)


@pytest.mark.parametrize("in_dt", ["float32", "bfloat16"])
def test_op_on_neither_list_follows_its_input_under_o1(in_dt):
    x = X34
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = JF.gelu(_ref_in(x, in_dt))
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        got = TF.gelu(_port_in(x, in_dt))
    assert tdtypes.dtype_name(got.dtype) == jdtypes.dtype_name(want.dtype) \
        == in_dt


def test_custom_lists_join_and_are_restored():
    white, black = set(pt.amp.WHITE_LIST), set(pt.amp.BLACK_LIST)
    x = torch.from_numpy(X34)
    with pt.amp.auto_cast(custom_white_list={"exp"},
                          custom_black_list={"matmul"}):
        assert "exp" in pt.amp.WHITE_LIST and "exp" not in pt.amp.BLACK_LIST
        assert pt.exp(x).dtype == torch.bfloat16
        assert pt.matmul(x.bfloat16(), torch.from_numpy(Y45).bfloat16()
                         ).dtype == torch.float32
    assert pt.amp.WHITE_LIST == white and pt.amp.BLACK_LIST == black
    assert pt.exp(x).dtype == torch.float32
    with paddle.amp.auto_cast(custom_white_list={"exp"},
                              custom_black_list={"matmul"}):
        assert jdtypes.dtype_name(paddle.exp(
            paddle.to_tensor(X34)).dtype) == "bfloat16"


def test_nested_auto_cast_restores_the_outer_state():
    x = torch.from_numpy(X34)
    with pt.amp.auto_cast(level="O1", dtype="float16"):
        with pt.amp.auto_cast(enable=False):
            assert dispatch._amp_hook is None
            assert pt.matmul(x, x.T).dtype == torch.float32
        assert pt.matmul(x, x.T).dtype == torch.float16
    assert dispatch._amp_hook is None


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads_match(jmodel, tmodel, tol):
    jgrads = {n: p.grad for n, p in jmodel.named_parameters()}
    checked = 0
    for n, p in tmodel.named_parameters():
        if p.grad is None:
            assert jgrads[n] is None, n
            continue
        assert p.grad.dtype == torch.float32, n  # f32 master gradients
        want = np.asarray(jgrads[n].numpy(), np.float32)
        assert _rel(p.grad.numpy(), want) <= tol, n
        checked += 1
    assert checked


def test_gpt_o1_bf16_loss_and_gradients_match():
    paddle.seed(5)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    tm = port_of(jm).train()
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 16)).astype(np.int64)
    labels = rng.randint(0, 1024, (2, 16)).astype(np.int64)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jl.backward()
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    tl.backward()
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-2)
    _grads_match(jm, tm, 2e-2)


def test_ernie_o1_bf16_loss_and_gradients_match():
    paddle.seed(3)
    jm = JErnie(JErnieConfig(
        vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=64, max_position_embeddings=64,
        hidden_dropout=0.0, attention_dropout=0.0))
    tm = port_of_ernie(jm)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 97, (3, 12)).astype(np.int64)
    labels = np.where(rng.rand(3, 12) < 0.3, ids, -100).astype(np.int64)
    nsp = rng.randint(0, 2, (3,)).astype(np.int64)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jl = jm.loss(*(paddle.to_tensor(a) for a in (ids, labels, nsp)))
    jl.backward()
    with pt.amp.auto_cast(level="O1", dtype="bfloat16"):
        tl = tm.loss(*(torch.from_numpy(a) for a in (ids, labels, nsp)))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-2)
    # 5e-2: the reference evaluates each eager_call as one XLA computation,
    # which keeps bf16 intermediates at float32 inside it (its own bf16
    # gradients are ~1% from its float32 ones here), while the port rounds
    # every torch op's bf16 output (~3% from its float32 ones)
    _grads_match(jm, tm, 5e-2)


def test_decorate_o2_casts_parameters_as_the_reference():
    paddle.seed(5)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    tm = port_of(jm)
    assert pt.amp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    jopt = paddle.optimizer.AdamW(1e-3, parameters=jm.parameters())
    topt = pt.optimizer.AdamW(1e-3, parameters=tm.parameters())
    jout = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tout = pt.amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    assert tout == (tm, topt) and jout == (jm, jopt)
    want = {n: jdtypes.dtype_name(p.dtype) for n, p in jm.named_parameters()}
    got = {n: tdtypes.dtype_name(p.dtype) for n, p in tm.named_parameters()}
    assert got == want and set(got.values()) == {"bfloat16"}


class _Opt:
    """What ``GradScaler`` reads of an optimizer, in either package: the
    parameter list and ``step()``, which applies p -= 0.1 * grad."""

    def __init__(self, params, sub):
        self._parameter_list = params
        self._sub = sub
        self.steps = 0

    def step(self):
        self.steps += 1
        for p in self._parameter_list:
            self._sub(p)


# each step's gradient rows (before scaling): finite, an inf, a NaN
SCRIPT = ["ok", "ok", "inf", "ok", "nan", "nan", "ok", "ok", "ok", "inf"]


def _coeffs(kind, seed):
    c = np.random.RandomState(seed).standard_normal((2, 5)).astype(np.float32)
    if kind == "inf":
        c[1, 3] = np.inf
    elif kind == "nan":
        c[0, 1] = np.nan
    return c


def test_grad_scaler_scripted_run_matches_reference():
    kw = dict(init_loss_scaling=3.0 * 2 ** 10, incr_ratio=2.0,
              decr_ratio=0.5, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    w0 = np.random.RandomState(9).standard_normal((2, 5)).astype(np.float32)
    jp = JParameter(w0.copy())
    tp = pt.Parameter(torch.from_numpy(w0.copy()))

    def jsub(p):
        p.set_value(p.numpy() - np.float32(0.1) * np.asarray(p.grad.numpy()))

    def tsub(p):
        with torch.no_grad():
            p -= 0.1 * p.grad

    jopt, topt = _Opt([jp], jsub), _Opt([tp], tsub)
    js, ts = paddle.amp.GradScaler(**kw), pt.amp.GradScaler(**kw)
    for i, kind in enumerate(SCRIPT):
        c = _coeffs(kind, i)
        jp.clear_gradient()
        tp.grad = None
        jl = js.scale(paddle.sum(jp * paddle.to_tensor(c)))
        jl.backward()
        tl = ts.scale((tp * torch.from_numpy(c)).sum())
        tl.backward()
        js.unscale_(jopt)
        ts.unscale_(topt)
        jg = np.asarray(jp.grad.numpy())
        tg = tp.grad.numpy()
        assert tp.grad.dtype == torch.float32
        np.testing.assert_array_equal(tg.view(np.int32), jg.view(np.int32))
        assert ts._found_inf == js._found_inf == (kind != "ok")
        js.step(jopt)
        ts.step(topt)
        js.update()
        ts.update()
        assert topt.steps == jopt.steps, i
        assert ts.state_dict() == js.state_dict(), i
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      np.asarray(jp.numpy()))
    assert topt.steps == SCRIPT.count("ok")


def test_grad_scaler_minimize_and_state_round_trip():
    s = pt.amp.GradScaler(init_loss_scaling=1024.0)
    p = pt.Parameter(torch.ones(3))
    opt = pt.optimizer.SGD(0.5, parameters=[p])
    s.minimize(opt, s.scale((p * 2.0).sum()))
    np.testing.assert_array_equal(p.detach().numpy(), np.zeros(3))
    t = pt.amp.GradScaler()
    t.load_state_dict(s.state_dict())
    assert t.get_scale() == 1024.0 and t.state_dict()["good_steps"] == 1
    off = pt.amp.GradScaler(enable=False)
    assert off.scale(p) is p and not off.is_enable()
