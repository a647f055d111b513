"""``paddle_tpu_torch.nn``'s recurrent layers against the JAX package's, with
the reference's weights carried across by name: the cells, ``RNN`` and
``BiRNN`` over a cell, and ``SimpleRNN``/``LSTM``/``GRU`` (two layers, both
directions, time-major, given initial states) over 8 steps: outputs, final
states, and the input, state and weight gradients of a weighted sum of
them. Then a 2-layer LSTM language model (embedding, LSTM, head, cross
entropy) trained one SGD step in both packages.

Tolerances: rtol 1e-4, atol 1e-5 (the recurrence's 8 steps).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
import paddle_tpu_torch.optimizer as topt
from torch_nn_util import A, carry, check_layer, layer_grads
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(6)
B, T, I, H = 3, 8, 5, 4
X = _R.randn(B, T, I).astype(np.float32)
XT = _R.randn(B, I).astype(np.float32)
H0 = _R.randn(B, H).astype(np.float32)
C0 = _R.randn(B, H).astype(np.float32)

CELLS = {
    "SimpleRNNCell": (lambda m, **kw: m.SimpleRNNCell(I, H, **kw), (H0,)),
    "SimpleRNNCell_relu": (lambda m, **kw: m.SimpleRNNCell(
        I, H, activation="relu", **kw), (H0,)),
    "LSTMCell": (lambda m, **kw: m.LSTMCell(I, H, **kw), ((H0, C0),)),
    "GRUCell": (lambda m, **kw: m.GRUCell(I, H, **kw), (H0,)),
}


def _states(s):
    if isinstance(s, tuple):
        return tuple(_states(x) for x in s)
    return A(s)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("given", [True, False])
def test_cell(name, given):
    build, states = CELLS[name]
    jl, tl = build(jnn), build(tnn, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    args = (A(XT),) + (_states(states) if given else ())
    check_layer(jl, tl, args, rtol=1e-4, atol=1e-5, what=name)


@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell", "SimpleRNNCell"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("time_major", [False, True])
def test_rnn_over_a_cell(cell, reverse, time_major):
    build = CELLS[cell][0]
    jl = jnn.RNN(build(jnn), is_reverse=reverse, time_major=time_major)
    tl = tnn.RNN(build(tnn, device="cpu"), is_reverse=reverse,
                 time_major=time_major)
    x = X.transpose(1, 0, 2).copy() if time_major else X
    check_layer(jl, tl, (A(x),), rtol=1e-4, atol=1e-5)


def test_birnn():
    jl = jnn.BiRNN(jnn.LSTMCell(I, H), jnn.LSTMCell(I, H))
    tl = tnn.BiRNN(tnn.LSTMCell(I, H, device="cpu"),
                   tnn.LSTMCell(I, H, device="cpu"))
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    check_layer(jl, tl, (A(X),), rtol=1e-4, atol=1e-5)


NETS = {
    "SimpleRNN": dict(mode="SimpleRNN"),
    "LSTM": dict(mode="LSTM"),
    "GRU": dict(mode="GRU"),
    "LSTM_2_bidirect": dict(mode="LSTM", num_layers=2, direction="bidirect"),
    "GRU_2_bidirect_time_major": dict(mode="GRU", num_layers=2,
                                      direction="bidirectional",
                                      time_major=True),
    "SimpleRNN_3": dict(mode="SimpleRNN", num_layers=3),
    "LSTM_2_states": dict(mode="LSTM", num_layers=2, states=True),
    "GRU_bidirect_states": dict(mode="GRU", direction="bidirect",
                                states=True),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_network(name):
    kw = dict(NETS[name])
    mode, states = kw.pop("mode"), kw.pop("states", False)
    jl = getattr(jnn, mode)(I, H, **kw)
    tl = getattr(tnn, mode)(I, H, device="cpu", **kw)
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    x = X.transpose(1, 0, 2).copy() if kw.get("time_major") else X
    args = (A(x),)
    if states:
        n = kw.get("num_layers", 1) * (2 if "direction" in kw else 1)
        h = _R.randn(n, B, H).astype(np.float32)
        args += ((A(h), A(h * 0.5)) if mode == "LSTM" else A(h),)
    check_layer(jl, tl, args, rtol=1e-4, atol=1e-5, what=name)


class _LM:
    """Embedding, a 2-layer LSTM and a head: the mean cross entropy of the
    next token."""

    def __init__(self, m, **kw):
        self.emb = m.Embedding(11, 6, **kw)
        self.rnn = m.LSTM(6, 7, num_layers=2, **kw)
        self.head = m.Linear(7, 11, **kw)

    def params(self):
        return [p for layer in (self.emb, self.rnn, self.head)
                for p in layer.parameters()]

    def loss(self, F, ids, labels):
        y, _ = self.rnn(self.emb(ids))
        return F.cross_entropy(self.head(y).reshape([-1, 11]),
                               labels.reshape([-1]))


def test_lstm_language_model_one_sgd_step():
    ids = _R.randint(0, 11, (2, 8)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    jm, tm = _LM(jnn), _LM(tnn, device="cpu")
    for j, t in ((jm.emb, tm.emb), (jm.rnn, tm.rnn), (jm.head, tm.head)):
        carry(j, t)
    jo = paddle.optimizer.SGD(learning_rate=0.5, parameters=jm.params())
    to = topt.SGD(learning_rate=0.5, parameters=tm.params())
    losses = []
    for _ in range(2):
        jl = jm.loss(JF, paddle.to_tensor(ids), paddle.to_tensor(labels))
        tl = tm.loss(TF, torch.tensor(ids), torch.tensor(labels))
        jl.backward()
        tl.backward()
        layer_grads(jm.rnn, tm.rnn, rtol=1e-4, atol=1e-5)
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()
        losses.append((float(tl), float(jl.numpy())))
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert losses[1][0] < losses[0][0]
