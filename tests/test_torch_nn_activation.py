"""``paddle_tpu_torch.nn.functional``'s activations and ``nn``'s activation
layers against the JAX package's, on the same numpy inputs from a seed:
outputs and the gradients of a weighted sum of them (the reference's tape).

Tolerances: f32 rtol 1e-5, atol 1e-6. The random ones (``gumbel_softmax``,
``rrelu`` in training) cannot match JAX's bits: they are held by shape,
range and moments. ``relu_``, ``elu_`` and ``softmax_`` write in place and
refuse a tensor that records gradients, as the reference's do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, check, check_layer, function_of
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
X = (_R.randn(3, 4, 5) * 2).astype(np.float32)
IMG = _R.randn(2, 6, 3, 3).astype(np.float32)

FUNCTIONS = {
    "relu": ((A(X),), {}), "relu6": ((A(X * 4),), {}),
    "sigmoid": ((A(X),), {}), "tanh": ((A(X),), {}),
    "silu": ((A(X),), {}), "swish": ((A(X),), {}), "mish": ((A(X),), {}),
    "tanhshrink": ((A(X),), {}), "softsign": ((A(X),), {}),
    "log_sigmoid": ((A(X),), {}), "gelu": ((A(X),), {}),
    "gelu_tanh": ((A(X),), {"approximate": True}),
    "leaky_relu": ((A(X),), {"negative_slope": 0.2}),
    "prelu": ((A(IMG), A(_R.rand(6).astype(np.float32))), {}),
    "prelu_nhwc": ((A(IMG), A(_R.rand(3).astype(np.float32))),
                   {"data_format": "NHWC"}),
    "prelu_one": ((A(X), A(np.array([0.3], np.float32))), {}),
    "elu": ((A(X),), {"alpha": 0.7}), "celu": ((A(X),), {"alpha": 1.3}),
    "selu": ((A(X),), {}),
    "hardshrink": ((A(X),), {"threshold": 0.8}),
    "softshrink": ((A(X),), {"threshold": 0.8}),
    "hardtanh": ((A(X),), {"min": -0.5, "max": 1.5}),
    "hardsigmoid": ((A(X),), {}), "hardswish": ((A(X),), {}),
    "softplus": ((A(X * 8),), {"beta": 2.0, "threshold": 10.0}),
    "softmax": ((A(X),), {"axis": 1}),
    "softmax_f64": ((A(X),), {"dtype": "float64"}),
    "log_softmax": ((A(X),), {"axis": 0}),
    "maxout": ((A(IMG),), {"groups": 3, "axis": 1}),
    "glu": ((A(IMG),), {"axis": 1}),
    "thresholded_relu": ((A(X),), {"threshold": 0.5}),
    "rrelu_eval": ((A(X),), {"lower": 0.1, "upper": 0.4}),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function(case):
    name = function_of(case, JF)
    args, kw = FUNCTIONS[case]
    check(getattr(JF, name), getattr(TF, name), args, kw, what=case)


LAYERS = {
    "ReLU": ((), X), "ReLU6": ((), X * 4), "GELU": ((True,), X),
    "Sigmoid": ((), X), "Tanh": ((), X), "Softmax": ((1,), X),
    "LogSoftmax": ((0,), X), "LeakyReLU": ((0.3,), X),
    "PReLU": ((6, 0.1), IMG), "ELU": ((0.5,), X), "CELU": ((2.0,), X),
    "SELU": ((), X), "Silu": ((), X), "Swish": ((), X), "Mish": ((), X),
    "Hardshrink": ((0.3,), X), "Softshrink": ((0.3,), X),
    "Hardtanh": ((-2.0, 0.5), X), "Hardsigmoid": ((), X),
    "Hardswish": ((), X), "Softplus": ((1.5, 5.0), X), "Softsign": ((), X),
    "Tanhshrink": ((), X), "LogSigmoid": ((), X),
    "Maxout": ((2,), IMG), "ThresholdedReLU": ((0.4,), X),
    "RReLU": ((0.2, 0.3), X), "GLU": ((-1,), IMG[..., :2]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    args, x = LAYERS[name]
    jl = getattr(jnn, name)(*args)
    tl = getattr(tnn, name)(*args, device="cpu")
    if name == "RReLU":  # eval: the mean slope
        jl.eval()
        tl.eval()
    check_layer(jl, tl, (A(x),), what=name)


def test_prelu_weight_is_the_references():
    tl = tnn.PReLU(4, 0.3, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == ["weight"]
    np.testing.assert_allclose(tl.weight.detach().numpy(), [0.3] * 4)


def test_rrelu_draws_slopes_in_training():
    x = -torch.ones(200, 200)
    g = tnn.RReLU(0.1, 0.3, device="cpu")
    y = g(x)
    s = -y
    assert float(s.min()) >= 0.1 and float(s.max()) <= 0.3
    assert abs(float(s.mean()) - 0.2) < 3e-3
    assert abs(float(s.var()) - 0.2 ** 2 / 12) < 2e-4
    g.eval()
    np.testing.assert_allclose(g(x).numpy(), -0.2, rtol=1e-6)


def test_gumbel_softmax_moments():
    torch.manual_seed(0)
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.7]])).expand(20000, 3)
    y = TF.gumbel_softmax(logits, temperature=0.5, hard=True)
    assert y.shape == (20000, 3)
    assert torch.all(y.sum(-1) == 1) and torch.all((y == 0) | (y == 1))
    np.testing.assert_allclose(y.mean(0).numpy(), [0.1, 0.2, 0.7], atol=0.015)
    soft = TF.gumbel_softmax(logits[:5], temperature=2.0)
    np.testing.assert_allclose(soft.sum(-1).numpy(), 1.0, rtol=1e-6)
    assert float(soft.min()) > 0


def test_random_activations_use_the_port_generator():
    from paddle_tpu_torch.core import random as random_state

    x = torch.randn(8, 8)
    random_state.seed(3)
    a = TF.gumbel_softmax(x)
    b = TF.rrelu(-x.abs(), training=True)
    random_state.seed(3)
    torch.manual_seed(99)  # torch's global stream plays no part
    np.testing.assert_array_equal(TF.gumbel_softmax(x).numpy(), a.numpy())
    np.testing.assert_array_equal(TF.rrelu(-x.abs(), training=True).numpy(),
                                  b.numpy())


@pytest.mark.parametrize("name", ["relu_", "elu_", "softmax_"])
def test_inplace(name):
    jx = paddle.to_tensor(X)
    tx = torch.tensor(X)
    jy = getattr(JF, name)(jx)
    ty = getattr(TF, name)(tx)
    assert ty is tx
    np.testing.assert_allclose(tx.numpy(), np.asarray(jy.numpy()), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(RuntimeError, match="requires grad"):
        getattr(TF, name)(torch.tensor(X, requires_grad=True))


def test_layers_take_device_dtype_and_generator():
    g = torch.Generator().manual_seed(0)
    for name in LAYERS:
        args = LAYERS[name][0]
        getattr(tnn, name)(*args, device="cpu", dtype="float32", generator=g)
