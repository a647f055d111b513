"""Port parity of the Paddle-API core (``paddle_tpu_torch.core``: dtypes,
places, ``Tensor``/``Parameter``/``to_tensor``, grad mode;
``paddle_tpu_torch.autograd``: ``grad``, ``PyLayer``) against the JAX
package on the same inputs, made with numpy from a seed.

Gradients are f32 and held to rtol 1e-5. Every test runs under
``set_device("cpu")`` (the ``cpu`` fixture), put back after it.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.core import dtype as jdtype
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core import place as tplace
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


DTYPES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
          "bfloat16", "float32", "float64", "complex64", "complex128"]


@pytest.mark.parametrize("name", DTYPES)
def test_dtype_names_match_reference(name):
    t = tdtype.convert_dtype(name)
    assert isinstance(t, torch.dtype)
    assert tdtype.convert_dtype(f"paddle.{name}") is t
    assert getattr(tp, name) is t
    assert tdtype.dtype_name(t) == jdtype.dtype_name(name) == name
    for pred in ("is_floating_point", "is_integer", "is_complex"):
        assert getattr(tdtype, pred)(t) == getattr(jdtype, pred)(name), pred
    if name != "bfloat16":  # numpy has no bfloat16
        assert tdtype.convert_dtype(np.dtype(name)) is t


API_NAMES = [
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
    "float32", "float64", "complex64", "complex128", "set_default_dtype",
    "get_default_dtype", "Tensor", "Parameter", "to_tensor", "Place",
    "CPUPlace", "CUDAPlace", "TPUPlace", "set_device", "get_device",
    "is_compiled_with_cuda", "no_grad", "enable_grad", "set_grad_enabled",
    "grad_enabled", "is_grad_enabled", "grad", "seed", "ParamAttr",
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "tril", "triu", "eye", "assign", "clone", "rand",
    "randn", "randint", "uniform", "normal", "add", "subtract", "multiply",
    "divide", "matmul", "sum", "mean", "max", "min", "prod", "exp", "log",
    "sqrt", "rsqrt", "tanh", "sigmoid", "square", "pow", "abs", "cast",
    "scale", "clip", "argmax", "argmin", "cumsum", "equal", "not_equal",
    "greater_than", "greater_equal", "less_than", "less_equal", "allclose",
    "maximum", "minimum", "reshape", "transpose", "concat", "stack", "split",
    "chunk", "unbind", "squeeze", "unsqueeze", "flatten", "expand",
    "broadcast_to", "tile", "gather", "gather_nd", "index_select",
    "take_along_axis", "where", "masked_fill", "topk", "sort", "argsort",
    "repeat_interleave", "slice", "autograd", "nn", "optimizer", "jit",
    "utils"]


@pytest.mark.parametrize("name", API_NAMES)
def test_top_level_name_is_the_references(name):
    """``import paddle_tpu_torch as paddle`` gives the reference's name."""
    assert hasattr(paddle, name)
    assert name in tp.__all__ and getattr(tp, name) is not None


def test_default_dtype_round_trip():
    assert tp.get_default_dtype() is torch.float32
    tp.set_default_dtype("float64")
    try:
        assert tp.to_tensor(1.5).dtype == torch.float64
        assert tp.zeros([2]).dtype == torch.float64
    finally:
        tp.set_default_dtype("float32")
    with pytest.raises(TypeError):
        tp.set_default_dtype("int32")


TO_TENSOR = {
    "py_float": lambda: 1.5,
    "py_int": lambda: 3,
    "py_bool": lambda: True,
    "int_list": lambda: [1, 2, 3],
    "float_list": lambda: [1.5, 2.0],
    "f64_array": lambda: np.random.RandomState(0).randn(2, 3),
    "f32_array": lambda: np.random.RandomState(0).randn(2, 3).astype(
        np.float32),
    "i32_array": lambda: np.arange(6, dtype=np.int32).reshape(2, 3),
    "i64_array": lambda: np.arange(6, dtype=np.int64),
    "bool_array": lambda: np.array([True, False]),
    "u8_array": lambda: np.arange(4, dtype=np.uint8),
}


@pytest.mark.parametrize("dtype", [None, "float32", "bfloat16", "int64"])
@pytest.mark.parametrize("case", sorted(TO_TENSOR))
def test_to_tensor_dtype_rules_match_reference(case, dtype):
    data = TO_TENSOR[case]()
    want = paddle.to_tensor(data, dtype=dtype)
    got = tp.to_tensor(data, dtype=dtype)
    assert isinstance(got, tp.Tensor) and got.device.type == "cpu"
    assert tdtype.dtype_name(got.dtype) == jdtype.dtype_name(want.dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.numpy(), np.float32))
    assert not got.requires_grad


def test_to_tensor_copies_and_records_gradients_when_asked():
    src = torch.ones(3)
    t = tp.to_tensor(src, stop_gradient=False)
    assert t.requires_grad and t.is_leaf
    t.sum().backward()
    src.add_(1)
    assert torch.equal(t.detach(), torch.ones(3))
    assert torch.equal(t.grad, torch.ones(3))


def test_no_fallback_without_cuda(monkeypatch):
    """Without CUDA, nothing lands on the CPU unless the CPU was asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    del tplace._state.place  # no set_device in this thread: the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.to_tensor(np.ones(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.CUDAPlace(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.get_device()
    assert tp.to_tensor(np.ones(2), place=tp.CPUPlace()).device.type == "cpu"
    assert tp.nn.Linear(2, 2, device="cpu").weight.device.type == "cpu"
    tp.set_device("cpu")
    assert tp.to_tensor(np.ones(2)).device.type == "cpu"
    assert tp.nn.Linear(2, 2).weight.device.type == "cpu"


def test_places_and_set_device_match_reference():
    old = paddle.get_device()
    try:
        for dev in ("cpu", "cpu:0"):
            assert tp.set_device(dev) == tp.CPUPlace()
            paddle.set_device(dev)
            assert tp.get_device() == paddle.get_device() == "cpu:0"
    finally:
        paddle.set_device(old)
    assert tp.CPUPlace() == tp.Place("cpu", 0)
    assert tp.resolve_device(tp.CPUPlace()) == torch.device("cpu")
    assert tp.resolve_device("cpu") == torch.device("cpu")
    assert isinstance(tp.is_compiled_with_cuda(), bool)
    with pytest.raises(ValueError, match="TPUPlace"):
        tp.TPUPlace(0)
    with pytest.raises(ValueError, match="TPUPlace"):
        tp.set_device("tpu:0")
    with pytest.raises(ValueError, match="Unknown device"):
        tp.set_device("npu:0")


def test_set_device_is_thread_local():
    import threading

    seen = []
    t = threading.Thread(target=lambda: seen.append(
        getattr(tplace._state, "place", None)))
    t.start()
    t.join()
    assert seen == [None] and tp.get_device() == "cpu:0"


def _linear_with_attr():
    attr = tp.ParamAttr(name="fc.w", learning_rate=0.5, need_clip=False,
                        regularizer=tp.optimizer.L2Decay(0.1))
    return tp.nn.Linear(3, 4, weight_attr=attr)


def _attrs(p):
    return (p.name, p.optimize_attr, p.need_clip, p.trainable,
            p.stop_gradient, type(p.regularizer))


@pytest.mark.parametrize("move", ["bfloat16", "astype", "to_dtype",
                                  "to_device", "to_place", "float"])
def test_parameter_attributes_survive_conversion(move):
    layer = _linear_with_attr()
    w = layer.weight
    before = _attrs(w)
    {"bfloat16": lambda: layer.bfloat16(),
     "astype": lambda: layer.astype("bfloat16"),
     "to_dtype": lambda: layer.to(dtype=tp.bfloat16),
     "to_device": lambda: layer.to("cpu"),
     "to_place": lambda: layer.to(tp.CPUPlace()),
     "float": lambda: layer.bfloat16().float()}[move]()
    assert layer.weight is w and isinstance(w, tp.Parameter)
    assert _attrs(w) == before
    want = torch.float32 if move in ("to_device", "to_place", "float") \
        else torch.bfloat16
    assert w.dtype == want and layer._dtype == want


def test_parameter_deepcopy_and_torch_constructor():
    layer = _linear_with_attr()
    twin = copy.deepcopy(layer)
    for a, b in zip(layer.parameters(), twin.parameters()):
        assert a is not b and isinstance(b, tp.Parameter)
        assert _attrs(a) == _attrs(b) and torch.equal(a, b)
        assert a.optimize_attr is not b.optimize_attr
    p = type(layer.weight)(torch.ones(2), False)  # torch.nn.Parameter's call
    assert isinstance(p, tp.Parameter) and not p.requires_grad
    assert p.stop_gradient and not p.trainable
    p.stop_gradient = False
    assert p.requires_grad and p.trainable


def test_parameter_matches_reference_attributes():
    data = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    want = paddle.Parameter(data, name="w")
    got = tp.Parameter(data, name="w")
    for attr in ("name", "trainable", "optimize_attr", "regularizer",
                 "need_clip", "persistable", "stop_gradient"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())
    assert tp.Parameter(data).name.startswith("param_")


def test_unique_name_guard_repeats_names():
    with tp.utils.unique_name.guard():
        a = [p.name for p in tp.nn.Linear(2, 2).parameters()]
    with tp.utils.unique_name.guard():
        b = [p.name for p in tp.nn.Linear(2, 2).parameters()]
    c = [p.name for p in tp.nn.Linear(2, 2).parameters()]
    assert a == b == ["param_0", "param_1"] and c != a


def _grad_mode_trace(pkg, enabled):
    out = [enabled()]
    with pkg.no_grad():
        out.append(enabled())
        with pkg.enable_grad():
            out.append(enabled())
        out.append(enabled())

    @pkg.no_grad()
    def f():
        return enabled()

    out += [f(), enabled()]
    pkg.set_grad_enabled(False)
    out.append(enabled())
    pkg.set_grad_enabled(True)
    out.append(enabled())
    return out


def test_grad_mode_api_matches_reference():
    want = _grad_mode_trace(paddle, paddle.grad_enabled)
    got = _grad_mode_trace(tp, torch.is_grad_enabled)
    assert got == want == [True, False, True, False, False, True, False, True]
    assert tp.is_grad_enabled() and tp.grad_enabled()
    with tp.no_grad():
        assert not (tp.ones([2]) * tp.to_tensor(
            np.ones(2, np.float32), stop_gradient=False)).requires_grad


def _inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(3, 4).astype(np.float32),
            rng.randn(4, 2).astype(np.float32))


def _f(pkg, x, w):
    return pkg.sum(pkg.tanh(pkg.matmul(x, w)) * pkg.square(x).sum())


@pytest.mark.parametrize("create_graph", [False, True])
def test_autograd_grad_matches_reference(create_graph):
    xa, wa = _inputs()
    jx = paddle.to_tensor(xa, stop_gradient=False)
    jw = paddle.to_tensor(wa, stop_gradient=False)
    want = paddle.grad(_f(paddle, jx, jw), [jx, jw],
                       create_graph=create_graph)
    x = tp.to_tensor(xa, stop_gradient=False)
    w = tp.to_tensor(wa, stop_gradient=False)
    got = tp.grad(_f(tp, x, w), [x, w], create_graph=create_graph)
    assert isinstance(got, list) and len(got) == 2
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert x.grad is None and w.grad is None
    if create_graph:  # a second order through the first
        (gg,) = tp.grad(got[1].sum(), [w])
        (jgg,) = paddle.grad(want[1].sum(), [jw])
        np.testing.assert_allclose(gg.numpy(), jgg.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_autograd_grad_unused_input():
    x = tp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    y = tp.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    with pytest.raises(RuntimeError):
        tp.grad((x * 2).sum(), [x, y])
    gx, gy = tp.grad((x * 2).sum(), [x, y], allow_unused=True)
    assert gy is None and torch.equal(gx, torch.full((2,), 2.0))


def _cube_layer(pkg, saved):
    class Cube(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, w, s, shift=0.0):
            ctx.save_for_backward(x, w)
            ctx.s = s
            return x * x * x * s * w + shift

        @staticmethod
        def backward(ctx, dy):
            x, w = saved(ctx)
            return dy * 3 * x * x * ctx.s * w, dy * x * x * x * ctx.s

    return Cube


def test_pylayer_matches_reference():
    xa, _ = _inputs()
    wa = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    jx = paddle.to_tensor(xa, stop_gradient=False)
    jw = paddle.to_tensor(wa, stop_gradient=False)
    jcube = _cube_layer(paddle, lambda ctx: ctx.saved_tensors())
    jy = jcube.apply(jx, jw, 2.0, shift=1.0)
    paddle.sum(jy * jy).backward()
    x = tp.to_tensor(xa, stop_gradient=False)
    w = tp.to_tensor(wa, stop_gradient=False)
    cube = _cube_layer(tp, lambda ctx: ctx.saved_tensor())
    y = cube.apply(x, w, 2.0, shift=1.0)
    tp.sum(y * y).backward()
    np.testing.assert_allclose(y.detach().numpy(), jy.numpy(), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.grad.numpy(), jw.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    with tp.no_grad():
        assert not cube.apply(x, w, 2.0).requires_grad
