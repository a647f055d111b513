"""Port parity of ``paddle_tpu_torch.nn``'s Paddle API: ``Layer`` (names,
``state_dict``, ``set_state_dict``, hooks), ``ParamAttr``, the initializers,
``GELU`` and ``functional.gelu``/``linear``/``layer_norm``, against the JAX
package on the same numpy inputs from a seed.

Outputs are f32 and held to rtol 1e-5. The initializers cannot match JAX's
bits (threefry against Philox): ``Constant``, ``Assign`` and ``Dirac`` are
held exactly and ``_fan`` on the same shapes, the random ones to their
bounds and sample moments.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.nn import initializer as JI
from paddle_tpu_torch.nn import initializer as TI
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


def _net(pkg):
    nn = pkg.nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 3)
            self.blocks = nn.LayerList([nn.Linear(3, 3), nn.LayerNorm(3)])
            self.act = nn.GELU(approximate=True)
            self.register_buffer("stat", pkg.to_tensor(
                np.arange(3, dtype=np.float32)))
            self.register_buffer("tmp", pkg.to_tensor(
                np.ones(3, np.float32)), persistable=False)

        def forward(self, x):
            x = self.act(self.fc(x))
            for b in self.blocks:
                x = b(x)
            return x + self.stat

    return Net()


def _ported_net():
    """The JAX net and a port net holding its weights."""
    paddle.seed(0)
    jnet = _net(paddle)
    tnet = _net(tp)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    assert tnet.set_state_dict(state) == ([], [])
    return jnet, tnet


X = np.random.RandomState(1).randn(2, 4).astype(np.float32)


def test_nested_names_match_reference():
    jnet, tnet = _ported_net()
    assert [k for k, _ in tnet.named_parameters()] == \
        [k for k, _ in jnet.named_parameters()]
    # the same keys (no non-persistable "tmp"); torch lists a layer's own
    # buffers before its sublayers' entries, the reference after them
    assert sorted(tnet.state_dict()) == sorted(jnet.state_dict())
    assert [k for k, _ in tnet.named_sublayers()] == \
        [k for k, _ in jnet.named_sublayers()]
    assert [k for k, _ in tnet.named_sublayers(include_self=True)][0] == ""
    assert tnet.full_name() == jnet.full_name() == "net"
    assert tnet.blocks.full_name() == jnet.blocks.full_name()
    assert isinstance(tnet.parameters(), list) and len(tnet.parameters()) == 6
    assert len(tnet.parameters(include_sublayers=False)) == 0
    assert len(tnet.sublayers()) == len(jnet.sublayers()) == 5
    assert all(isinstance(p, tp.Parameter) for p in tnet.parameters())


def test_forward_matches_reference():
    jnet, tnet = _ported_net()
    np.testing.assert_allclose(tnet(tp.to_tensor(X)).detach().numpy(),
                               jnet(paddle.to_tensor(X)).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_set_state_dict_missing_unexpected_and_cast():
    jnet, tnet = _ported_net()
    state = {k: np.asarray(v.numpy()) * 2
             for k, v in jnet.state_dict().items()}
    state.pop("fc.bias")
    state["extra"] = np.ones(1, np.float32)
    want = jnet.set_state_dict(dict(state))
    tnet.bfloat16()
    got = tnet.set_state_dict(dict(state))
    assert got == want == (["fc.bias"], ["extra"])
    w = tnet.fc.weight
    assert w.dtype == torch.bfloat16 and isinstance(w, tp.Parameter)
    np.testing.assert_array_equal(
        w.detach().float().numpy(),
        torch.from_numpy(state["fc.weight"]).bfloat16().float().numpy())
    state["fc.weight"] = np.ones((3, 4), np.float32)
    with pytest.raises(ValueError, match="fc.weight"):
        tnet.set_state_dict(state)
    with pytest.raises(ValueError, match="fc.weight"):
        jnet.set_state_dict(state)


def test_set_state_dict_takes_a_bf16_reference_state():
    """The reference's bf16 ``state_dict()`` comes out as ml_dtypes bfloat16
    arrays, which torch cannot view; they load by value."""
    jnet, tnet = _ported_net()
    jnet.bfloat16()
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    assert state["fc.weight"].dtype.name == "bfloat16"
    tnet.bfloat16()
    assert tnet.set_state_dict(state) == ([], [])
    np.testing.assert_array_equal(tnet.fc.weight.detach().float().numpy(),
                                  state["fc.weight"].astype(np.float32))


def test_state_dict_round_trip_between_port_layers():
    _, a = _ported_net()
    b = _net(tp)
    assert b.set_state_dict(a.state_dict()) == ([], [])
    for (k, v), (k2, v2) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)


def _hooked(pkg, net, x):
    calls = []

    def pre(layer, inputs):
        calls.append("pre")
        return (inputs[0] * 2,)

    def post(layer, inputs, out):
        calls.append("post")
        return out + 1

    h1 = net.fc.register_forward_pre_hook(pre)
    h2 = net.register_forward_post_hook(post)
    y1 = net(pkg.to_tensor(x))
    h1.remove()
    h2.remove()
    y2 = net(pkg.to_tensor(x))
    return y1, y2, calls


def test_forward_hooks_match_reference():
    jnet, tnet = _ported_net()
    jy1, jy2, jcalls = _hooked(paddle, jnet, X)
    ty1, ty2, tcalls = _hooked(tp, tnet, X)
    assert tcalls == jcalls == ["pre", "post"]
    for t, j in ((ty1, jy1), (ty2, jy2)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_clear_gradients_drops_them():
    _, tnet = _ported_net()
    tnet(tp.to_tensor(X)).sum().backward()
    assert all(p.grad is not None for p in tnet.parameters())
    tnet.clear_gradients()
    assert all(p.grad is None for p in tnet.parameters())


def test_param_attr_matches_reference():
    def build(pkg):
        init = pkg.nn.initializer.Constant(0.25)
        return pkg.nn.Linear(
            3, 2, weight_attr=pkg.ParamAttr(name="fc_w", initializer=init,
                                            learning_rate=0.5),
            bias_attr=pkg.ParamAttr(trainable=False))

    j, t = build(paddle), build(tp)
    for jp, tpar in ((j.weight, t.weight), (j.bias, t.bias)):
        assert tpar.optimize_attr == jp.optimize_attr
        assert tpar.trainable == jp.trainable
        assert tpar.stop_gradient == jp.stop_gradient
        np.testing.assert_array_equal(tpar.detach().numpy(), jp.numpy())
    assert t.weight.name == j.weight.name == "fc_w"
    assert tp.nn.Linear(3, 2, bias_attr=False).bias is None
    named = tp.nn.Linear(3, 2, weight_attr="w_by_name")
    assert named.weight.name == "w_by_name"
    clip_off = tp.nn.Linear(3, 2, weight_attr=tp.ParamAttr(need_clip=False))
    assert clip_off.weight.need_clip is False and clip_off.bias.need_clip


def test_create_parameter_defaults():
    layer = tp.nn.Layer()
    w = layer.create_parameter([4, 6])
    b = layer.create_parameter([6], is_bias=True)
    assert isinstance(w, tp.Parameter) and w.dtype == torch.float32
    assert torch.equal(b, torch.zeros(6))
    limit = (6.0 / 10) ** 0.5  # the default Xavier-uniform bound
    assert w.abs().max() <= limit
    assert layer.add_parameter("w", w) is w and layer.parameters() == [w]
    sub = tp.nn.Linear(2, 2)
    assert layer.add_sublayer("sub", sub) is sub and layer.sub is sub


FAN_SHAPES = [(7,), (3, 5), (4, 2, 3), (8, 3, 2, 5), ()]


@pytest.mark.parametrize("shape", FAN_SHAPES)
def test_fan_matches_reference(shape):
    assert TI._fan(shape) == JI._fan(shape)


def _closed(mod):
    return {
        "constant": mod.Constant(0.75),
        "assign": mod.Assign(np.arange(6, dtype=np.float32).reshape(2, 3)),
        "dirac": mod.Dirac(groups=2),
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["constant", "assign", "dirac"])
def test_closed_form_initializers_match_reference(name, dtype):
    shape = [4, 2, 3, 3] if name == "dirac" else [2, 3]
    want = np.asarray(_closed(JI)[name](shape, dtype).astype(np.float32))
    got = _closed(TI)[name](shape, dtype)
    assert str(got.dtype) == f"torch.{dtype}" and got.device.type == "cpu"
    np.testing.assert_array_equal(got.float().numpy(), want)


SHAPE = (64, 256)  # fan_in 64, fan_out 256
RANDOM_INITS = {
    # name: (initializer, bound, mean, std)
    "uniform": (lambda m: m.Uniform(-0.5, 1.5), (-0.5, 1.5), 0.5,
                2 / 12 ** 0.5),
    "normal": (lambda m: m.Normal(0.2, 0.7), None, 0.2, 0.7),
    "truncated_normal": (lambda m: m.TruncatedNormal(0.1, 0.5),
                         (0.1 - 1.0, 0.1 + 1.0), 0.1, 0.5 * 0.8796),
    "xavier_uniform": (lambda m: m.XavierUniform(),
                       (-(6 / 320) ** 0.5, (6 / 320) ** 0.5), 0.0,
                       (6 / 320) ** 0.5 / 3 ** 0.5),
    "xavier_normal": (lambda m: m.XavierNormal(gain=2.0), None, 0.0,
                      2.0 * (2 / 320) ** 0.5),
    "kaiming_uniform": (lambda m: m.KaimingUniform(),
                        (-(6 / 64) ** 0.5, (6 / 64) ** 0.5), 0.0,
                        (2 / 64) ** 0.5),
    "kaiming_normal": (lambda m: m.KaimingNormal(negative_slope=0.5), None,
                       0.0, (2 / 1.25) ** 0.5 / 8),
}


@pytest.mark.parametrize("name", sorted(RANDOM_INITS))
def test_random_initializer_bounds_and_moments(name):
    make, bound, mean, std = RANDOM_INITS[name]
    ref = np.asarray(make(JI)(SHAPE, "float32"))  # the same law, JAX's bits
    gen = torch.Generator().manual_seed(0)
    got = make(TI)(SHAPE, "float32", "cpu", gen).numpy().astype(np.float64)
    for v in (got, ref):
        if bound is not None:
            assert bound[0] <= v.min() and v.max() <= bound[1]
        assert abs(v.mean() - mean) < 5 * std / v.size ** 0.5
        assert abs(v.std() - std) < 0.05 * std
    again = make(TI)(SHAPE, "float32", "cpu",
                     torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, again)  # the generator decides


def test_orthogonal_initializer():
    got = TI.Orthogonal(gain=2.0)((6, 4), "float32", "cpu").double()
    eye = torch.eye(4, dtype=torch.double)
    torch.testing.assert_close(got.T @ got, 4.0 * eye, atol=1e-5, rtol=0)
    assert TI.Orthogonal()((3, 5), "bfloat16", "cpu").dtype == torch.bfloat16


def test_initializer_draws_from_the_port_seed():
    tp.seed(5)
    a = TI.Normal()((8,), "float32", "cpu")
    tp.seed(5)
    assert torch.equal(TI.Normal()((8,), "float32", "cpu"), a)


def test_default_initializers_and_global_override():
    assert isinstance(TI._default_weight_init, TI.XavierUniform)
    assert isinstance(TI._default_bias_init, TI.Constant)
    assert TI._default_bias_init.value == JI._default_bias_init.value == 0.0
    try:
        TI.set_global_initializer(TI.Constant(0.5), TI.Constant(-1.0))
        layer = tp.nn.Layer()  # Linear names Xavier-uniform itself
        w = layer.create_parameter([2, 3])
        b = layer.create_parameter([3], is_bias=True)
        assert torch.equal(w, torch.full((2, 3), 0.5))
        assert torch.equal(b, torch.full((3,), -1.0))
    finally:
        TI.set_global_initializer(TI.XavierUniform(), TI.Constant(0.0))
    assert TI.calculate_gain("relu") == JI.calculate_gain("relu")


FUNCTIONAL = {
    "gelu": (lambda pk, x: pk.nn.functional.gelu(x), (2, 8)),
    "gelu_tanh": (lambda pk, x: pk.nn.functional.gelu(x, approximate=True),
                  (2, 8)),
    "gelu_layer": (lambda pk, x: pk.nn.GELU()(x), (2, 8)),
    "linear": (lambda pk, x: pk.nn.functional.linear(
        x, pk.to_tensor(_W), pk.to_tensor(_B)), (3, 8)),
    "linear_no_bias": (lambda pk, x: pk.nn.functional.linear(
        x, pk.to_tensor(_W)), (2, 3, 8)),
    "layer_norm": (lambda pk, x: pk.nn.functional.layer_norm(
        x, 8, pk.to_tensor(_G), pk.to_tensor(_S), 1e-5), (3, 8)),
    "layer_norm_2d": (lambda pk, x: pk.nn.functional.layer_norm(
        x, [2, 8]), (3, 2, 8)),
}
_R = np.random.RandomState(7)
_W = _R.randn(8, 5).astype(np.float32)
_B = _R.randn(5).astype(np.float32)
_G = _R.randn(8).astype(np.float32)
_S = _R.randn(8).astype(np.float32)


@pytest.mark.parametrize("case", sorted(FUNCTIONAL))
def test_functional_matches_reference(case):
    fn, shape = FUNCTIONAL[case]
    x = np.random.RandomState(8).randn(*shape).astype(np.float32) * 2
    want = fn(paddle, paddle.to_tensor(x)).numpy()
    got = fn(tp, tp.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_layer_norm_layer_matches_reference():
    def build(pkg):
        return pkg.nn.LayerNorm([2, 8], epsilon=1e-6)

    j, t = build(paddle), build(tp)
    x = np.random.RandomState(9).randn(3, 2, 8).astype(np.float32)
    assert [k for k, _ in t.named_parameters()] == \
        [k for k, _ in j.named_parameters()]
    np.testing.assert_allclose(t(tp.to_tensor(x)).detach().numpy(),
                               j(paddle.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    bare = tp.nn.LayerNorm(4, weight_attr=False, bias_attr=False)
    assert bare.weight is None and bare.bias is None


def test_embedding_padding_idx_row_starts_at_zero_and_keeps_it():
    emb = tp.nn.Embedding(6, 3, padding_idx=2)
    assert torch.equal(emb.weight[2], torch.zeros(3))
    out = emb(torch.tensor([[2, 1]]))
    out.sum().backward()
    assert torch.equal(emb.weight.grad[2], torch.zeros(3))
    assert torch.equal(emb.weight.grad[1], torch.ones(3))
