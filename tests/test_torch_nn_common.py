"""``paddle_tpu_torch.nn.functional``'s common functions and ``nn``'s common
layers and containers against the JAX package's, on the same numpy inputs
from a seed: outputs and the gradients of a weighted sum of them.

Tolerances: f32 rtol 1e-5, atol 1e-6 (``interpolate``'s resize matrices
are built in float64 as ``jax.image``'s are, then applied in float32);
integers exactly. ``interpolate`` runs every mode, down and up, in both
layouts. The random functions (the dropouts, ``class_center_sample``) are
held by their shape, range, moments and invariants, and by the reference's
deterministic paths (``p = 0``, eval, ``downscale_in_infer``). Also: the
reference's positional order of ``dropout`` (repaired: the port took
``(x, p, training)``), ``Dropout``'s ``axis`` and ``mode``, and
``HookRemoveHelper``.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, carry, check, check_layer, function_of
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(1)
X = _R.randn(3, 4).astype(np.float32)
IMG = _R.randn(2, 3, 6, 8).astype(np.float32)
IMG16 = _R.randn(2, 16, 4, 6).astype(np.float32)
VOL = _R.randn(1, 2, 4, 6, 5).astype(np.float32)
SEQ = _R.randn(2, 3, 9).astype(np.float32)
LAB = _R.randint(0, 5, (6,)).astype(np.int64)

FUNCTIONS = {
    "linear": ((A(X), A(_R.randn(4, 5).astype(np.float32)),
                A(_R.randn(5).astype(np.float32))), {}),
    "embedding": ((A(_R.randint(0, 6, (2, 3))), A(_R.randn(6, 4).astype(
        np.float32))), {"padding_idx": 2}),
    "pad": ((A(IMG), [1, 2, 0, 3]), {"mode": "reflect"}),
    "pad_const": ((A(IMG), [1, 2, 2, 1]), {"value": 0.5}),
    "one_hot": ((A(LAB), 5), {}),
    "label_smooth": ((A(np.eye(5, dtype=np.float32)[LAB]),), {"epsilon": 0.2}),
    "label_smooth_prior": ((A(np.eye(5, dtype=np.float32)[LAB]),),
                           {"prior_dist": A(np.full((1, 5), 0.2, np.float32)),
                            "epsilon": 0.3}),
    "unfold": ((A(IMG), [3, 2]), {"strides": [1, 2], "paddings": 1,
                                  "dilations": [2, 1]}),
    "unfold_pad4": ((A(IMG), 2), {"paddings": [1, 0, 2, 1]}),
    "fold": ((A(_R.randn(2, 3 * 4, 20).astype(np.float32)), [5, 8], 2),
             {"strides": [1, 2], "paddings": [0, 1]}),
    "cosine_similarity": ((A(X), A(_R.randn(3, 4).astype(np.float32))),
                          {"axis": 1}),
    "pixel_shuffle": ((A(IMG16), 2), {}),
    "pixel_shuffle_nhwc": ((A(IMG16.transpose(0, 2, 3, 1).copy()), 2),
                           {"data_format": "NHWC"}),
    "pixel_unshuffle": ((A(IMG), 2), {}),
    "pixel_unshuffle_nhwc": ((A(IMG.transpose(0, 2, 3, 1).copy()), 2),
                             {"data_format": "NHWC"}),
    "channel_shuffle": ((A(IMG16), 4), {}),
    "channel_shuffle_nhwc": ((A(IMG16.transpose(0, 2, 3, 1).copy()), 4),
                             {"data_format": "NHWC"}),
    "normalize": ((A(X),), {"axis": 1}),
    "normalize_p1": ((A(IMG),), {"p": 1, "axis": -1}),
    "bilinear": ((A(X), A(_R.randn(3, 2).astype(np.float32)),
                  A(_R.randn(5, 4, 2).astype(np.float32)),
                  A(_R.randn(5).astype(np.float32))), {}),
    "dropout_eval": ((A(X), 0.3), {"training": False}),
    "dropout_downscale": ((A(X), 0.3), {"training": False,
                                        "mode": "downscale_in_infer"}),
    "dropout_p0": ((A(X), 0.0), {}),
    "dropout2d_eval": ((A(IMG),), {"training": False}),
    "dropout3d_eval": ((A(VOL),), {"training": False}),
    "alpha_dropout_eval": ((A(X),), {"training": False}),
}

@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function(case):
    args, kw = FUNCTIONS[case]
    name = function_of(case, JF)
    check(getattr(JF, name), getattr(TF, name), args, kw, what=case)


MODES = {"nearest": IMG, "bilinear": IMG, "bicubic": IMG, "area": IMG,
         "linear": SEQ, "trilinear": VOL}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("how", ["down", "up", "scale", "mixed", "nhwc"])
def test_interpolate(mode, how):
    x = MODES[mode]
    nd = x.ndim - 2
    spatial = x.shape[2:]
    kw = {"mode": mode}
    if how == "down":
        kw["size"] = [max(1, s // 2) for s in spatial]
    elif how == "up":
        kw["size"] = [s * 2 + 1 for s in spatial]
    elif how == "scale":
        kw["scale_factor"] = 1.5
    elif how == "mixed":
        kw["size"] = [s * 3 if i % 2 else max(1, s - 3)
                      for i, s in enumerate(spatial)]
        kw["align_corners"] = True
    else:
        x = np.moveaxis(x, 1, -1).copy()
        kw["size"] = [s + 3 for s in spatial]
        kw["data_format"] = {1: "NWC", 2: "NHWC", 3: "NDHWC"}[nd]
    check(JF.interpolate, TF.interpolate, (A(x),), kw, what=f"{mode} {how}")


def test_upsample_is_interpolate():
    check(JF.upsample, TF.upsample, (A(IMG),),
          {"scale_factor": 0.5, "mode": "bilinear"})


def test_dropout_takes_the_references_positional_order():
    """``dropout(x, p, axis, training, mode)``: the call
    ``F.dropout(x, 0.1, None, False)`` is an inference call, as in the
    reference (the port's old ``(x, p, training)`` read None as
    ``training``)."""
    x = torch.tensor(X)
    jy = JF.dropout(paddle.to_tensor(X), 0.1, None, False)
    np.testing.assert_array_equal(TF.dropout(x, 0.1, None, False).numpy(),
                                  np.asarray(jy.numpy()))
    jy = JF.dropout(paddle.to_tensor(X), 0.1, None, False,
                    "downscale_in_infer")
    np.testing.assert_allclose(
        TF.dropout(x, 0.1, None, False, "downscale_in_infer").numpy(),
        np.asarray(jy.numpy()), rtol=1e-6)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_masks(mode):
    x = torch.ones(64, 32, 16)
    y = TF.dropout(x, 0.25, axis=[0, 2], training=True, mode=mode)
    kept = y != 0
    # one draw per (axis 0, axis 2) position, the same along axis 1
    assert torch.equal(kept, kept[:, :1, :].expand_as(kept))
    scale = 1 / 0.75 if mode == "upscale_in_train" else 1.0
    np.testing.assert_allclose(y[kept].numpy(), scale, rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.75) < 0.03
    d2 = TF.dropout2d(torch.ones(50, 40, 3, 3), 0.5)
    assert torch.equal(d2 != 0, (d2 != 0)[:, :, :1, :1].expand_as(d2))


def test_alpha_dropout_keeps_mean_and_variance():
    x = torch.randn(400000)
    y = TF.alpha_dropout(x, 0.2)
    assert abs(float(y.mean())) < 0.01 and abs(float(y.var()) - 1) < 0.02


def test_dropout_layer_axis_and_mode():
    """``nn.Dropout`` takes ``axis`` and ``mode`` (it refused both)."""
    d = tnn.Dropout(0.4, axis=1, mode="downscale_in_infer")
    d.eval()
    np.testing.assert_allclose(d(torch.ones(3, 5)).numpy(), 0.6, rtol=1e-6)
    jd = jnn.Dropout(0.4, axis=1, mode="downscale_in_infer")
    jd.eval()
    np.testing.assert_allclose(np.asarray(jd(paddle.ones([3, 5])).numpy()),
                               0.6, rtol=1e-6)
    d.train()
    y = d(torch.ones(100, 7))
    assert torch.equal(y != 0, (y != 0)[:1].expand_as(y))


def test_class_center_sample_invariants():
    from paddle_tpu_torch.core import random as random_state

    label = torch.tensor([3, 17, 3, 42, 9, 17])
    random_state.seed(0)
    remapped, sampled = TF.class_center_sample(label, 100, 10)
    assert sampled.dtype == torch.int64 and remapped.dtype == torch.int64
    assert len(sampled) == 10 and torch.equal(sampled, sampled.sort().values)
    assert set(label.tolist()) <= set(sampled.tolist())
    assert torch.equal(sampled[remapped], label)
    random_state.seed(0)
    assert torch.equal(TF.class_center_sample(label, 100, 10)[1], sampled)
    jr, js = JF.class_center_sample(paddle.to_tensor(label.numpy()), 100, 10)
    assert len(np.asarray(js.numpy())) == 10


LAYERS = {
    "Identity": (lambda m: m.Identity(), IMG),
    "Flatten": (lambda m: m.Flatten(1, 2), IMG),
    "Pad1D": (lambda m: m.Pad1D([1, 2], mode="replicate"), SEQ),
    "Pad2D": (lambda m: m.Pad2D([1, 0, 2, 1], mode="reflect"), IMG),
    "Pad3D": (lambda m: m.Pad3D([1, 0, 2, 1, 0, 1], value=0.3), VOL),
    "ZeroPad2D": (lambda m: m.ZeroPad2D([2, 1, 0, 1]), IMG),
    "Upsample": (lambda m: m.Upsample(scale_factor=2, mode="bicubic"), IMG),
    "UpsamplingBilinear2D": (lambda m: m.UpsamplingBilinear2D(size=[4, 5]),
                             IMG),
    "UpsamplingNearest2D": (lambda m: m.UpsamplingNearest2D(
        scale_factor=3), IMG),
    "PixelShuffle": (lambda m: m.PixelShuffle(2), IMG16),
    "PixelUnshuffle": (lambda m: m.PixelUnshuffle(2), IMG),
    "ChannelShuffle": (lambda m: m.ChannelShuffle(8), IMG16),
    "Unfold": (lambda m: m.Unfold([2, 3], strides=2), IMG),
    "Fold": (lambda m: m.Fold([4, 4], 2, strides=2),
             _R.randn(2, 8, 4).astype(np.float32)),
    "Dropout_eval": (lambda m: m.Dropout(0.5), X),
    "Dropout2D_eval": (lambda m: m.Dropout2D(0.5), IMG),
    "Dropout3D_eval": (lambda m: m.Dropout3D(0.5), VOL),
    "AlphaDropout_eval": (lambda m: m.AlphaDropout(0.5), X),
    "Sequential": (lambda m: m.Sequential(m.Linear(4, 6), m.ReLU(),
                                          m.Linear(6, 2)), X),
    "Sequential_dict": (lambda m: m.Sequential(collections.OrderedDict(
        [("fc", m.Linear(4, 3)), ("act", m.Tanh())])), X),
    "Sequential_pairs": (lambda m: m.Sequential(("a", m.Linear(4, 3)),
                                                ("b", m.Sigmoid())), X),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    build, x = LAYERS[name]
    paddle.seed(0)
    jl = build(jnn)
    with cpu_device():
        tl = build(tnn)
    if name.endswith("_eval"):
        jl.eval()
        tl.eval()
    check_layer(jl, tl, (A(x),), what=name)


def test_two_input_layers():
    jb, tb = jnn.Bilinear(4, 2, 3), tnn.Bilinear(4, 2, 3, device="cpu")
    assert sorted(n for n, _ in tb.named_parameters()) == ["bias", "weight"]
    check_layer(jb, tb, (A(X), A(_R.randn(3, 2).astype(np.float32))))
    jc, tc = jnn.CosineSimilarity(axis=0), tnn.CosineSimilarity(axis=0)
    check_layer(jc, tc, (A(X), A(_R.randn(3, 4).astype(np.float32))))


def test_containers():
    with cpu_device():
        pl = tnn.ParameterList([tnn.Linear(2, 2).weight,
                                tnn.Linear(2, 3).weight])
        ld = tnn.LayerDict({"a": tnn.Linear(2, 2), "b": tnn.ReLU()})
        seq = tnn.Sequential(tnn.Linear(4, 3), tnn.ReLU(), tnn.Linear(3, 2))
    assert [n for n, _ in pl.named_parameters()] == ["0", "1"]
    assert len(pl) == 2 and pl[1].shape == (2, 3)
    assert list(ld.keys()) == ["a", "b"] and "a" in ld and len(ld) == 2
    assert [n for n, _ in ld.named_parameters()] == ["a.weight", "a.bias"]
    assert len(seq) == 3 and isinstance(seq[1], tnn.ReLU)
    assert isinstance(seq[1:], tnn.Sequential) and len(seq[1:]) == 2
    jseq = jnn.Sequential(jnn.Linear(4, 3), jnn.ReLU(), jnn.Linear(3, 2))
    assert [n for n, _ in seq.named_parameters()] == \
        [n for n, _ in jseq.named_parameters()]


def test_hooks_and_their_remove_helper():
    from paddle_tpu_torch.nn.layer.layers import HookRemoveHelper

    with cpu_device():
        layer = tnn.Linear(4, 2)
    seen = []
    pre = layer.register_forward_pre_hook(
        lambda l, inputs: (inputs[0] * 2,))
    post = layer.register_forward_post_hook(
        lambda l, inputs, out: seen.append(out.shape) or out + 1)
    assert isinstance(pre, HookRemoveHelper)
    x = torch.tensor(X)
    y = layer(x)
    np.testing.assert_allclose(
        y.detach().numpy(), (TF.linear(x * 2, layer.weight, layer.bias)
                             + 1).detach().numpy(), rtol=1e-6)
    pre.remove()
    post.remove()
    np.testing.assert_allclose(layer(x).detach().numpy(),
                               TF.linear(x, layer.weight,
                                         layer.bias).detach().numpy())
    assert seen == [(3, 2)]


# -- nn.utils -------------------------------------------------------------------
def _fc_pair():
    jl = jnn.Linear(4, 3)
    return jl, carry(jl, tnn.Linear(4, 3, device="cpu"))


def test_weight_norm_and_its_removal():
    from paddle_tpu.nn import utils as ju
    from paddle_tpu_torch.nn import utils as tu

    jl, tl = _fc_pair()
    ju.weight_norm(jl, dim=1)
    tu.weight_norm(tl, dim=1)
    assert sorted(n for n, _ in tl.named_parameters()) == \
        sorted(n for n, _ in jl.named_parameters()) == ["bias", "weight_g",
                                                        "weight_v"]
    check_layer(jl, tl, (A(X),), what="weight_norm")
    # the removal recomputes the norm over every axis but 0, as the
    # reference's does
    jl, tl = _fc_pair()
    ju.weight_norm(jl)
    tu.weight_norm(tl)
    tu.remove_weight_norm(tl)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias", "weight"]
    want = np.asarray(jl(paddle.to_tensor(X)).numpy())
    np.testing.assert_allclose(tl(torch.tensor(X)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_spectral_norm_hook():
    from paddle_tpu.nn import utils as ju
    from paddle_tpu_torch.nn import utils as tu

    jl, tl = _fc_pair()
    ju.spectral_norm(jl, n_power_iterations=3)
    tu.spectral_norm(tl, n_power_iterations=3)
    assert sorted(n for n, _ in tl.named_parameters()) == ["bias",
                                                           "weight_orig"]
    check_layer(jl, tl, (A(X),), what="spectral_norm")


def test_parameters_to_vector_and_back():
    from paddle_tpu.nn import utils as ju
    from paddle_tpu_torch.nn import utils as tu

    jl, tl = _fc_pair()
    tv = tu.parameters_to_vector(tl.parameters())
    np.testing.assert_array_equal(
        tv.detach().numpy(),
        np.asarray(ju.parameters_to_vector(jl.parameters()).numpy()))
    tu.vector_to_parameters(tv * 2, tl.parameters())
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               2 * np.asarray(jl.bias.numpy()), rtol=1e-6)


# -- autograd.grad(no_grad_vars=...) ---------------------------------------------
def test_grad_holds_no_grad_vars_constant():
    """The listed tensors are constants: the gradient equals the one taken
    with them cut out of the graph (the reference's ``stop_gradient``)."""
    import paddle_tpu_torch.autograd as tag

    x = torch.tensor(X, requires_grad=True)
    h = torch.tanh(x) * 3
    y = (h * x).sum() + (h ** 2).sum()
    got, = tag.grad(y, x, retain_graph=True, no_grad_vars=[h])
    jx = paddle.to_tensor(X, stop_gradient=False)
    jh = (paddle.tanh(jx) * 3).detach()
    jy = (jh * jx).sum() + (jh ** 2).sum()
    want, = paddle.grad(jy, jx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6)
    full, = tag.grad(y, x)
    assert not torch.allclose(full, got)
    assert h._backward_hooks in (None, {}) or not h._backward_hooks


# -- AMP --------------------------------------------------------------------------
AMP = {
    "conv2d": (lambda F, t: F.conv2d(t(IMG), t(np.ones((2, 3, 3, 3),
                                                         np.float32))),
               "bfloat16"),
    "linear": (lambda F, t: F.linear(t(X), t(np.ones((4, 2), np.float32))),
               "bfloat16"),
    "batch_norm": (lambda F, t: F.batch_norm(
        t(IMG, "bfloat16"), t(np.zeros(3, np.float32)),
        t(np.ones(3, np.float32)), training=True), "float32"),
    "softmax": (lambda F, t: F.softmax(t(X, "bfloat16")), "float32"),
    "log_softmax": (lambda F, t: F.log_softmax(t(X, "bfloat16")),
                    "float32"),
    "mse_loss": (lambda F, t: F.mse_loss(t(X, "bfloat16"),
                                         t(X * 2, "bfloat16")),
                 "float32"),
    "bce": (lambda F, t: F.binary_cross_entropy(
        t(np.full((3, 4), 0.3, np.float32), "bfloat16"),
        t(np.ones((3, 4), np.float32), "bfloat16")), "float32"),
    "group_norm": (lambda F, t: F.group_norm(t(IMG, "bfloat16"), 3),
                   "float32"),
}


@pytest.mark.parametrize("name", sorted(AMP) + ["mha"])
def test_o1_bf16_casts_as_the_reference(name):
    import paddle_tpu_torch as tp

    got = {}
    for pkg, F, to in ((paddle, JF, paddle.to_tensor),
                       (tp, TF, torch.tensor)):
        def t(a, dtype="float32", pkg=pkg, to=to):
            return pkg.cast(to(a), dtype)

        with pkg.amp.auto_cast(level="O1", dtype="bfloat16"):
            if name == "mha":
                paddle.seed(0)
                layer = (jnn if pkg is paddle else tnn).MultiHeadAttention(
                    4, 2, **({} if pkg is paddle else {"device": "cpu"}))
                x = t(np.ones((1, 3, 4), np.float32))
                out = [layer.q_proj(x), layer(x)]
            else:
                out = [AMP[name][0](F, t)]
        got[pkg is tp] = [str(o.dtype).replace("torch.", "").replace(
            "paddle.", "") for o in out]
    assert got[True] == got[False], got
    want = "bfloat16" if name == "mha" else AMP[name][1]
    assert got[True][0] == want


# -- the device rule ----------------------------------------------------------------
BUILDERS = {
    "Conv2D": lambda **kw: tnn.Conv2D(3, 4, 3, **kw),
    "Conv2DTranspose": lambda **kw: tnn.Conv2DTranspose(3, 4, 3, **kw),
    "BatchNorm2D": lambda **kw: tnn.BatchNorm2D(3, **kw),
    "GroupNorm": lambda **kw: tnn.GroupNorm(1, 3, **kw),
    "PReLU": lambda **kw: tnn.PReLU(3, **kw),
    "Bilinear": lambda **kw: tnn.Bilinear(2, 2, 2, **kw),
    "LSTM": lambda **kw: tnn.LSTM(3, 4, **kw),
    "GRUCell": lambda **kw: tnn.GRUCell(3, 4, **kw),
    "MultiHeadAttention": lambda **kw: tnn.MultiHeadAttention(4, 2, **kw),
    "Transformer": lambda **kw: tnn.Transformer(8, 2, 1, 1, 8, **kw),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_layers_build_on_the_card_unless_asked(name, monkeypatch):
    from paddle_tpu_torch.core import place

    g = torch.Generator().manual_seed(1)
    layer = BUILDERS[name](device="cpu", dtype="float32", generator=g)
    assert all(t.device.type == "cpu" for t in layer.state_dict().values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delattr(place._state, "place", raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BUILDERS[name]()


def test_initialisers_draw_from_the_given_generator():
    a = tnn.Conv2D(3, 4, 3, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    b = tnn.Conv2D(3, 4, 3, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    torch.manual_seed(123)
    c = tnn.Conv2D(3, 4, 3, device="cpu",
                   generator=torch.Generator().manual_seed(5))
    for p, q, r in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q) and torch.equal(p, r)
