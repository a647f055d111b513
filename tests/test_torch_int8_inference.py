"""The int8 serving path of ``paddle_tpu_torch.quantization`` against the
reference's on the CPU: PTQ calibration, ``convert_to_int8_inference``,
``jit.save`` and the Predictor (the two cases of
``tests/test_int8_inference.py``), the ``.pdiparams`` of each package read
by the other, and ``Int8Conv2D`` over every padding form, stride,
dilation, groups and NHWC.

The int8 weights and the scales are the reference's bit for bit, and the
int32 products are exact in both. The outputs are held to one rounding of
the rescaled product: XLA's CPU backend fuses the float32 rescale and the
bias add into one fused multiply-add, which the port (like the card)
rounds twice, so an output may differ by one ulp of ``|acc * scale|``,
which is many ulps of the output where the bias cancels it.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu import quantization as JQ
from paddle_tpu.static import InputSpec as JSpec
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import quantization as Q
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.static import InputSpec
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t._data)


def _net(pkg):
    return pkg.nn.Sequential(
        pkg.nn.Conv2D(3, 8, 3, padding=1), pkg.nn.ReLU(),
        pkg.nn.Conv2D(8, 8, 3, padding=1), pkg.nn.ReLU(),
        pkg.nn.Flatten(), pkg.nn.Linear(8 * 8 * 8, 10))


class _Calib:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        return np.random.RandomState(i).randn(3, 8, 8).astype(np.float32)


def _calibrated(pkg):
    """tests/test_int8_inference.py's model and calibration, in ``pkg``;
    the port's model carries the reference's weights."""
    paddle.seed(0)
    model = _net(pkg)
    if pkg is tp:
        ref = _net(paddle)
        load_reference_state_dict(model, {k: np.array(v._data) for k, v in
                                          ref.state_dict().items()})
    model.eval()
    ds = type("Calib", (_Calib, pkg.io.Dataset), {})()
    loader = pkg.io.DataLoader(ds, batch_size=2, num_workers=0)
    ptq = pkg.quantization.PostTrainingQuantization(model, data_loader=loader,
                                                    batch_nums=2)
    ptq.quantize()
    return model, ptq


@pytest.fixture(scope="module")
def pair():
    with cpu_device():
        jm, jp = _calibrated(paddle)
        tm, tpq = _calibrated(tp)
        x = np.random.RandomState(9).randn(2, 3, 8, 8).astype(np.float32)
        jref, tref = _np(jm(paddle.to_tensor(x))), _np(tm(torch.tensor(x)))
        JQ.convert_to_int8_inference(jm, jp)
        Q.convert_to_int8_inference(tm, tpq)
        return jm, jp, tm, tpq, x, jref, tref


def _one_rounding(got, want, bias=None):
    """|got - want| within one ulp of the largest rescaled product (at
    most max|out| + max|bias|)."""
    top = np.abs(want).max() + (np.abs(bias).max() if bias is not None
                                else 0.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.spacing(np.float32(top))))


def test_int8_swap_outputs_close_to_float(pair):
    jm, _, tm, _, x, _, tref = pair
    got = _np(tm(torch.tensor(x)))
    rel = np.abs(got - tref).max() / (np.abs(tref).max() + 1e-6)
    assert rel < 0.12, f"int8 drift {rel:.3f}"
    _one_rounding(got, _np(jm(paddle.to_tensor(x))), _np(tm[5].bias))


def test_int8_weights_and_scales_equal_the_reference(pair):
    jm, jp, tm, tpq, *_ = pair
    assert [type(m).__name__ for m in tm] == [type(m).__name__ for m in jm]
    assert isinstance(tm[0], Q.Int8Conv2D) and isinstance(tm[5],
                                                          Q.Int8Linear)
    assert tpq.weight_scales == jp.weight_scales
    for i in (0, 2, 5):
        assert tm[i].weight_q.dtype == torch.int8
        np.testing.assert_array_equal(_np(tm[i].weight_q),
                                      _np(jm[i].weight_q))
        assert (tm[i]._sw, tm[i]._cfg if i < 5 else None) == (
            jm[i]._sw, jm[i]._cfg if i < 5 else None)
        np.testing.assert_allclose(tm[i]._sx, jm[i]._sx, rtol=1e-6)


def test_int8_artifact_through_predictor(pair, tmp_path):
    _, _, tm, _, _, _, _ = pair
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype(np.float32)
    want = _np(tm(torch.tensor(x)))
    prefix = str(tmp_path / "int8net")
    tp.static.save_inference_model(
        prefix, [InputSpec([None, 3, 8, 8], "float32", name="x")], tm)
    cfg = Config(prefix)
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.copy_from_cpu(x)
    pred.run()
    got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_array_equal(got, want)
    _, meta = tjit.read_program(prefix + ".pdmodel")
    assert meta["dynamic"]
    got1 = pred.run([x[:1]])[0]  # the symbolic batch
    np.testing.assert_array_equal(got1, want[:1])
    state = tp.load(prefix + ".pdiparams", return_numpy=True)["state"]
    assert {k: v.dtype for k, v in state.items() if "weight_q" in k} == \
        dict.fromkeys(("0.weight_q", "2.weight_q", "5.weight_q"),
                      np.dtype(np.int8))


def test_each_package_reads_the_others_pdiparams(pair, tmp_path):
    """The int8 weights travel as int8 in the reference's format, both
    ways."""
    jm, _, tm, _, x, _, _ = pair
    tp_prefix, j_prefix = str(tmp_path / "port"), str(tmp_path / "ref")
    tp.static.save_inference_model(
        tp_prefix, [InputSpec([2, 3, 8, 8], "float32", name="x")], tm)
    paddle.static.save_inference_model(
        j_prefix, [JSpec([2, 3, 8, 8], "float32", name="x")], jm)
    mine = tp.load(j_prefix + ".pdiparams", return_numpy=True)
    theirs = paddle.load(tp_prefix + ".pdiparams", return_numpy=True)
    ref_state, port_state = mine["state"], theirs["state"]
    assert set(ref_state) == set(port_state)
    for k in ref_state:
        a, b = np.asarray(ref_state[k]), np.asarray(port_state[k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert ref_state["0.weight_q"].dtype == np.int8


@pytest.mark.parametrize("case", [
    dict(padding=1), dict(padding=(1, 2)), dict(padding="SAME", stride=2),
    dict(padding="VALID", stride=(2, 1)), dict(padding=[1, 1, 0, 2]),
    dict(padding="SAME", dilation=2), dict(padding=0, groups=2),
    dict(padding="SAME", stride=2, data_format="NHWC"),
    dict(padding=(1, 1), groups=4, data_format="NHWC"),
], ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_int8_conv2d_matches_reference(case):
    rng = np.random.RandomState(7)
    groups = case.get("groups", 1)
    fmt = case.get("data_format", "NCHW")
    wq = rng.randint(-127, 128, (8, 8 // groups, 3, 3)).astype(np.int8)
    b = rng.randn(8).astype(np.float32)
    x = (rng.randn(2, 8, 9, 7) * 3).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    args = (2.5, 0.75, case.get("stride", 1), case["padding"],
            case.get("dilation", 1), groups, fmt)
    pad = case["padding"]
    if isinstance(pad, list):  # the reference takes (low, high) pairs
        jargs = args[:3] + ([(1, 1), (0, 2)],) + args[4:]
    elif isinstance(pad, int):  # and a pair, as its conversion makes one
        jargs = args[:3] + ((pad, pad),) + args[4:]
    else:
        jargs = args
    import jax.numpy as jnp

    jl = JQ.Int8Conv2D(jnp.asarray(wq), paddle.to_tensor(b), *jargs)
    tl = Q.Int8Conv2D(torch.tensor(wq), torch.tensor(b), *args)
    want = _np(jl(paddle.to_tensor(x)))
    got = _np(tl(torch.tensor(x)))
    assert got.shape == want.shape
    _one_rounding(got, want, b)


@pytest.mark.parametrize("shape", [(5, 12), (2, 3, 12)])
def test_int8_linear_matches_reference(shape):
    import jax.numpy as jnp

    rng = np.random.RandomState(8)
    wq = rng.randint(-127, 128, (12, 6)).astype(np.int8)
    b = rng.randn(6).astype(np.float32)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    jl = JQ.Int8Linear(jnp.asarray(wq), paddle.to_tensor(b), 4.0, 1.5)
    tl = Q.Int8Linear(torch.tensor(wq), torch.tensor(b), 4.0, 1.5)
    _one_rounding(_np(tl(torch.tensor(x))), _np(jl(paddle.to_tensor(x))), b)
    nb = Q.Int8Linear(torch.tensor(wq), None, 4.0, 1.5)
    assert nb(torch.tensor(x)).shape == shape[:-1] + (6,)


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (17, 16, 8), (40, 147, 64)])
def test_int_products_are_exact(m, k, n):
    rng = np.random.RandomState(m)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    got = Q._int8_mm(torch.tensor(a), torch.tensor(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("m,k,n", [(1, 3, 5), (17, 64, 64), (40, 147, 64),
                                   (100, 2048, 1000)])
def test_card_padding_is_exact(m, k, n):
    """The card's shape rules (M a multiple of 32, K and N of 8) by zero
    padding, taken on every device: exact, and cut back to (M, N)."""
    rng = np.random.RandomState(m)
    a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w = rng.randint(-127, 128, (k, n)).astype(np.int8)
    got = Q._int8_mm(torch.tensor(a), torch.tensor(w))
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64))


def test_card_padding_exports_with_a_symbolic_batch(pair, tmp_path):
    """Under export the row count is symbolic and padded with it: the
    artifact keeps its None batch and gives eager's numbers."""
    _, _, tm, _, _, _, _ = pair
    x = np.random.RandomState(4).randn(3, 3, 8, 8).astype(np.float32)
    want = _np(tm(torch.tensor(x)))
    prefix = str(tmp_path / "padded")
    tp.static.save_inference_model(
        prefix, [InputSpec([None, 3, 8, 8], "float32", name="x")], tm)
    _, meta = tjit.read_program(prefix + ".pdmodel")
    assert meta["dynamic"]
    cfg = Config(prefix)
    cfg.disable_gpu()
    pred = create_predictor(cfg)
    np.testing.assert_array_equal(pred.run([x])[0], want)
    np.testing.assert_array_equal(pred.run([x[:1]])[0], want[:1])


def test_cpu_saved_int8_program_carries_the_padding(pair, tmp_path):
    """An int8 model saved on the CPU with a free batch exports the zero
    padding into its graph, so every ``_int_mm`` the program runs takes
    the card's shapes (M > 16 and a multiple of 32, K and N multiples of
    8) at any batch, and the program runs as it is on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CardShapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._int_mm.default:
                (m, k), n = args[0].shape, args[1].shape[1]
                self.shapes.append((m, k, n))
            return func(*args, **(kwargs or {}))

    _, _, tm, _, _, _, _ = pair
    prefix = str(tmp_path / "cpu_saved")
    tp.static.save_inference_model(
        prefix, [InputSpec([None, 3, 8, 8], "float32", name="x")], tm)
    _, meta = tjit.read_program(prefix + ".pdmodel")
    assert meta["dynamic"] and meta["device"] == "cpu"
    layer = tjit.load(prefix, device="cpu")
    for b in (1, 3, 40):
        x = torch.tensor(np.random.RandomState(b).randn(b, 3, 8, 8)
                         .astype(np.float32))
        with CardShapes() as mode:
            got = layer(x)
        np.testing.assert_array_equal(_np(got), _np(tm(x)))
        assert len(mode.shapes) == 3
        for m, k, n in mode.shapes:
            assert m > 16 and m % 32 == 0 and k % 8 == 0 and n % 8 == 0, \
                (b, m, k, n)


def test_match_scale_suffix_rule_and_ambiguity():
    class P:
        in_scales = {"net.fc1": 1.0, "fc2": 2.0, "a.x": 3.0, "b.x": 4.0}

    assert Q._match_scale(P, "fc2") == "fc2"
    assert Q._match_scale(P, "fc1") == "net.fc1"
    assert Q._match_scale(P, "myfc1") is None  # not a dot boundary
    assert Q._match_scale(P, "outer.fc2") == "fc2"
    with pytest.warns(UserWarning, match="ambiguous"):
        assert Q._match_scale(P, "x") is None


def test_export_keeps_a_bounded_batch_symbolic(tmp_path):
    """A kernel that bounds the batch (the card's grid bounds a
    convolution net's at 65535) leaves it symbolic within the range
    export finds, not static at 1."""
    class Bounded(tp.nn.Layer):
        def forward(self, x):
            if x.shape[0] > 100:
                raise ValueError("too big")
            return x * 2

    prefix = str(tmp_path / "bounded")
    tjit.save(Bounded(), prefix,
              input_spec=[InputSpec([None, 4], "float32", "x")])
    _, meta = tjit.read_program(prefix + ".pdmodel")
    assert meta["dynamic"]
    layer = tjit.load(prefix, device="cpu")
    for b in (1, 7, 100):
        np.testing.assert_array_equal(layer(torch.ones(b, 4)).numpy(),
                                      np.full((b, 4), 2.0, np.float32))
