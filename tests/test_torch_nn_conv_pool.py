"""``paddle_tpu_torch.nn``'s convolutions and pools, functions and layers,
against the JAX package's, on the same numpy inputs from a seed: outputs
and the gradients (inputs, weights, biases) of a weighted sum of them.

The cases cover every padding form (an int, one per axis, the ``2n`` list,
(lo, hi) pairs, ``"SAME"``, ``"VALID"``), strides, dilation, groups,
channel-last layouts, the transposes' ``output_padding``, and for the pools
``ceil_mode``, ``exclusive``, ``return_mask`` and the adaptive windows.

Tolerances: convolutions rtol 1e-4 (atol 1e-5); pools rtol 1e-5 (atol
1e-6); ``max_pool2d``'s mask exactly, int64.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, check, check_layer
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(3)
X1 = _R.randn(2, 4, 11).astype(np.float32)
X2 = _R.randn(2, 4, 9, 10).astype(np.float32)
X3 = _R.randn(1, 4, 5, 6, 7).astype(np.float32)
XN = {1: X1, 2: X2, 3: X3}


def _w(nd, out_c, in_c, k=3):
    return _R.randn(out_c, in_c, *([k] * nd)).astype(np.float32) * 0.3


def _cl(x):
    return np.moveaxis(x, 1, -1).copy()


_CL = {1: "NLC", 2: "NHWC", 3: "NDHWC"}

CONV = {
    "int": (2, {"padding": 1}),
    "per_axis": (2, {"padding": [2, 0], "stride": [2, 1]}),
    "lo_hi": (2, {"padding": [1, 2, 0, 1]}),
    "pairs": (2, {"padding": [[2, 1], [1, 0]]}),
    "3d_full_spec": (3, {"padding": [[0, 0], [0, 0], [1, 0], [0, 2],
                                     [1, 1]]}),
    "same": (2, {"padding": "SAME", "stride": 2}),
    "same_dilated": (2, {"padding": "same", "dilation": 2}),
    "valid": (2, {"padding": "VALID", "stride": [1, 3]}),
    "groups": (2, {"padding": 1, "groups": 2}),
    "depthwise": (2, {"padding": 1, "groups": 4, "dilation": [2, 1]}),
    "nhwc": (2, {"padding": [1, 0, 2, 1], "stride": 2, "cl": True}),
    "1d": (1, {"padding": 2, "stride": 2, "dilation": 2}),
    "1d_nlc": (1, {"padding": "SAME", "cl": True}),
    "3d": (3, {"padding": [1, 0, 1], "stride": [1, 2, 1]}),
    "3d_ndhwc": (3, {"padding": "SAME", "groups": 2, "cl": True}),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv(case):
    nd, kw = CONV[case]
    kw = dict(kw)
    groups = kw.get("groups", 1)
    x = XN[nd]
    if kw.pop("cl", False):
        x, kw["data_format"] = _cl(x), _CL[nd]
    w = _w(nd, 6 if groups != 4 else 8, 4 // groups)
    b = _R.randn(w.shape[0]).astype(np.float32)
    name = f"conv{nd}d"
    check(getattr(JF, name), getattr(TF, name), (A(x), A(w), A(b)), kw,
          rtol=1e-4, atol=1e-5, what=case)


CONV_T = {
    "plain": (2, {}),
    "stride_outpad": (2, {"stride": 2, "padding": 1, "output_padding": 1}),
    "lo_hi": (2, {"stride": 2, "padding": [1, 0, 0, 2]}),
    "outpad_big": (2, {"stride": [2, 3], "output_padding": [0, 2]}),
    "groups_dilation": (2, {"groups": 2, "dilation": 2, "padding": 1}),
    "nhwc": (2, {"stride": 2, "padding": 1, "cl": True}),
    "1d": (1, {"stride": 3, "padding": 1, "output_padding": 2}),
    "3d": (3, {"stride": [1, 2, 2], "padding": 1, "groups": 2}),
}


@pytest.mark.parametrize("case", sorted(CONV_T))
def test_conv_transpose(case):
    nd, kw = CONV_T[case]
    kw = dict(kw)
    groups = kw.get("groups", 1)
    x = XN[nd]
    if kw.pop("cl", False):
        x, kw["data_format"] = _cl(x), _CL[nd]
    w = _w(nd, 4, 6 // groups)  # (in, out / groups, *k)
    b = _R.randn(6).astype(np.float32)
    name = f"conv{nd}d_transpose"
    check(getattr(JF, name), getattr(TF, name), (A(x), A(w), A(b)), kw,
          rtol=1e-4, atol=1e-5, what=case)


CONV_LAYERS = {
    "Conv1D": (lambda m, **kw: m.Conv1D(4, 6, 3, padding=1, **kw), X1),
    "Conv2D": (lambda m, **kw: m.Conv2D(4, 6, [3, 2], stride=2, groups=2,
                                        **kw), X2),
    "Conv2D_nhwc": (lambda m, **kw: m.Conv2D(4, 6, 3, padding="SAME",
                                             data_format="NHWC", **kw),
                    _cl(X2)),
    "Conv3D": (lambda m, **kw: m.Conv3D(4, 2, 2, bias_attr=False, **kw), X3),
    "Conv1DTranspose": (lambda m, **kw: m.Conv1DTranspose(4, 3, 3, stride=2,
                                                          **kw), X1),
    "Conv2DTranspose": (lambda m, **kw: m.Conv2DTranspose(
        4, 6, 3, stride=2, padding=1, output_padding=1, groups=2, **kw), X2),
    "Conv3DTranspose": (lambda m, **kw: m.Conv3DTranspose(4, 2, 2, **kw),
                        X3),
}


@pytest.mark.parametrize("name", sorted(CONV_LAYERS))
def test_conv_layer(name):
    build, x = CONV_LAYERS[name]
    jl, tl = build(jnn), build(tnn, device="cpu")
    assert [n for n, _ in tl.named_parameters()] == \
        [n for n, _ in jl.named_parameters()]
    check_layer(jl, tl, (A(x),), rtol=1e-4, atol=1e-5, what=name)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_transpose_refuses_string_padding(padding):
    """As the reference's (its convolution over the dilated input takes no
    string)."""
    for fn in (JF.conv2d_transpose, TF.conv2d_transpose):
        x = paddle.to_tensor(X2) if fn is JF.conv2d_transpose \
            else torch.tensor(X2)
        w = _w(2, 4, 6)
        w = paddle.to_tensor(w) if fn is JF.conv2d_transpose \
            else torch.tensor(w)
        with pytest.raises(ValueError):
            fn(x, w, stride=2, padding=padding)


def test_conv_layer_initialisation_bounds():
    tl = tnn.Conv2D(8, 16, 3, device="cpu").requires_grad_(False)
    bound = 1 / np.sqrt(8 * 9)
    assert float(tl.bias.abs().max()) <= bound
    assert float(tl.weight.abs().max()) <= np.sqrt(6 / (8 * 9))
    assert abs(float(tl.weight.std()) - np.sqrt(2 / (8 * 9))) < 0.02


POOL = {
    "max2d": ("max_pool2d", 2, {"kernel_size": 3, "stride": 2}),
    "max2d_pad": ("max_pool2d", 2, {"kernel_size": 3, "stride": 2,
                                    "padding": 1}),
    "max2d_ceil": ("max_pool2d", 2, {"kernel_size": 3, "stride": 2,
                                     "ceil_mode": True}),
    "max2d_lo_hi": ("max_pool2d", 2, {"kernel_size": [2, 3],
                                      "padding": [0, 1, 1, 0]}),
    "max2d_same": ("max_pool2d", 2, {"kernel_size": 4, "stride": 3,
                                     "padding": "SAME"}),
    "max2d_nhwc": ("max_pool2d", 2, {"kernel_size": 2, "padding": 1,
                                     "cl": True}),
    "max2d_mask": ("max_pool2d", 2, {"kernel_size": 2, "stride": 2,
                                     "return_mask": True}),
    "max2d_mask_nhwc": ("max_pool2d", 2, {"kernel_size": 3, "stride": 2,
                                          "return_mask": True, "cl": True}),
    "max1d": ("max_pool1d", 1, {"kernel_size": 3, "stride": 2,
                                "padding": 1, "ceil_mode": True}),
    "max1d_mask": ("max_pool1d", 1, {"kernel_size": 2,
                                     "return_mask": True}),
    "max3d": ("max_pool3d", 3, {"kernel_size": 2, "stride": [1, 2, 2]}),
    "max3d_mask": ("max_pool3d", 3, {"kernel_size": 2, "return_mask": True,
                                     "cl": True}),
    "avg2d": ("avg_pool2d", 2, {"kernel_size": 3, "stride": 2,
                                "padding": 1}),
    "avg2d_inclusive": ("avg_pool2d", 2, {"kernel_size": 3, "padding": 1,
                                          "exclusive": False}),
    "avg2d_ceil": ("avg_pool2d", 2, {"kernel_size": [3, 4], "stride": 3,
                                     "ceil_mode": True}),
    "avg2d_ceil_inclusive": ("avg_pool2d", 2, {
        "kernel_size": 3, "stride": 2, "ceil_mode": True, "padding": 1,
        "exclusive": False}),
    "avg2d_lo_hi": ("avg_pool2d", 2, {"kernel_size": 2,
                                      "padding": [1, 0, 0, 1]}),
    "avg2d_same": ("avg_pool2d", 2, {"kernel_size": 3, "stride": 2,
                                     "padding": "SAME"}),
    "avg2d_divisor": ("avg_pool2d", 2, {"kernel_size": 2,
                                        "divisor_override": 3}),
    "avg2d_nhwc": ("avg_pool2d", 2, {"kernel_size": 2, "cl": True}),
    "avg1d": ("avg_pool1d", 1, {"kernel_size": 4, "stride": 3,
                                "padding": 2}),
    "avg3d": ("avg_pool3d", 3, {"kernel_size": [2, 3, 3], "padding": 1,
                                "ceil_mode": True}),
    "adaptive_avg2d": ("adaptive_avg_pool2d", 2, {"output_size": [4, 3]}),
    "adaptive_avg2d_even": ("adaptive_avg_pool2d", 2, {"output_size": [3,
                                                                       5]}),
    "adaptive_avg2d_nhwc": ("adaptive_avg_pool2d", 2, {"output_size": 4,
                                                       "cl": True}),
    "adaptive_avg1d": ("adaptive_avg_pool1d", 1, {"output_size": 4}),
    "adaptive_avg3d": ("adaptive_avg_pool3d", 3, {"output_size": [2, 4,
                                                                  3]}),
    "adaptive_max2d": ("adaptive_max_pool2d", 2, {"output_size": [4, 3],
                                                  "return_mask": True}),
    "adaptive_max1d": ("adaptive_max_pool1d", 1, {"output_size": 5}),
    "adaptive_max3d": ("adaptive_max_pool3d", 3, {"output_size": 2}),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pool(case):
    name, nd, kw = POOL[case]
    kw = dict(kw)
    x = XN[nd]
    if kw.pop("cl", False):
        x, kw["data_format"] = _cl(x), _CL[nd]
    check(getattr(JF, name), getattr(TF, name), (A(x),), kw, what=case)


POOL_LAYERS = {
    "MaxPool1D": (lambda m: m.MaxPool1D(3, 2, 1), X1),
    "MaxPool2D": (lambda m: m.MaxPool2D(3, 2, 1), X2),
    "MaxPool2D_ceil": (lambda m: m.MaxPool2D(2, ceil_mode=True), X2),
    "MaxPool3D": (lambda m: m.MaxPool3D(2), X3),
    "AvgPool1D": (lambda m: m.AvgPool1D(3, exclusive=False), X1),
    "AvgPool2D": (lambda m: m.AvgPool2D(3, 2, 1, ceil_mode=True), X2),
    "AvgPool3D": (lambda m: m.AvgPool3D(2, padding=1), X3),
    "AdaptiveAvgPool1D": (lambda m: m.AdaptiveAvgPool1D(3), X1),
    "AdaptiveAvgPool2D": (lambda m: m.AdaptiveAvgPool2D(1), X2),
    "AdaptiveAvgPool3D": (lambda m: m.AdaptiveAvgPool3D([1, 2, 3]), X3),
    "AdaptiveMaxPool1D": (lambda m: m.AdaptiveMaxPool1D(4), X1),
    "AdaptiveMaxPool2D": (lambda m: m.AdaptiveMaxPool2D([2, 7]), X2),
    "AdaptiveMaxPool3D": (lambda m: m.AdaptiveMaxPool3D(2), X3),
}


@pytest.mark.parametrize("name", sorted(POOL_LAYERS))
def test_pool_layer(name):
    build, x = POOL_LAYERS[name]
    check_layer(build(jnn), build(tnn), (A(x),), what=name)
