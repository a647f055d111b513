"""Port parity of ``paddle_tpu_torch.fft`` and ``paddle_tpu_torch.signal``
against the JAX package's, on the same numpy inputs from a seed.

Each of the 18 fft functions in float32; the 1-d and 2-d transforms also
in float64 and bfloat16 (a half input is computed in float32, as
``jnp.fft`` promotes it: its output is held, dtype by name, to the
reference on the same values in float32, since the reference's real
transforms refuse bfloat16). float outputs rtol 1e-5 with atol 1e-5
(float64 1e-10), complex outputs by absolute error at the same atol. ``frame``, ``overlap_add``, ``stft`` and
``istft`` on both axes and with and without ``center``, a window shorter
than ``n_fft``, ``normalized`` and two-sided; the ``stft``/``istft`` round
trip within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fft as RF
import paddle_tpu.signal as RSG
import paddle_tpu_torch as tp
import paddle_tpu_torch.fft as PF
import paddle_tpu_torch.signal as PSG
from torch_port_util import assert_same, cpu_device, flat_outputs


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
X = _R.randn(3, 8).astype(np.float32)
X3 = _R.randn(2, 4, 6).astype(np.float32)
C = (_R.randn(3, 8) + 1j * _R.randn(3, 8)).astype(np.complex64)
SIG = _R.randn(2, 300).astype(np.float32)
HANN = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(64) / 64)).astype(
    np.float32)


class A:
    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    return pkg.to_tensor(v.a) if isinstance(v, A) else v


FFT = {
    "fft": ("fft", [A(X)], {}),
    "fft_n_ortho": ("fft", [A(X)], {"n": 6, "norm": "ortho"}),
    "ifft": ("ifft", [A(C)], {"axis": 0}),
    "rfft": ("rfft", [A(X)], {"norm": "forward"}),
    "irfft": ("irfft", [A(C)], {"n": 14}),
    "hfft": ("hfft", [A(C)], {}),
    "ihfft": ("ihfft", [A(X)], {}),
    "fft2": ("fft2", [A(X3)], {}),
    "ifft2": ("ifft2", [A(X3)], {"axes": (0, 2)}),
    "rfft2": ("rfft2", [A(X3)], {"s": (4, 4)}),
    "irfft2": ("irfft2", [A(C)], {}),
    "fftn": ("fftn", [A(X3)], {}),
    "ifftn": ("ifftn", [A(X3)], {"axes": (0, 1, 2)}),
    "rfftn": ("rfftn", [A(X3)], {}),
    "irfftn": ("irfftn", [A(C)], {}),
    "fftshift": ("fftshift", [A(X)], {}),
    "ifftshift": ("ifftshift", [A(X)], {"axes": 1}),
    "fftfreq": ("fftfreq", [7], {"d": 0.5}),
    "rfftfreq": ("rfftfreq", [8], {}),
}


def test_every_reference_function_has_a_case():
    assert {c[0] for c in FFT.values()} == set(RF.__all__) == set(PF.__all__)
    assert set(RSG.__all__) == set(PSG.__all__)


def _both(mod_r, mod_p, name, args, kw):
    want = flat_outputs(getattr(mod_r, name)(*[_conv(paddle, a)
                                               for a in args], **kw))
    got = flat_outputs(getattr(mod_p, name)(*[_conv(tp, a) for a in args],
                                            **kw))
    assert len(got) == len(want)
    return got, want


@pytest.mark.parametrize("case", sorted(FFT))
def test_fft_matches_reference(case):
    got, want = _both(RF, PF, *FFT[case])
    for g, w in zip(got, want):
        assert_same(g, w, atol=1e-5, what=case)


@pytest.mark.parametrize("name", ["fft", "rfft", "ifft", "fft2", "rfft2"])
@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_fft_dtype_rules(name, dtype):
    src = X3 if name.endswith("2") else X
    tx = tp.to_tensor(src).to(getattr(torch, dtype))
    jx = paddle.to_tensor(src).astype(dtype)
    if dtype == "bfloat16":
        jx = jx.astype("float32")
    want, got = getattr(RF, name)(jx), getattr(PF, name)(tx)
    assert_same(got, want, rtol=1e-5,
                atol=1e-10 if dtype == "float64" else 1e-5, what=name)


SIGNAL = {
    "frame": ("frame", [A(SIG), 64, 16], {}),
    "frame_axis0": ("frame", [A(SIG.T.copy()), 64, 32], {"axis": 0}),
    "overlap_add": ("overlap_add", [A(_R.randn(2, 64, 9).astype(np.float32)),
                                    16], {}),
    "overlap_add_axis0": ("overlap_add",
                          [A(_R.randn(9, 64, 2).astype(np.float32)), 16],
                          {"axis": 0}),
    "stft": ("stft", [A(SIG), 64], {"hop_length": 16, "window": A(HANN)}),
    "stft_no_center": ("stft", [A(SIG), 64], {"center": False}),
    "stft_short_window_norm": ("stft", [A(SIG), 64], {
        "hop_length": 20, "win_length": 48, "window": A(HANN[:48]),
        "normalized": True}),
    "stft_two_sided_constant": ("stft", [A(SIG), 32], {
        "onesided": False, "pad_mode": "constant"}),
    "istft": ("istft", [A((_R.randn(2, 33, 20)
                           + 1j * _R.randn(2, 33, 20)).astype(np.complex64)),
                        64], {"hop_length": 16, "window": A(HANN)}),
}


@pytest.mark.parametrize("case", sorted(SIGNAL))
def test_signal_matches_reference(case):
    name, args, kw = SIGNAL[case]
    kw_r = {k: _conv(paddle, v) for k, v in kw.items()}
    kw_p = {k: _conv(tp, v) for k, v in kw.items()}
    want = getattr(RSG, name)(*[_conv(paddle, a) for a in args], **kw_r)
    got = getattr(PSG, name)(*[_conv(tp, a) for a in args], **kw_p)
    assert_same(got, want, rtol=1e-5, atol=1e-5, what=case)


def test_stft_istft_round_trip():
    x = tp.to_tensor(SIG[:, :288])  # a whole number of hops
    w = tp.to_tensor(HANN)
    spec = PSG.stft(x, 64, hop_length=16, window=w)
    back = PSG.istft(spec, 64, hop_length=16, window=w, length=288)
    rel = float((back - x).norm() / x.norm())
    assert back.shape == x.shape and rel < 1e-5, rel
