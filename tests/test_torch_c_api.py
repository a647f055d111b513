"""The port's C inference API (``paddle_tpu_torch/inference/csrc``) on the
CPU, against the reference's values.

The library is built here with g++ (``inference/capi.py``; a failed build
fails the test). Through ctypes: create → set input → run → get output on
an MLP saved with the reference's seed-0 weights (copied by name), as
``tests/test_c_api.py`` drives the reference's library, held against the
reference model's output (1e-5) and the port's eager model (bit for bit).
Then the ``capi_demo`` host as a subprocess (its own embedded interpreter)
on a saved MLP, as ``tests/test_portable_artifacts.py``
``test_capi_demo_binary_runs_artifact`` runs the reference's, against the
reference model on the host's ramp input (1e-4, the reference test's
bound: the host prints six decimals), and the error paths.
"""
import ctypes
import json
import os
import subprocess

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu_torch.inference import capi
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.static import InputSpec
from torch_port_util import cpu_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _models(sizes, seed):
    """(reference model, port model) with the reference's weights."""
    paddle.seed(seed)
    a, b, c = sizes
    jm = paddle.nn.Sequential(paddle.nn.Linear(a, b), paddle.nn.ReLU(),
                              paddle.nn.Linear(b, c))
    jm.eval()
    tm = tp.nn.Sequential(tp.nn.Linear(a, b), tp.nn.ReLU(),
                          tp.nn.Linear(b, c))
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    return jm, tm.eval()


def test_create_run_get_output(tmp_path):
    lib = capi.lib()
    jm, tm = _models((4, 8, 3), seed=0)
    prefix = str(tmp_path / "mlp")
    tp.static.save_inference_model(
        prefix, [InputSpec([2, 4], "float32", name="x")], tm)

    p = lib.PD_PredictorCreateOnDevice(prefix.encode(), b"cpu")
    assert p, lib.PD_LastError().decode()
    in_name = lib.PD_PredictorInputName(p, 0)
    out_name = lib.PD_PredictorOutputName(p, 0)
    assert (in_name, out_name) == (b"x", b"output_0")

    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    shape = (ctypes.c_int64 * 2)(2, 4)
    rc = lib.PD_PredictorSetInputFloat(
        p, in_name, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape,
        2)
    assert rc == 0, lib.PD_LastError().decode()
    assert lib.PD_PredictorRun(p) == 0, lib.PD_LastError().decode()
    n = lib.PD_PredictorOutputNumel(p, out_name)
    assert n == 6
    dims, ndim = (ctypes.c_int64 * 8)(), ctypes.c_int()
    assert lib.PD_PredictorOutputShape(p, out_name, dims,
                                       ctypes.byref(ndim)) == 0
    assert list(dims[:ndim.value]) == [2, 3]
    buf = (ctypes.c_float * n)()
    rc = lib.PD_PredictorGetOutputFloat(p, out_name, buf, n)
    assert rc == 0, lib.PD_LastError().decode()
    got = np.frombuffer(buf, np.float32).reshape(2, 3)
    lib.PD_PredictorDestroy(p)

    np.testing.assert_allclose(got, jm(paddle.to_tensor(x)).numpy(),
                               rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_array_equal(got, tm(torch.from_numpy(x)).numpy())


def test_error_paths(tmp_path):
    lib = capi.lib()
    assert not lib.PD_PredictorCreateOnDevice(
        str(tmp_path / "missing").encode(), b"cpu")
    assert b"not found" in lib.PD_LastError()
    _, tm = _models((4, 8, 3), seed=0)
    prefix = str(tmp_path / "mlp")
    tp.static.save_inference_model(
        prefix, [InputSpec([2, 4], "float32", name="x")], tm)
    p = lib.PD_PredictorCreateOnDevice(prefix.encode(), b"cpu")
    assert lib.PD_PredictorRun(p) == -1
    assert b"inputs not set" in lib.PD_LastError()
    buf = (ctypes.c_float * 1)()
    x = np.zeros((2, 4), np.float32)
    shape = (ctypes.c_int64 * 2)(2, 4)
    lib.PD_PredictorSetInputFloat(
        p, b"x", x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape, 2)
    assert lib.PD_PredictorRun(p) == 0
    assert lib.PD_PredictorGetOutputFloat(p, b"output_0", buf, 1) == -1
    assert b"larger than buffer" in lib.PD_LastError()
    assert not lib.PD_PredictorCreateOnDevice(prefix.encode(), b"meta")
    assert b"not cpu or cuda" in lib.PD_LastError()
    lib.PD_PredictorDestroy(p)


def test_capi_demo_binary_runs_artifact(tmp_path):
    demo = capi.build_demo()
    jm, tm = _models((6, 12, 3), seed=11)
    prefix = str(tmp_path / "net")
    tp.static.save_inference_model(prefix, [InputSpec([2, 6], "float32")],
                                   tm)
    # the ramp the C++ host feeds
    x = ((np.arange(12) % 17).astype(np.float32) * 0.25 - 2.0).reshape(2, 6)
    want = jm(paddle.to_tensor(x)).numpy()
    r = subprocess.run([str(demo), "--device", "cpu", prefix, ROOT, "2", "6"],
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["numel"] == want.size
    np.testing.assert_allclose(got["sum"], float(want.sum()), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["head"], want.ravel()[:4], rtol=1e-4,
                               atol=1e-5)
    bad = subprocess.run([str(demo), "--device", "cpu",
                          str(tmp_path / "missing"), ROOT, "2", "6"],
                         capture_output=True, text=True, timeout=240)
    assert bad.returncode == 1 and "not found" in bad.stderr
