"""The port's interop and deployment odds and ends against the reference's:
``utils.dlpack`` across packages, ``device`` and the places, ``hub`` over
a local ``hubconf.py``, and ``onnx.export``."""
import numpy as np
import pytest
import torch

import paddle_tpu
import jax.numpy as jnp

import paddle_tpu_torch as tp
from paddle_tpu_torch import device as pdevice
from paddle_tpu_torch.utils import dlpack
from torch_port_util import cpu_device


# -- dlpack -------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 4)])
def test_dlpack_into_jax_and_the_reference(shape):
    a = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    t = torch.from_numpy(a.copy())
    j = jnp.from_dlpack(dlpack.to_dlpack(t))
    assert j.dtype == jnp.float32 and j.shape == shape
    np.testing.assert_array_equal(np.asarray(j), a)
    r = paddle_tpu.utils.dlpack.from_dlpack(dlpack.to_dlpack(t))
    np.testing.assert_array_equal(np.asarray(r.numpy()), a)


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.int32])
def test_dlpack_from_the_reference_into_the_port(dtype):
    a = (np.arange(12).reshape(3, 4) * 3 - 7).astype(dtype)
    src = paddle_tpu.to_tensor(a)
    got = dlpack.from_dlpack(paddle_tpu.utils.dlpack.to_dlpack(src))
    assert isinstance(got, torch.Tensor) and not got.requires_grad
    assert got.numpy().dtype == a.dtype
    np.testing.assert_array_equal(got.numpy(), a)


def test_dlpack_is_zero_copy_on_the_host():
    t = torch.arange(6, dtype=torch.float32, requires_grad=True)
    view = dlpack.to_dlpack(t)
    back = dlpack.from_dlpack(view)
    assert back.data_ptr() == t.data_ptr() and not back.requires_grad
    n = np.from_dlpack(dlpack.to_dlpack(t))
    back[1] = 40.0  # a write through one view is seen through the others
    assert t[1].item() == 40.0 and n[1] == 40.0
    with cpu_device():
        from_np = dlpack.to_dlpack(np.ones(3, np.float32))
    assert dlpack.from_dlpack(from_np).tolist() == [1.0, 1.0, 1.0]


# -- device and places --------------------------------------------------------
def test_device_functions_on_the_host():
    import paddle_tpu.device as jdev

    if torch.cuda.is_available():
        pytest.skip("the host-only listing needs a machine without CUDA")
    # the reference's test session splits the host into 8 virtual devices;
    # the port has one host device
    assert pdevice.get_available_device() == ["cpu:0"] \
        == jdev.get_available_device()[:1]
    assert pdevice.get_all_device_type() == jdev.get_all_device_type() \
        == ["cpu"]
    assert pdevice.device_count() == pdevice.device_count("cpu") == 1
    assert pdevice.device_count("gpu") == jdev.device_count("gpu") == 0
    assert pdevice.cuda.device_count() == 0
    with cpu_device():
        pdevice.synchronize()  # the host: nothing to wait for
        assert pdevice.get_device() == "cpu:0"
    with pytest.raises(RuntimeError, match="CUDA"):
        pdevice.synchronize()  # the card by default: raises without one


@pytest.mark.parametrize("name", ["IPUPlace", "MLUPlace", "NPUPlace",
                                  "XPUPlace", "CustomPlace"])
def test_unavailable_places_raise(name):
    for mod in (tp, paddle_tpu):
        with pytest.raises(RuntimeError, match="not available"):
            getattr(mod, name)(0)


def test_places_and_staples():
    p = tp.CUDAPinnedPlace()
    assert isinstance(p, tp.CPUPlace) and p.torch_device().type == "cpu"
    assert tp.is_compiled_with_tpu() is False
    assert isinstance(torch.float32, tp.dtype)
    assert isinstance(tp.float32, tp.dtype)
    v = tp.get_cudnn_version()
    assert v == torch.backends.cudnn.version()
    assert v is None or isinstance(v, int)
    assert tp.DataLoader is tp.io.DataLoader
    assert tp.ParameterList is tp.nn.ParameterList
    st = tp.get_rng_state()
    tp.set_rng_state(st)
    assert set(tp.program_rng.state_dict()) == {"seed", "devices"}


# -- hub ----------------------------------------------------------------------
HUBCONF = '''
"""A local model repository."""
import numpy as np


def tiny(scale=1.0):
    """A tiny model: y = scale * x."""
    return ("tiny", scale)


def _private():
    return None


helper_value = 3
'''


def test_hub_local_equals_the_reference(tmp_path):
    (tmp_path / "hubconf.py").write_text(HUBCONF)
    d = str(tmp_path)
    assert tp.hub.list(d) == paddle_tpu.hub.list(d) == ["tiny"]
    assert tp.hub.help(d, "tiny") == paddle_tpu.hub.help(d, "tiny")
    assert tp.hub.load(d, "tiny", scale=2.0) == ("tiny", 2.0)
    with pytest.raises(NotImplementedError):
        tp.hub.load(d, "tiny", source="github")
    with pytest.raises(FileNotFoundError):
        tp.hub.list(str(tmp_path / "missing"))


def test_hub_builds_a_port_model(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "import paddle_tpu_torch as tp\n\n\n"
        "def mlp(seed=0):\n"
        "    tp.seed(seed)\n"
        "    return tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),\n"
        "                            tp.nn.Linear(8, 2))\n")
    with cpu_device():
        a = tp.hub.load(str(tmp_path), "mlp", seed=3)
        tp.seed(3)
        b = tp.nn.Sequential(tp.nn.Linear(4, 8), tp.nn.ReLU(),
                             tp.nn.Linear(8, 2))
        x = torch.from_numpy(np.random.RandomState(0).randn(3, 4)
                             .astype(np.float32))
        assert torch.equal(a(x), b(x))


# -- onnx ---------------------------------------------------------------------
def _mlp():
    tp.seed(0)
    return tp.nn.Sequential(tp.nn.Linear(6, 16), tp.nn.GELU(),
                            tp.nn.Linear(16, 3))


@pytest.mark.parametrize("suffix", ["", ".onnx"])
def test_onnx_export_is_the_jit_artifact(tmp_path, suffix):
    with cpu_device():
        m = _mlp().eval()
        spec = [tp.static.InputSpec([None, 6], "float32", "x")]
        prefix = tp.onnx.export(m, str(tmp_path / "m") + suffix,
                                input_spec=spec)
        assert prefix == str(tmp_path / "m")
        assert (tmp_path / "m.pdmodel").is_file()
        assert (tmp_path / "m.pdiparams").is_file()
        x = torch.from_numpy(np.random.RandomState(1).randn(5, 6)
                             .astype(np.float32))
        got = tp.jit.load(prefix, device="cpu")(x)
        assert torch.equal(got, m(x))


def test_onnx_format_raises(tmp_path):
    with cpu_device():
        m = _mlp()
    with pytest.raises(NotImplementedError, match="ONNX"):
        tp.onnx.export(m, str(tmp_path / "m.onnx"), format="onnx")
    with pytest.raises(NotImplementedError):
        paddle_tpu.onnx.export(None, str(tmp_path / "j"), format="onnx")
    with pytest.raises(ValueError):
        tp.onnx.export(m, str(tmp_path / "m"), format="tflite")
