"""``inference`` (``paddle_tpu_torch/inference``) against the reference's
(``paddle_tpu/inference/__init__.py``), on the CPU, float32.

The 8 cases of ``tests/test_inference.py``: the artifact is saved by both
packages from the same weights (copied by name) with a dynamic batch, and
the port's Predictor (``Config.disable_gpu()``: the port's Config defaults
to the card) is held against the reference's Predictor on the same inputs
(1e-5) and against the live model (bit for bit: the same ATen ops); the
handle and list APIs, clones on threads sharing one loaded program, one
predictor shared by two threads, the error paths. Then what the port adds:
``share_external_data`` takes a tensor on the predictor's device without a
copy, ``enable_use_gpu``/``enable_tpu`` select ``cuda:<id>``, and a
predictor on the card raises here, where there is none.
"""
import os
import tempfile
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.inference import Config as JConfig
from paddle_tpu.inference import create_predictor as jcreate
from paddle_tpu_torch.inference import Config, Predictor, create_predictor
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.static import InputSpec
from torch_port_util import cpu_device

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _net(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(16, 32), pkg.nn.ReLU(),
                             pkg.nn.Linear(32, 4))


@pytest.fixture(scope="module")
def saved_model():
    """(port prefix, reference prefix, port model) from the same weights."""
    paddle.seed(7)
    jlin = _net(paddle)
    jlin.eval()
    with cpu_device():
        lin = _net(tp)
        load_reference_state_dict(lin, {k: np.asarray(v.numpy())
                                        for k, v in jlin.state_dict().items()})
        lin.eval()
        d = tempfile.mkdtemp()
        tp.static.save_inference_model(
            os.path.join(d, "model"),
            [InputSpec([None, 16], "float32", name="feat")], lin)
    paddle.static.save_inference_model(
        os.path.join(d, "ref"),
        [paddle.static.InputSpec([None, 16], "float32", name="feat")], jlin)
    return os.path.join(d, "model"), os.path.join(d, "ref"), lin


def _cpu_config(prefix):
    cfg = Config(prefix)
    cfg.disable_gpu()
    return cfg


def _live(lin, x):
    with torch.no_grad():
        return lin(torch.from_numpy(x)).numpy()


def _ref_run(ref_prefix, x):
    return jcreate(JConfig(ref_prefix)).run([x])[0]


def test_config_surface(saved_model):
    prefix, ref, _ = saved_model
    for cls, p in ((Config, prefix), (JConfig, ref)):
        cfg = cls(p + ".pdmodel")
        assert cfg.model_dir() == p
        assert cfg.prog_file().endswith(".pdmodel")
        assert cfg.params_file() == p + ".pdiparams"
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(True)
        assert cfg.use_gpu()  # the port's card, the reference's TPU
        cfg.disable_gpu()
        assert not cfg.use_gpu()
        assert "Config(" in cfg.summary()
    cfg = Config(prefix)
    assert cfg.device() == torch.device("cuda", 0)
    cfg.enable_use_gpu(device_id=1)
    assert cfg.device() == torch.device("cuda", 1)
    cfg.enable_tpu(device_id=2)
    assert cfg.device() == torch.device("cuda", 2) and cfg.use_gpu()
    cfg.disable_gpu()
    assert cfg.device() == torch.device("cpu")


def test_predictor_handles(saved_model):
    prefix, ref, lin = saved_model
    pred = create_predictor(_cpu_config(prefix))
    jpred = jcreate(JConfig(ref))
    assert pred.get_input_names() == jpred.get_input_names() == ["feat"]
    assert pred.get_output_names() == jpred.get_output_names() \
        == ["output_0"]
    x = np.random.RandomState(0).randn(3, 16).astype(np.float32)
    for p in (pred, jpred):
        p.get_input_handle("feat").copy_from_cpu(x)
        assert p.run() is True
    out = pred.get_output_handle("output_0").copy_to_cpu()
    want = jpred.get_output_handle("output_0").copy_to_cpu()
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_array_equal(out, _live(lin, x))
    assert pred.get_output_handle("output_0").shape() == [3, 4]
    assert pred.get_output_handle("output_0").type() == "float32"


def test_predictor_list_api_dynamic_batch(saved_model):
    prefix, ref, lin = saved_model
    pred = create_predictor(_cpu_config(prefix))
    for bs in (1, 6):
        x = np.random.RandomState(bs).randn(bs, 16).astype(np.float32)
        outs = pred.run([x])
        np.testing.assert_allclose(outs[0], _ref_run(ref, x), **TOL)
        np.testing.assert_array_equal(outs[0], _live(lin, x))


def test_predictor_clone_threads(saved_model):
    prefix, ref, lin = saved_model
    pred = create_predictor(_cpu_config(prefix))
    clones = [pred.clone() for _ in range(4)]
    assert all(c._call is pred._call and c._weights is pred._weights
               for c in clones)  # one loaded program and one set of weights
    xs = [np.random.RandomState(10 + i).randn(2, 16).astype(np.float32)
          for i in range(4)]
    errs = [None] * 4

    def work(i):
        errs[i] = float(np.abs(clones[i].run([xs[i]])[0]
                               - _live(lin, xs[i])).max())

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert errs == [0.0] * 4
    for x in xs:
        np.testing.assert_allclose(_live(lin, x), _ref_run(ref, x), **TOL)


def test_shared_predictor_concurrent_list_api(saved_model):
    """ONE predictor (no clones) from two threads through the list API:
    ``run()`` stages, executes and returns under one ``_lock`` hold."""
    prefix, _, lin = saved_model
    pred = create_predictor(_cpu_config(prefix))
    errs = []
    xs = [np.random.RandomState(s).randn(2, 16).astype(np.float32)
          for s in range(2)]

    def work(x):
        try:
            for _ in range(20):
                out = pred.run([x])[0]
                assert np.array_equal(out, _live(lin, x))
        except Exception as e:  # surfaced to the main thread below
            errs.append(e)

    threads = [threading.Thread(target=work, args=(x,)) for x in xs]
    [t.start() for t in threads]
    [t.join() for t in threads]
    assert not errs, errs


def test_error_paths(saved_model):
    prefix, _, _ = saved_model
    with pytest.raises(ValueError, match="not found"):
        Predictor(_cpu_config(os.path.join(tempfile.mkdtemp(), "missing")))
    pred = create_predictor(_cpu_config(prefix))
    with pytest.raises(RuntimeError, match="inputs not set"):
        pred.run()
    with pytest.raises(RuntimeError, match="output handle"):
        pred.get_output_handle("output_0").copy_from_cpu(
            np.zeros((1, 16), np.float32))
    with pytest.raises(RuntimeError, match="input handle"):
        pred.get_input_handle("feat").copy_to_cpu()
    with pytest.raises(ValueError, match="expects 1 inputs"):
        pred.run([np.zeros((1, 16), np.float32)] * 2)


def test_save_inference_model_requires_callable(tmp_path):
    with pytest.raises(TypeError):
        tp.static.save_inference_model(
            str(tmp_path / "x"), [InputSpec([1, 4], "float32")],
            fetch_vars=[1, 2])


def test_load_inference_model(saved_model):
    prefix, ref, lin = saved_model
    layer = tp.static.load_inference_model(prefix, device="cpu")
    jlayer = paddle.static.load_inference_model(ref)
    x = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _live(lin, x))
    np.testing.assert_allclose(
        got, np.asarray(jlayer(paddle.to_tensor(x))._data), **TOL)


def test_share_external_data_takes_the_tensor_without_a_copy(saved_model):
    prefix, _, lin = saved_model
    pred = create_predictor(_cpu_config(prefix))
    x = torch.randn(5, 16, generator=torch.Generator().manual_seed(4))
    pred.get_input_handle("feat").share_external_data(x)
    assert pred._inputs[0] is x
    pred.run()
    (out,) = pred.output_tensors()
    assert out.device == x.device
    np.testing.assert_array_equal(out.numpy(), _live(lin, x.numpy()))


def test_the_default_config_is_the_card(saved_model):
    """The default Config runs on cuda:0; with no card it raises (no quiet
    fallback to the CPU)."""
    prefix, _, _ = saved_model
    if torch.cuda.is_available():
        assert create_predictor(Config(prefix)).device == \
            torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError):
            create_predictor(Config(prefix))
