"""Port parity: ``paddle_tpu_torch.save``/``load`` against the reference's
``paddle_tpu.save``/``load``.

A file written by either package loads in the other bit for bit: float32,
bfloat16 (raw bytes), int64 and bool tensors, ``Parameter`` names and
``stop_gradient``, nested dicts, lists and tuples with plain values, and an
optimizer's ``state_dict``. The reference's legacy ``_TensorPayload``
pickles load in a process that never imports ``paddle_tpu``.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.framework import io as jio

import paddle_tpu_torch as pt
from paddle_tpu_torch.framework import io as tio
from torch_port_util import cpu_device

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.RandomState(12)
F32 = RNG.standard_normal((3, 4)).astype(np.float32)
BF = RNG.standard_normal((2, 5)).astype(np.float32)  # rounded to bf16 below
I64 = RNG.randint(-9, 9, (4,)).astype(np.int64)
MASK = RNG.rand(6) < 0.5


def _bits16(a):
    """bfloat16 values as their 16-bit patterns (numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _ref_tree():
    w = JParameter(F32)
    w.name = "linear_0.w_0"
    frozen = JParameter(F32 * 2, trainable=False)
    frozen.name = "frozen_0"
    return {
        "w": w, "frozen": frozen,
        "bf": paddle.to_tensor(BF).astype("bfloat16"),
        "ids": paddle.to_tensor(I64),
        "mask": paddle.to_tensor(MASK),
        "nested": [paddle.to_tensor(F32[0]), (3, "x", {"k": 1.5})],
        "epoch": 7,
    }


def _port_tree():
    w = pt.Parameter(torch.from_numpy(F32.copy()), name="linear_0.w_0")
    frozen = pt.Parameter(torch.from_numpy(F32 * 2), name="frozen_0",
                          trainable=False)
    return {
        "w": w, "frozen": frozen,
        "bf": torch.from_numpy(BF).to(torch.bfloat16),
        "ids": torch.from_numpy(I64.copy()),
        "mask": torch.from_numpy(MASK.copy()),
        "nested": [torch.from_numpy(F32[0].copy()), (3, "x", {"k": 1.5})],
        "epoch": 7,
    }


def _check_port_tree(o):
    assert isinstance(o["w"], pt.Parameter) and o["w"].name == "linear_0.w_0"
    assert not o["w"].stop_gradient and o["frozen"].stop_gradient
    assert o["frozen"].name == "frozen_0"
    np.testing.assert_array_equal(o["w"].detach().numpy(), F32)
    assert o["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits16(o["bf"]), _bits16(torch.from_numpy(BF).to(torch.bfloat16)))
    assert o["ids"].dtype == torch.int64 and o["ids"].tolist() == I64.tolist()
    assert o["mask"].dtype == torch.bool
    assert o["mask"].tolist() == MASK.tolist()
    np.testing.assert_array_equal(o["nested"][0].numpy(), F32[0])
    assert o["nested"][1] == (3, "x", {"k": 1.5}) and o["epoch"] == 7
    assert all(t.device.type == "cpu" for t in (o["w"], o["ids"]))


def test_reference_file_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref.pdparams")
    paddle.save(_ref_tree(), path)
    with cpu_device():
        _check_port_tree(pt.load(path))


def test_port_file_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port.pdparams")
    pt.save(_port_tree(), path)
    o = paddle.load(path)
    assert o["w"].name == "linear_0.w_0" and not o["w"].stop_gradient
    assert o["frozen"].stop_gradient and type(o["w"]).__name__ == "Parameter"
    np.testing.assert_array_equal(np.asarray(o["w"].numpy()), F32)
    assert str(o["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        _bits16(o["bf"].numpy()),
        _bits16(torch.from_numpy(BF).to(torch.bfloat16)))
    np.testing.assert_array_equal(np.asarray(o["ids"].numpy()), I64)
    np.testing.assert_array_equal(np.asarray(o["mask"].numpy()), MASK)
    assert o["nested"][1] == (3, "x", {"k": 1.5}) and o["epoch"] == 7


def test_port_record_is_the_reference_record(tmp_path):
    """The pickled records themselves are equal, key for key."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    paddle.save(_ref_tree(), a)
    pt.save(_port_tree(), b)
    with open(a, "rb") as f:
        ra = pickle.load(f)
    with open(b, "rb") as f:
        rb = pickle.load(f)
    for k in ("w", "frozen", "bf", "ids", "mask"):
        assert set(ra[k]) == set(rb[k]), k
        for field in ra[k]:
            va, vb = ra[k][field], rb[k][field]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
            elif field != "name" or k in ("w", "frozen"):
                assert va == vb, (k, field)


def test_optimizer_state_round_trips_both_ways(tmp_path):
    w0 = RNG.standard_normal((4, 3)).astype(np.float32)
    g = RNG.standard_normal((4, 3)).astype(np.float32)
    jw = JParameter(w0.copy())
    jw.name = "w"
    jopt = paddle.optimizer.Adam(1e-2, parameters=[jw])
    (jw * paddle.to_tensor(g)).sum().backward()
    jopt.step()
    tw = pt.Parameter(torch.from_numpy(w0.copy()), name="w")
    topt = pt.optimizer.Adam(1e-2, parameters=[tw])
    (tw * torch.from_numpy(g)).sum().backward()
    topt.step()
    jpath, tpath = str(tmp_path / "j.pdopt"), str(tmp_path / "t.pdopt")
    paddle.save(jopt.state_dict(), jpath)
    pt.save(topt.state_dict(), tpath)
    with cpu_device():
        from_ref = pt.load(jpath)
    from_port = paddle.load(tpath)
    want = topt.state_dict()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_allclose(from_ref[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(
                np.asarray(from_port[k].numpy()), v.numpy())
    with cpu_device():
        fresh = pt.optimizer.Adam(1e-2, parameters=[
            pt.Parameter(torch.from_numpy(w0.copy()), name="w")])
        fresh.set_state_dict(pt.load(tpath))
    for k, v in fresh.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[k]), k


def test_return_numpy(tmp_path):
    path = str(tmp_path / "x")
    paddle.save(_ref_tree(), path)
    o = pt.load(path, return_numpy=True)
    assert isinstance(o["w"], np.ndarray) and o["w"].dtype == np.float32
    np.testing.assert_array_equal(o["w"], F32)
    # bfloat16 comes back as float32, exactly
    np.testing.assert_array_equal(
        o["bf"], torch.from_numpy(BF).to(torch.bfloat16).float().numpy())
    assert o["ids"].dtype == np.int64


def test_load_without_a_place_raises_when_cuda_missing(tmp_path, monkeypatch):
    path = str(tmp_path / "x")
    pt.save({"a": torch.ones(2)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.load(path)


def test_save_is_atomic_and_refuses_foreign_classes(tmp_path):
    path = str(tmp_path / "sub" / "x")
    pt.save({"a": torch.ones(2)}, path)
    assert os.listdir(tmp_path / "sub") == ["x"]  # no tmp left behind
    with open(path, "wb") as f:
        pickle.dump(paddle.to_tensor(F32), f)  # a reference Tensor object
    with pytest.raises(pickle.UnpicklingError, match="paddle_tpu"):
        pt.load(path)


def _legacy_payload(arr, dtype_name, is_param, name, stop_gradient):
    p = jio._TensorPayload.__new__(jio._TensorPayload)
    p.dtype_name = dtype_name
    if dtype_name == "bfloat16":
        p.buf = np.asarray(arr).tobytes()
        p.shape = tuple(arr.shape)
    else:
        p.array = arr
    p.is_param, p.name, p.stop_gradient = is_param, name, stop_gradient
    return p


def test_legacy_payload_loads_without_importing_the_reference(tmp_path):
    bf = paddle.to_tensor(BF).astype("bfloat16").numpy()
    path = str(tmp_path / "legacy.pdparams")
    with open(path, "wb") as f:
        pickle.dump({
            "w": _legacy_payload(F32, "float32", True, "fc.w", False),
            "bf": _legacy_payload(bf, "bfloat16", False, "t", True)}, f)
    # the reference reads its own legacy file
    ref = paddle.load(path)
    np.testing.assert_array_equal(np.asarray(ref["w"].numpy()), F32)
    code = (
        "import sys, numpy as np, torch, paddle_tpu_torch as pt\n"
        "pt.set_device('cpu')\n"
        f"o = pt.load({path!r})\n"
        "assert isinstance(o['w'], pt.Parameter) and o['w'].name == 'fc.w'\n"
        "assert not o['w'].stop_gradient\n"
        "assert o['bf'].dtype == torch.bfloat16\n"
        "np.save(sys.argv[1], o['w'].detach().numpy())\n"
        "np.save(sys.argv[2], o['bf'].view(torch.int16).numpy())\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('paddle_tpu', 'jax')]\n"
        "assert not bad, bad\n")
    w_out, bf_out = str(tmp_path / "w.npy"), str(tmp_path / "bf.npy")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code, w_out, bf_out],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    np.testing.assert_array_equal(np.load(w_out), F32)
    np.testing.assert_array_equal(np.load(bf_out), _bits16(bf))


def test_save_of_a_model_state_dict_round_trips(tmp_path):
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

    m = GPTForPretraining(gpt_tiny(), device="cpu")
    path = str(tmp_path / "model.pdparams")
    pt.save(m.state_dict(), path)
    with cpu_device():
        sd = pt.load(path)
    fresh = GPTForPretraining(gpt_tiny(), device="cpu", seed=1)
    fresh.set_state_dict(sd)
    for (n, a), (_, b) in zip(m.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n


def test_generator_state_round_trips_through_a_checkpoint(tmp_path):
    """``core.random.get_rng_state`` saved with ``save`` and restored with
    ``set_rng_state`` replays the same dropout mask."""
    from paddle_tpu_torch.core import random as random_state
    from paddle_tpu_torch.nn.functional import dropout

    x = torch.ones(64)
    pt.seed(4)
    dropout(x, 0.5)
    path = str(tmp_path / "rng")
    pt.save({"rng": random_state.get_rng_state()}, path)
    want = dropout(x, 0.5)
    dropout(x, 0.5)
    with cpu_device():
        random_state.set_rng_state(pt.load(path)["rng"])
    assert torch.equal(dropout(x, 0.5), want)
