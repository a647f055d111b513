"""Port parity: the ``FLAGS_check_nan_inf`` scan (``paddle_tpu_torch.core.
dispatch``) against the reference's (``paddle_tpu/core/dispatch.py``
``_check_nan_inf``, read by ``eager_call``).

The reference checks its eager ops and its eager ``Optimizer.step()``; its
``CompiledTrainStep`` is traced, and with the flag set every call raises
jax's ``TracerBoolConversionError``. Each reach is driven in both packages
on the same weights: both must raise, or neither. The message carries the
reference's fields (shape, dtype, count, first flat index and value, the
flag), the op names are ATen's, and each trip writes a ``naninf`` flight
dump with the reference's ``extra`` keys and bumps ``naninf_trips``.
"""
import json
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import flags as jflags
import paddle_tpu_torch as tp
from paddle_tpu_torch.core import dispatch
from torch_port_util import cpu_device

MSG = re.compile(
    r"Operator '(?P<op>[^']+)' output (?P<idx>\d+) \(shape=(?P<shape>\([^)]*"
    r"\)), dtype=(?P<dtype>\w+)\) contains (?P<cnt>\d+) non-finite "
    r"value\(s\); first at flat index (?P<flat>-?\d+) = (?P<first>\S+) "
    r"\[(?P<origin>[^\]]+)\] \(FLAGS_check_nan_inf is set\)\.")


@pytest.fixture
def scan(tmp_path, monkeypatch):
    """The flag set in both packages for the test, cleared after it; flight
    dumps go under tmp_path."""
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))

    def on(value=True):
        jflags._FLAGS["FLAGS_check_nan_inf"] = value
        tp.set_flags({"FLAGS_check_nan_inf": value})

    try:
        yield on
    finally:
        on(False)
        assert not dispatch.scan_active()


def _weights(nan=True):
    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    if nan:
        w[1, 2] = np.nan
    return w, rng.randn(2, 4).astype(np.float32)


def _linears(w):
    jl = paddle.nn.Linear(4, 3)
    jl.weight.set_value(w)
    with cpu_device():
        tl = tp.nn.Linear(4, 3)
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.zero_()
    jl.bias.set_value(np.zeros(3, np.float32))
    return jl, tl


def _outcome(fn):
    try:
        fn()
    except Exception as e:  # the outcome is the exception's type
        return e
    return None


@pytest.mark.parametrize("nan", [True, False], ids=["nan", "finite"])
def test_eager_forward_raises_in_both_or_neither(scan, nan):
    w, x = _weights(nan)
    jl, tl = _linears(w)
    scan()
    je = _outcome(lambda: jl(paddle.to_tensor(x)).numpy())
    te = _outcome(lambda: tl(torch.from_numpy(x)))
    if not nan:
        assert je is None and te is None
        return
    assert isinstance(je, FloatingPointError)
    assert isinstance(te, FloatingPointError)
    jm, tm = MSG.fullmatch(str(je).split(" Set FLAGS")[0]), MSG.fullmatch(
        str(te))
    assert jm and tm, (str(je), str(te))
    # x @ w has NaN in column 2 of both rows: same output, shape, count,
    # first index and value; the op's name and the origin are each
    # package's own
    for k in ("idx", "shape", "dtype", "cnt", "flat", "first"):
        assert jm[k] == tm[k], (k, jm[k], tm[k])
    assert tm["origin"] == "eager" and tm["op"].startswith("aten.")


def test_eager_optimizer_step_raises_in_both(scan):
    w, x = _weights(nan=False)
    jl, tl = _linears(w)
    jopt = paddle.optimizer.SGD(0.1, parameters=jl.parameters())
    topt = tp.optimizer.SGD(0.1, parameters=tl.parameters())
    jl(paddle.to_tensor(x)).sum().backward()
    tl(torch.from_numpy(x)).sum().backward()
    jl.weight.grad = paddle.to_tensor(np.full((4, 3), np.nan, np.float32))
    tl.weight.grad = torch.full((4, 3), float("nan"))
    scan()
    je = _outcome(lambda: (jopt.step(), jl.weight.numpy()))
    te = _outcome(topt.step)
    assert isinstance(je, FloatingPointError), je
    assert isinstance(te, FloatingPointError), te
    assert MSG.fullmatch(str(te))["shape"] == "(4, 3)"


@pytest.mark.parametrize("nan", [True, False], ids=["nan", "finite"])
def test_compiled_train_step_raises_in_both(scan, nan):
    """The reference's traced step cannot be scanned: with the flag set it
    raises a TypeError (jax's TracerBoolConversionError) whatever the
    values, and so does the port's."""
    w, x = _weights(nan)
    jl, tl = _linears(w)
    jstep = paddle.jit.compile_train_step(
        jl, lambda m, a: m(a).sum(), paddle.optimizer.SGD(0.1,
                                                          parameters=jl.parameters()))
    tstep = tp.jit.compile_train_step(
        tl, lambda m, a: m(a).sum(), tp.optimizer.SGD(0.1,
                                                      parameters=tl.parameters()))
    scan()
    je = _outcome(lambda: jstep(paddle.to_tensor(x)))
    te = _outcome(lambda: tstep(torch.from_numpy(x)))
    assert isinstance(je, TypeError), je
    assert isinstance(te, TypeError), te
    scan(False)
    assert _outcome(lambda: tstep(torch.from_numpy(x))) is None


def test_dump_counter_and_message(scan, tmp_path):
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import flight

    before = profiler.counters().get("naninf_trips", 0)
    scan()
    a = torch.tensor([[1.0, 2.0], [float("inf"), float("nan")]])
    with pytest.raises(FloatingPointError) as ei:
        a * 2.0
    m = MSG.fullmatch(str(ei.value))
    assert m["op"] == "aten.mul.Tensor" and m["shape"] == "(2, 2)"
    assert (m["cnt"], m["flat"], m["first"]) == ("2", "2", "np.float32(inf)")
    assert profiler.counters()["naninf_trips"] == before + 1
    path = flight.last_dump()
    assert path and path.startswith(str(tmp_path)) and "naninf" in path
    doc = json.load(open(path))
    assert doc["reason"] == "naninf"
    assert set(doc["extra"]) >= {"op", "output", "origin", "nonfinite_count",
                                 "first_flat_index", "message"}
    assert doc["extra"]["message"] == str(ei.value)
    # bf16 outputs are scanned too; integer outputs never are
    with pytest.raises(FloatingPointError, match="dtype=bfloat16"):
        torch.full((3,), float("nan"), dtype=torch.bfloat16) + 1
    torch.arange(4) * 3


def test_no_mode_on_the_stack_with_the_flag_off(scan):
    assert not dispatch.scan_active()
    scan()
    assert dispatch.scan_active()
    tp.set_flags({"FLAGS_check_nan_inf_per_op": True})  # accepted, no effect
    scan(False)
    tp.set_flags({"FLAGS_check_nan_inf_per_op": False})
    assert not dispatch.scan_active()
    assert torch.isnan(torch.tensor([float("nan")]) * 1).all()
