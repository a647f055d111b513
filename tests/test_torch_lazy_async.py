"""The lazy engine's async runtime (``paddle_tpu_torch/core/lazy.py``),
port of the reference's ``test_lazy_async.py`` pins, on the CPU.

* a k-step Adam loop is bit-equal with ``FLAGS_lazy_async`` on and off;
* ``sync()`` is a barrier and counts a ``block``;
* the deferred NaN/Inf check trips at the next flush, at ``sync()`` and at
  a materialization, with the producing ``lazy_flush`` span in the flight
  dump; with ``FLAGS_lazy_async=0`` it trips at the flush itself (the same
  step), and ``FLAGS_check_nan_inf_per_op`` names the poisoned op;
* donation is suppressed while the scan is armed;
* no ``block`` span ever sits inside a ``lazy_flush`` span;
* HBM admission measures a signature's first flush and admits the next
  (an ``enforce`` rejection leaves the graph pending);
* the stability sentinel's drain tap is installed while one is active.
The reference's behaviour is held beside the port's where its test holds
it (the same trip step, the same dump keys).
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.core import lazy as jlazy
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.fault import inject
from paddle_tpu_torch.profiler import flight
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _clean():
    with cpu_device():
        yield
    inject.disarm()
    tp.set_flags({"FLAGS_check_nan_inf": False,
                  "FLAGS_check_nan_inf_per_op": False,
                  "FLAGS_lazy_async": True, "FLAGS_lazy_donate": True,
                  "FLAGS_lazy_bg_compile": False,
                  "FLAGS_hbm_admission": "off"})
    try:
        lazy.sync()
    except FloatingPointError:
        pass
    lazy.set_lazy_mode(False)


class MLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(16, 32)
        self.fc2 = tnn.Linear(32, 10)

    def forward(self, x):
        return self.fc2(TF.relu(self.fc1(x)))


def _train(async_on, steps=4, **flags):
    tp.set_flags({"FLAGS_lazy_async": bool(async_on), **flags})
    tp.seed(7)
    with tp.utils.unique_name.guard():
        m = MLP()
    opt = tp.optimizer.Adam(learning_rate=0.01, parameters=m.parameters())
    lazy.set_lazy_mode(True)
    losses = []
    for i in range(steps):
        x = tp.to_tensor(np.random.RandomState(i).randn(8, 16).astype(
            np.float32))
        y = tp.to_tensor(np.random.RandomState(100 + i).randint(
            0, 10, (8,)).astype(np.int64))
        loss = TF.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    lazy.set_lazy_mode(False)
    tp.set_flags({"FLAGS_lazy_async": True})
    return losses, [p.detach().numpy().copy() for p in m.parameters()]


@pytest.mark.parametrize("flag", ["FLAGS_lazy_async", "FLAGS_lazy_bg_compile",
                                  "FLAGS_lazy_donate"])
def test_flags_keep_the_loop_bit_equal(flag):
    """Each of the runtime's switches changes when the work runs, never
    what it computes."""
    if flag == "FLAGS_lazy_async":
        on, off = _train(True), _train(False)
    else:
        on, off = _train(True, **{flag: True}), _train(True, **{flag: False})
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        np.testing.assert_array_equal(a, b)


def test_sync_is_a_barrier():
    t = tp.to_tensor(np.ones(32, np.float32))
    lazy.set_lazy_mode(True)
    u = t * 2.0 + 1.0
    assert lazy.is_lazy(u) and u._concrete is None
    before = profiler.counters().get("lazy_blocks", 0)
    lazy.sync()
    assert u._concrete is not None
    assert profiler.counters().get("lazy_blocks", 0) > before
    np.testing.assert_array_equal(u._concrete.numpy(), np.full(32, 3.0))


def _nan_graph():
    w = tp.to_tensor(np.zeros(4, np.float32))
    return w, tp.log(w - 1.0)  # NaN born lazily


def test_trip_surfaces_at_the_next_flush_with_the_producing_span(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    w, bad = _nan_graph()
    c0 = profiler.counters().get("lazy_deferred_checks", 0)
    lazy.flush()  # enqueued; the scan is deferred, no raise here
    assert profiler.counters().get("lazy_deferred_checks", 0) > c0
    ok = w + 1.0
    with pytest.raises(FloatingPointError, match="log"):
        lazy.flush()  # the next flush drains the deferred check
    doc = json.load(open(flight.last_dump()))
    assert doc["reason"] == "naninf"
    assert doc["extra"]["producing_span"]["name"] == "lazy_flush"
    assert doc["extra"]["origin"] == "lazy flush (deferred)"
    assert doc["pending_graph"]["pending_nodes"] >= 1  # `ok` still pending
    del bad, ok


def test_trip_surfaces_at_sync_and_at_a_materialization():
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    _, t = _nan_graph()
    lazy.flush()
    with pytest.raises(FloatingPointError):
        lazy.sync()
    _, t = _nan_graph()
    with pytest.raises(FloatingPointError, match="log"):
        t.numpy()  # the drain runs at the materialization point


def test_sync_mode_trips_within_the_step_as_the_reference():
    """With FLAGS_lazy_async=0 the trip lands at the flush that produced
    it, in both packages."""
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_lazy_async": False, "FLAGS_check_nan_inf": True})
    paddle.set_flags({"FLAGS_lazy_async": False,
                      "FLAGS_check_nan_inf": True})
    try:
        _, t = _nan_graph()
        with pytest.raises(FloatingPointError, match=r"\[lazy flush\]"):
            lazy.flush()
        jw = paddle.to_tensor(np.zeros(4, np.float32))
        jt = paddle.log(jw - 1.0)
        with pytest.raises(FloatingPointError):
            jlazy.flush()
    finally:
        paddle.set_flags({"FLAGS_lazy_async": True,
                          "FLAGS_check_nan_inf": False})
        del jt


def test_injected_nan_is_caught_with_attribution(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    inject.arm("tensor.nan:op=aten.mm.default,call=1")
    a = tp.to_tensor(np.ones((4, 4), np.float32))
    c = torch.matmul(a, a)
    lazy.flush()  # the poison runs, the check is deferred
    with pytest.raises(FloatingPointError):
        lazy.sync()
    doc = json.load(open(flight.last_dump()))
    assert doc["extra"]["producing_span"]["name"] == "lazy_flush"
    assert doc["fault_inject"]["armed"] is True
    del c


def test_per_op_mode_names_the_poisoned_op():
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_check_nan_inf": True,
                  "FLAGS_check_nan_inf_per_op": True})
    inject.arm("tensor.nan:op=aten.mm.default,call=1")
    a = tp.to_tensor(np.ones((4, 4), np.float32))
    c = torch.matmul(a, a) + 1.0
    with pytest.raises(FloatingPointError, match=r"aten\.mm\.default.*per-op"):
        lazy.flush()
    del c


def test_donation_is_suppressed_while_the_scan_is_armed():
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_check_nan_inf": True})
    before = profiler.counters().get("naninf_donation_suppressed", 0)
    donated = profiler.counters().get("lazy_donated_buffers", 0)
    w = tp.to_tensor(np.ones(4, np.float32))
    v = w + 1.0
    lazy.note_rebound(w)  # the rebind pattern
    lazy.sync()
    assert profiler.counters().get("naninf_donation_suppressed", 0) > before
    assert profiler.counters().get("lazy_donated_buffers", 0) == donated
    del v


def test_a_dead_rebound_leaf_is_donated():
    lazy.set_lazy_mode(True)
    donated = profiler.counters().get("lazy_donated_buffers", 0)
    w = tp.to_tensor(np.ones(4, np.float32))
    v = w + 1.0
    lazy.note_rebound(w)
    del w  # only the pending graph holds it now
    lazy.flush()
    assert profiler.counters().get("lazy_donated_buffers", 0) == donated + 1
    np.testing.assert_array_equal(v.numpy(), np.full(4, 2.0))


def test_no_block_span_inside_a_lazy_flush():
    _train(True, steps=3)
    spans = {s.span_id: s for s in flight.recent_spans()}
    for s in spans.values():
        if s.name != "block":
            continue
        p = spans.get(s.parent_id)
        while p is not None:
            assert p.name != "lazy_flush", "a host wait inside a flush"
            p = spans.get(p.parent_id)


def test_hbm_admission_measures_then_admits():
    from paddle_tpu_torch.fault import memory as hbm

    t = tp.to_tensor(np.ones(1024, np.float32))
    lazy.evict_cold(0)
    lazy.set_lazy_mode(True)
    tp.set_flags({"FLAGS_hbm_admission": "enforce",
                  "FLAGS_hbm_budget_bytes": 1 << 40})
    try:
        outs = []
        for _ in range(2):
            outs.append(t * 3.0)
            lazy.flush()  # the first measured, the second admitted
        assert any(r["key"].startswith("lazy_flush:")
                   for r in hbm.attributions())
        tp.set_flags({"FLAGS_hbm_budget_bytes": 10})
        outs.append(t * 3.0)
        with pytest.raises(hbm.HbmBudgetExceeded):
            lazy.flush()
        assert lazy.pending_summary()["pending_nodes"] == 1  # left pending
        tp.set_flags({"FLAGS_hbm_budget_bytes": 1 << 40})
        lazy.flush()
        np.testing.assert_array_equal(outs[-1].numpy(), np.full(1024, 3.0))
    finally:
        tp.set_flags({"FLAGS_hbm_admission": "off",
                      "FLAGS_hbm_budget_bytes": 0})


def test_the_sentinel_taps_the_drain_while_active():
    from paddle_tpu_torch.fault.sentinel import StabilitySentinel

    assert lazy._stability_tap is None
    s = StabilitySentinel(window=8, warmup=2)
    try:
        assert lazy._stability_tap is not None
        lazy.set_lazy_mode(True)
        lazy.sync()  # taps; never raises
    finally:
        s.close()
    assert lazy._stability_tap is None
