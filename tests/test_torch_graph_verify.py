"""The lazy-graph verifier (``paddle_tpu_torch/analysis/verify_graph.py``,
``FLAGS_lazy_verify``), port of the reference's ``test_graph_verify.py``
cases that touch no XLA donation, on the CPU.

A hand-built pending graph (add, then mul) with a cycle, an out-of-range
output, a dangling leaf, a misplaced leaf, a miscounted use, a donated but
referenced leaf, a tampered signature part or leaf signature, a malformed
deferred entry, or a captured graph's leaf that moved, each raises a
``GraphInvariantError`` naming the node and the rule; a corrupted graph
fails the flush itself. A train loop verifies on every flush and is
bit-equal with the verifier on and off; off, the verifier is never
entered. The reference's verifier raises the same rules on its own graph.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.analysis import verify_graph as jvg
from paddle_tpu_torch import profiler
from paddle_tpu_torch.analysis import verify_graph as vg
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.framework import flags
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield
    flags.set_flags({"FLAGS_lazy_verify": False})
    lazy.set_lazy_mode(False)


@pytest.fixture
def fresh_graph():
    """A two-node pending graph (add -> mul) and its live handles; the
    epoch is dropped on exit, so a corrupted graph never reaches a flush."""
    lazy.flush()
    a = torch.arange(8.0)
    (x,), _ = lazy.record("vadd", torch.add, [a, a])
    (y,), _ = lazy.record("vmul", torch.mul, [x, a])
    g = lazy._ts().graph
    yield g, a, x, y
    lazy._ts().graph = None


def _raises(g, rule, donate=(), deferred=None):
    with pytest.raises(vg.GraphInvariantError) as ei:
        vg.verify_before_dispatch(g, donate, deferred)
    assert ei.value.rule == rule, str(ei.value)
    assert rule in str(ei.value)
    return ei.value


def test_clean_graph_verifies(fresh_graph):
    g, a, x, y = fresh_graph
    vg.verify_before_dispatch(g, (), None)
    assert [str(n.key[0]) for n in g.nodes] == ["aten.add.Tensor",
                                               "aten.mul.Tensor"]


def test_cycle_detected_and_named(fresh_graph):
    g, a, x, y = fresh_graph
    g.descs[0] = (("n", 1, 0), ("n", 1, 0))  # a forward reference
    e = _raises(g, "acyclicity")
    assert e.node_index == 0 and "aten.add.Tensor" in str(e)
    assert "node 0" in str(e)


def test_out_of_range_output_index(fresh_graph):
    g, a, x, y = fresh_graph
    g.descs[1] = (("n", 0, 5), ("l", 0))  # add has one output
    e = _raises(g, "wiring")
    assert e.node_index == 1 and "aten.mul.Tensor" in str(e)


def test_dangling_leaf_detected(fresh_graph):
    g, a, x, y = fresh_graph
    g.descs[1] = (("n", 0, 0), ("l", 7))  # one leaf exists
    e = _raises(g, "leaf-table")
    assert "dangling leaf" in str(e) and "aten.mul.Tensor" in str(e)


def test_leaf_position_corruption(fresh_graph):
    g, a, x, y = fresh_graph
    g.leaf_pos[id(a)] = 3
    _raises(g, "leaf-table")


def test_direct_uses_miscount(fresh_graph):
    g, a, x, y = fresh_graph
    g.direct_uses[id(a)] += 1
    e = _raises(g, "leaf-table")
    assert "donation refcount budget" in str(e)


def test_donated_but_user_referenced_leaf(fresh_graph):
    g, a, x, y = fresh_graph
    e = _raises(g, "donation", donate=(0,))  # `a` is held right here
    assert "still references" in str(e)


def test_donation_index_out_of_range(fresh_graph):
    g, a, x, y = fresh_graph
    _raises(g, "donation", donate=(12,))


def test_signature_mismatch_detected(fresh_graph):
    g, a, x, y = fresh_graph
    g.keyparts[1] = (("evil", None), g.descs[1])
    e = _raises(g, "signature")
    assert e.node_index == 1


def test_leaf_signature_drift_detected(fresh_graph):
    g, a, x, y = fresh_graph
    g.leaf_avals[0] = ((4,), (1,), 0, torch.float64, "cpu", False, None)
    _raises(g, "signature")


def test_deferred_bookkeeping_checked(fresh_graph):
    g, a, x, y = fresh_graph
    _raises(g, "deferred", deferred=[("not", "a", "4-tuple")])
    _raises(g, "deferred", deferred=[(None, (["n"], [], None), False, None)])
    # census-only and well-formed scan entries pass
    vg.verify_before_dispatch(g, (), [(None, None, True, None)])
    vg.verify_before_dispatch(
        g, (), [(None, ([("aten.add.Tensor", 0)], [a],
                        torch.ones(1, dtype=torch.bool)), False, None)])


def test_a_bound_leaf_that_moved_is_caught(fresh_graph):
    """The card's rule: a captured graph reads its bound leaves where they
    were at the capture."""
    g, a, x, y = fresh_graph
    e = lazy._Entry()
    e.ptrs = {0: a.data_ptr()}
    vg.verify_bound_addresses(e, g.leaves)
    e.ptrs = {0: a.data_ptr() + 64}
    with pytest.raises(vg.GraphInvariantError) as ei:
        vg.verify_bound_addresses(e, g.leaves)
    assert ei.value.rule == "bound-address"


def test_the_rules_are_the_references():
    """Each rule the port raises is one the reference raises, beside the
    card's own."""
    import inspect

    ref = inspect.getsource(jvg)
    for rule in ("acyclicity", "wiring", "leaf-table", "donation",
                 "signature", "deferred"):
        assert f'"{rule}"' in ref
    assert set(vg.__all__) == set(jvg.__all__)


def test_corrupted_graph_fails_the_flush_itself():
    flags.set_flags({"FLAGS_lazy_verify": True})
    lazy.flush()
    a = torch.ones(4)
    (x,), _ = lazy.record("vcorrupt", torch.neg, [a])
    g = lazy._ts().graph
    g.descs[0] = (("l", 9),)
    try:
        with pytest.raises(vg.GraphInvariantError):
            lazy.flush()
    finally:
        lazy._ts().graph = None
    del x


class MLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(16, 32)
        self.fc2 = tnn.Linear(32, 10)

    def forward(self, x):
        return self.fc2(TF.relu(self.fc1(x)))


def _run():
    tp.seed(7)
    with tp.utils.unique_name.guard():
        m = MLP()
    opt = tp.optimizer.Adam(learning_rate=1e-3, parameters=m.parameters())
    rng = np.random.RandomState(7)
    x = tp.to_tensor(rng.randn(8, 16).astype(np.float32))
    y = tp.to_tensor(rng.randint(0, 10, (8,)).astype(np.int64))
    lazy.set_lazy_mode(True)
    out = []
    for _ in range(3):
        loss = TF.cross_entropy(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(loss.detach().numpy().tobytes())
    lazy.set_lazy_mode(False)
    return out


def test_training_parity_and_counter():
    flags.set_flags({"FLAGS_lazy_verify": True})
    before = profiler.counters().get("lazy_verify_passes", 0)
    on = _run()
    assert profiler.counters().get("lazy_verify_passes", 0) >= before + 3
    flags.set_flags({"FLAGS_lazy_verify": False})
    assert _run() == on  # bit for bit


def test_disabled_path_does_zero_verify_work(monkeypatch):
    def boom(*a, **k):  # pragma: no cover - reaching this IS the bug
        raise AssertionError("verifier entered with the flag off")

    monkeypatch.setattr(vg, "verify_before_dispatch", boom)
    before = profiler.counters().get("lazy_verify_passes", 0)
    lazy.set_lazy_mode(True)
    t = tp.to_tensor(np.ones((4, 4), np.float32))
    assert (t * 2 + 1).numpy().shape == (4, 4)
    assert profiler.counters().get("lazy_verify_passes", 0) == before


def test_flag_registered():
    assert flags.get_flags("FLAGS_lazy_verify")["FLAGS_lazy_verify"] in (
        True, False)
