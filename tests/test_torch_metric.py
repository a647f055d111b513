"""``metric`` against the reference's (``paddle_tpu/metric/__init__.py``):
each metric's ``compute``/``update``/``accumulate``/``name`` over several
batches of the same numpy inputs, exactly (host floats and numpy
accumulators in both), and one host read an update, counted. The scores
are drawn without ties (``Accuracy`` ranks with ``np.argsort`` in both
packages, whose order among equal scores is numpy's)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.metric as RMet
import paddle_tpu_torch as tp
import paddle_tpu_torch.metric as PMet
from paddle_tpu_torch import profiler
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _batches(n=4, b=16, c=6, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        pred = rng.permutation(b * c).reshape(b, c).astype(np.float32) / (
            b * c)  # distinct scores: no ties
        lab = rng.randint(0, c, (b,)).astype(np.int64)
        out.append((pred, lab))
    return out


def _as_list(v):
    return v if isinstance(v, list) else [v]


@pytest.mark.parametrize("topk", [(1,), (1, 3), 2])
def test_accuracy_over_batches(topk):
    r, p = RMet.Accuracy(topk=topk), PMet.Accuracy(topk=topk)
    assert p.name() == r.name()
    for pred, lab in _batches():
        jc = r.compute(paddle.to_tensor(pred), paddle.to_tensor(lab))
        tc = p.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc.numpy()))
        assert _as_list(p.update(tc)) == _as_list(r.update(jc))
        assert _as_list(p.accumulate()) == _as_list(r.accumulate())
    p.reset()
    assert p.total == [0.0] * len(p.topk) and p.count == [0] * len(p.topk)


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_and_recall_over_batches(cls):
    r, p = getattr(RMet, cls)(), getattr(PMet, cls)()
    assert p.name() == r.name()
    rng = np.random.RandomState(1)
    for _ in range(4):
        preds = rng.rand(32).astype(np.float32)
        labels = rng.randint(0, 2, (32,)).astype(np.int64)
        r.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
        assert p.accumulate() == r.accumulate()


@pytest.mark.parametrize("two_col", [False, True])
def test_auc_over_batches(two_col):
    r, p = RMet.Auc(num_thresholds=255), PMet.Auc(num_thresholds=255)
    assert p.name() == r.name()
    rng = np.random.RandomState(2)
    for _ in range(4):
        s = rng.rand(40).astype(np.float32)
        preds = np.stack([1 - s, s], 1) if two_col else s
        labels = (rng.rand(40) < s).astype(np.int64)
        r.update(paddle.to_tensor(preds), paddle.to_tensor(labels))
        p.update(torch.from_numpy(preds), torch.from_numpy(labels))
        np.testing.assert_array_equal(p._stat_pos, r._stat_pos)
        assert p.accumulate() == r.accumulate()
    assert 0.5 < p.accumulate() <= 1.0
    assert PMet.Auc().accumulate() == 0.0


@pytest.mark.parametrize("k", [1, 2, 4])
def test_accuracy_function(k):
    pred, lab = _batches(1, seed=3)[0]
    want = RMet.accuracy(paddle.to_tensor(pred), paddle.to_tensor(lab), k=k)
    got = PMet.accuracy(torch.from_numpy(pred), torch.from_numpy(lab), k=k)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(want.item())


def test_one_host_read_an_update():
    """Each ``update`` (and each ``compute``) reads its tensors back in
    one ``_host`` call; ``Accuracy.update`` of ``compute``'s host result
    does not touch the device."""
    pred, lab = _batches(1)[0]
    before = profiler.counters().get("metric_host_reads", 0)
    acc = PMet.Accuracy(topk=(1, 2))
    correct = acc.compute(torch.from_numpy(pred), torch.from_numpy(lab))
    assert correct.device.type == "cpu"
    acc.update(correct)
    for cls in (PMet.Precision, PMet.Recall, PMet.Auc):
        cls().update(torch.from_numpy(pred[:, 0]), torch.from_numpy(lab % 2))
    assert profiler.counters()["metric_host_reads"] - before == 5
    assert tp.metric.Accuracy is PMet.Accuracy


def test_base_metric_contract():
    m = PMet.Metric()
    assert m.name() == "Metric" and m.compute(1, 2) == (1, 2)
    for fn in (m.reset, m.update, m.accumulate):
        with pytest.raises(NotImplementedError):
            fn()
