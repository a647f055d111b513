"""paddle.metric (port of ``paddle_tpu/metric/__init__.py``).

Every ``update()`` reads its tensors back in ONE host sync through
:func:`_host`. The accumulators are host floats, ints and numpy
arrays, so ``accumulate()`` never touches the device. The ranking in
``Accuracy.compute`` and ``accuracy`` is the reference's ``np.argsort`` on
the host, so ties order as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import profiler as _prof
from ..core.tensor import host_arrays

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _host(*xs):
    """Every argument as a numpy array with a single device sync
    (``core.tensor.host_arrays``); ``metric_host_reads`` counts the
    calls."""
    _prof.counter_inc("metric_host_reads")
    return host_arrays(*xs)


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__

    def compute(self, *args):
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None, *args, **kwargs):
        super().__init__()
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """The (N, maxk) hit matrix, a host float32 tensor (so ``update``
        reads it without another sync)."""
        pred, label = _host(pred, label)
        if label.ndim == 1:
            label = label.reshape(-1, 1)
        maxk = max(self.topk)
        idx = np.argsort(-pred, axis=-1)[..., :maxk]
        return torch.from_numpy((idx == label).astype(np.float32))

    def update(self, correct, *args):
        (correct,) = _host(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = correct[..., :k].sum()
            self.total[i] += float(num)
            self.count[i] += int(correct.shape[0])
            accs.append(float(num) / max(correct.shape[0], 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) > 1:
            return [f"{self._name}_top{k}" for k in self.topk]
        return [self._name]


class Precision(Metric):
    def __init__(self, name=None, *args, **kwargs):
        super().__init__()
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds, labels = _host(preds, labels)
        preds = preds.round().astype(np.int32).reshape(-1)
        labels = labels.astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)

    def name(self):
        return [self._name]


class Recall(Metric):
    def __init__(self, name=None, *args, **kwargs):
        super().__init__()
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds, labels = _host(preds, labels)
        preds = preds.round().astype(np.int32).reshape(-1)
        labels = labels.astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)

    def name(self):
        return [self._name]


class Auc(Metric):
    """ROC AUC over a histogram of ``num_thresholds + 1`` score bins."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None, *args,
                 **kwargs):
        super().__init__()
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds, labels = _host(preds, labels)
        labels = labels.reshape(-1)
        if preds.ndim == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        bins = np.minimum((preds * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        pos = labels.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # trapezoid over the thresholds, descending
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(_trapezoid(tpr, fpr))

    def name(self):
        return [self._name]


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-``k`` accuracy of one batch, a float32 scalar on ``input``'s
    device."""
    pred, lab = _host(input, label)
    lab = lab.reshape(-1)
    idx = np.argsort(-pred, axis=-1)[..., :k]
    hit = (idx == lab[:, None]).any(axis=-1)
    dev = input.device if isinstance(input, torch.Tensor) else "cpu"
    return torch.tensor(hit.mean(), dtype=torch.float32, device=dev)


__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]
