"""Port parity of ``paddle_tpu_torch.ops.metrics_ops`` against the JAX
package's, on the same numpy inputs from a seed: ``auc`` (with tied scores
and with an empty class), ``edit_distance`` (the batched row recurrence
against the reference's double loop, normalised and not, with empty and
full-length rows), ``mean_iou``, ``precision_recall`` and
``positive_negative_pair``.

float32 outputs rtol 1e-5, atol 1e-6; integer outputs exactly; dtypes by
name.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.ops import metrics_ops as RM
from paddle_tpu_torch.ops import metrics_ops as PM
from torch_port_util import assert_same, cpu_device, flat_outputs


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
SCORES = np.round(_R.rand(40), 1).astype(np.float32)  # ties
LABELS = (_R.rand(40) > 0.6).astype(np.int64)
HYP = _R.randint(0, 4, (6, 9)).astype(np.int64)
REF = _R.randint(0, 4, (6, 7)).astype(np.int64)
HLEN = np.array([9, 0, 4, 7, 1, 3], np.int64)
RLEN = np.array([7, 3, 0, 5, 7, 2], np.int64)
PRED = _R.randint(0, 5, (3, 8)).astype(np.int64)
GOLD = _R.randint(0, 6, (3, 8)).astype(np.int64)
QID = np.repeat(np.arange(4), 5).astype(np.int64)
QSCORE = np.round(_R.rand(20), 1).astype(np.float32)
QLABEL = _R.randint(0, 3, 20).astype(np.float32)


class A:
    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    return pkg.to_tensor(v.a) if isinstance(v, A) else v


CASES = {
    "auc": ("auc", [A(SCORES), A(LABELS)], {}),
    "auc_one_class": ("auc", [A(SCORES), A(np.zeros(40, np.int64))], {}),
    "edit_distance": ("edit_distance", [A(HYP), A(HLEN), A(REF), A(RLEN)],
                      {}),
    "edit_distance_raw": ("edit_distance", [A(HYP), A(HLEN), A(REF),
                                            A(RLEN)], {"normalized": False}),
    "edit_distance_same": ("edit_distance", [A(REF), A(RLEN), A(REF),
                                             A(RLEN)], {}),
    "mean_iou": ("mean_iou", [A(PRED), A(GOLD), 6], {}),
    "precision_recall": ("precision_recall", [A(PRED), A(GOLD), 6], {}),
    "positive_negative_pair": ("positive_negative_pair",
                               [A(QSCORE), A(QLABEL), A(QID)], {}),
}


def test_every_reference_op_has_a_case():
    assert {c[0] for c in CASES.values()} == set(RM.__all__) \
        == set(PM.__all__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_op_matches_reference(case):
    name, args, kw = CASES[case]
    want = flat_outputs(getattr(RM, name)(*[_conv(paddle, a) for a in args],
                                          **kw))
    got = flat_outputs(getattr(PM, name)(*[_conv(tp, a) for a in args],
                                         **kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, what=f"{case}[{i}]")


def _levenshtein(a, b):
    d = np.arange(len(b) + 1, dtype=np.float64)
    for i, ca in enumerate(a):
        prev, d[0] = d[0], i + 1
        for j, cb in enumerate(b):
            prev, d[j + 1] = d[j + 1], min(d[j + 1] + 1, d[j] + 1,
                                           prev + (ca != cb))
    return d[-1]


def test_edit_distance_equals_textbook_levenshtein_on_longer_rows():
    rng = np.random.RandomState(1)
    h = rng.randint(0, 3, (5, 40)).astype(np.int64)
    r = rng.randint(0, 3, (5, 33)).astype(np.int64)
    hl = np.array([40, 17, 0, 33, 5], np.int64)
    rl = np.array([33, 33, 9, 0, 20], np.int64)
    got = PM.edit_distance(tp.to_tensor(h), tp.to_tensor(hl),
                           tp.to_tensor(r), tp.to_tensor(rl),
                           normalized=False).numpy()
    want = [_levenshtein(h[b, :hl[b]], r[b, :rl[b]]) for b in range(5)]
    np.testing.assert_array_equal(got, want)
