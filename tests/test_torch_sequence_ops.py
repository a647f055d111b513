"""Port parity of ``paddle_tpu_torch.ops.sequence`` (padded data with
lengths) against the JAX package's, on the same numpy inputs from a seed,
with rows of length 0 and of full length among them.

float32 outputs rtol 1e-5, atol 1e-6; integer outputs (ids, new lengths)
exactly; dtypes by name. The gradients of ``sequence_softmax``,
``sequence_pool`` (each pool type) and ``sequence_conv`` are held to the
reference's tape at the same tolerance.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.ops import sequence as RS
from paddle_tpu_torch.ops import sequence as PS
from torch_port_util import assert_same, cpu_device, flat_outputs


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
X = _R.randn(4, 5, 3).astype(np.float32)
X2 = _R.randn(4, 5).astype(np.float32)
LEN = np.array([3, 0, 5, 1], np.int64)
PACKED = _R.randn(int(LEN.sum()), 3).astype(np.float32)
Y = _R.randn(4, 3, 3).astype(np.float32)
YLEN = np.array([2, 3, 0, 1], np.int64)
IDS = _R.randint(0, 6, (4, 5)).astype(np.int64)
ROWS = _R.randn(4, 3).astype(np.float32)
W = _R.randn(3 * 3, 2).astype(np.float32)


class A:
    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    return pkg.to_tensor(v.a) if isinstance(v, A) else v


CASES = {
    "pad": ("sequence_pad", [A(PACKED), A(LEN), 6], {"pad_value": -1.0}),
    "unpad": ("sequence_unpad", [A(X), A(LEN)], {}),
    "softmax": ("sequence_softmax", [A(X), A(LEN)], {}),
    "softmax_2d": ("sequence_softmax", [A(X2), A(LEN)], {}),
    **{f"pool_{p.lower()}": ("sequence_pool", [A(X), A(LEN)],
                             {"pool_type": p})
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "MIN", "LAST", "FIRST")},
    "first_step": ("sequence_first_step", [A(X), A(LEN)], {}),
    "last_step": ("sequence_last_step", [A(X), A(LEN)], {}),
    "reverse": ("sequence_reverse", [A(X), A(LEN)], {}),
    "expand": ("sequence_expand", [A(ROWS), A(LEN), 5], {}),
    "expand_as": ("sequence_expand_as", [A(ROWS), A(X), A(LEN)], {}),
    "concat": ("sequence_concat", [A(X), A(LEN), A(Y), A(YLEN)], {}),
    "slice": ("sequence_slice", [A(X), A(LEN),
                                 A(np.array([1, 0, 2, 0], np.int64)),
                                 A(np.array([2, 1, 5, 1], np.int64))], {}),
    "erase": ("sequence_erase", [A(IDS), A(LEN), [1, 3]], {}),
    "enumerate": ("sequence_enumerate", [A(IDS), A(LEN), 3],
                  {"pad_value": -1}),
    "reshape": ("sequence_reshape", [A(X), A(LEN), 5], {}),
    "scatter": ("sequence_scatter", [A(X2), A(np.array(
        [[0, 2], [1, 1], [4, 0], [3, 3]], np.int64)), A(ROWS[:, :2]),
        A(np.array([2, 1, 0, 2], np.int64))], {}),
    "topk_avg": ("sequence_topk_avg_pooling", [A(X2), A(LEN), [1, 2, 4]],
                 {}),
    "conv": ("sequence_conv", [A(X), A(LEN), A(W)], {}),
    "conv_start": ("sequence_conv", [A(X), A(LEN), A(W)],
                   {"context_start": -2}),
}


def test_every_reference_op_has_a_case():
    assert {c[0] for c in CASES.values()} == set(RS.__all__) \
        == set(PS.__all__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_op_matches_reference(case):
    name, args, kw = CASES[case]
    want = flat_outputs(getattr(RS, name)(*[_conv(paddle, a) for a in args],
                                          **kw))
    got = flat_outputs(getattr(PS, name)(*[_conv(tp, a) for a in args],
                                         **kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, what=f"{case}[{i}]")


@pytest.mark.parametrize("case", ["softmax", "pool_sum", "pool_average",
                                  "pool_sqrt", "pool_max", "pool_min",
                                  "pool_last", "pool_first", "conv"])
def test_sequence_op_gradient_matches_reference_tape(case):
    name, args, kw = CASES[case]

    def run(pkg, mod):
        xs = [pkg.to_tensor(a.a, stop_gradient=a.a.dtype.kind != "f")
              if isinstance(a, A) else a for a in args]
        flat_outputs(getattr(mod, name)(*xs, **kw))[0].sum().backward()
        return [x for x, a in zip(xs, args)
                if isinstance(a, A) and a.a.dtype.kind == "f"]

    for j, t in zip(run(paddle, RS), run(tp, PS)):
        assert_same(t.grad, j.grad, what=case)
