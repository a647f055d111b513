"""Port parity of the op subset (``paddle_tpu_torch.ops.creation``, ``math``
and ``manipulation``, exported at the top level) against the JAX package's
functions of the same name, on the same numpy inputs from a seed.

f32 outputs are held to rtol 1e-5 (atol 1e-6), integer and bool outputs
exactly, and every output's dtype by name. The cases include the places
where Paddle's semantics differ from torch's: ``reshape`` with a 0,
``split`` by count and with a -1, ``gather`` as an index select,
``flatten``'s axes, ``expand`` with a -1, ``topk``, and ``sum`` of bool and
int32 (int64). The random ops cannot match JAX's bits: they are held to
their shape, dtype, range and sample moments.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.core.dtype import dtype_name as jname
from paddle_tpu_torch.core.dtype import dtype_name as tname
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
X = _R.randn(3, 4).astype(np.float32)
Y = _R.randn(3, 4).astype(np.float32)
P = (np.abs(_R.randn(3, 4)) + 0.5).astype(np.float32)
W = _R.randn(4, 5).astype(np.float32)
B3 = _R.randn(2, 3, 4).astype(np.float32)
IDX = np.array([2, 0, 2], np.int64)
I32 = np.arange(12, dtype=np.int32).reshape(3, 4)
MASK = X > 0


class A:
    """A numpy argument each package turns into its own tensor."""

    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    if isinstance(v, A):
        return pkg.to_tensor(v.a)
    if isinstance(v, list) and v and isinstance(v[0], A):
        return [pkg.to_tensor(x.a) for x in v]
    return v


CASES = {
    # creation
    "zeros": ("zeros", [[2, 3]], {}),
    "ones_i64": ("ones", [[2]], {"dtype": "int64"}),
    "full_float": ("full", [[2, 2], 1.5], {}),
    "full_int": ("full", [[2], 7], {}),
    "zeros_like": ("zeros_like", [A(I32)], {}),
    "ones_like_f": ("ones_like", [A(X)], {"dtype": "float32"}),
    "full_like": ("full_like", [A(X), 2.0], {}),
    "empty_shape": ("empty", [[2, 3]], {}),
    "arange_int": ("arange", [5], {}),
    "arange_float": ("arange", [0.0, 2.0, 0.5], {}),
    "arange_step": ("arange", [1, 10, 3], {}),
    "eye": ("eye", [3, 4], {}),
    "tril": ("tril", [A(X)], {"diagonal": 1}),
    "triu": ("triu", [A(X)], {"diagonal": -1}),
    "assign": ("assign", [A(X)], {}),
    "clone": ("clone", [A(X)], {}),
    # math
    "add": ("add", [A(X), A(Y)], {}),
    "add_scalar": ("add", [A(X), 2.0], {}),
    "subtract": ("subtract", [A(X), A(Y)], {}),
    "subtract_scalar_first": ("subtract", [2.0, A(X)], {}),
    "multiply_bcast": ("multiply", [A(B3), A(X[0])], {}),
    "divide": ("divide", [A(X), A(P)], {}),
    "matmul": ("matmul", [A(X), A(W)], {}),
    "matmul_tx": ("matmul", [A(W), A(X)], {"transpose_x": True,
                                           "transpose_y": True}),
    "matmul_batched_ty": ("matmul", [A(B3), A(B3)], {"transpose_y": True}),
    "sum_all": ("sum", [A(X)], {}),
    "sum_axis_keep": ("sum", [A(B3)], {"axis": [0, 2], "keepdim": True}),
    "sum_bool": ("sum", [A(MASK)], {}),
    "sum_int32": ("sum", [A(I32)], {"axis": 1}),
    "mean": ("mean", [A(B3)], {"axis": -1}),
    "mean_all_keep": ("mean", [A(X)], {"keepdim": True}),
    "max": ("max", [A(B3)], {"axis": 1}),
    "max_all": ("max", [A(X)], {}),
    "min_keep": ("min", [A(X)], {"axis": 0, "keepdim": True}),
    "prod": ("prod", [A(P)], {"axis": 1}),
    "prod_axes": ("prod", [A(B3)], {"axis": [0, -1]}),
    "exp": ("exp", [A(X)], {}),
    "log": ("log", [A(P)], {}),
    "sqrt": ("sqrt", [A(P)], {}),
    "rsqrt": ("rsqrt", [A(P)], {}),
    "tanh": ("tanh", [A(X)], {}),
    "sigmoid": ("sigmoid", [A(X)], {}),
    "square": ("square", [A(X)], {}),
    "pow_scalar": ("pow", [A(P), 2.5], {}),
    "pow_tensor": ("pow", [A(P), A(Y)], {}),
    "abs": ("abs", [A(X)], {}),
    "cast_int": ("cast", [A(X * 3), "int32"], {}),
    "cast_bf16": ("cast", [A(X), "bfloat16"], {}),
    "scale": ("scale", [A(X)], {"scale": 2.0, "bias": 0.5}),
    "scale_bias_first": ("scale", [A(X)], {"scale": 2.0, "bias": 0.5,
                                          "bias_after_scale": False}),
    "clip": ("clip", [A(X)], {"min": -0.5, "max": 0.5}),
    "argmax": ("argmax", [A(X)], {"axis": 1}),
    "argmax_all": ("argmax", [A(X)], {}),
    "argmin_keep": ("argmin", [A(X)], {"axis": 0, "keepdim": True}),
    "cumsum": ("cumsum", [A(X)], {"axis": 1}),
    "cumsum_flat": ("cumsum", [A(X)], {}),
    "maximum": ("maximum", [A(X), A(Y)], {}),
    "minimum": ("minimum", [A(X), A(Y)], {}),
    "equal": ("equal", [A(I32), A(I32 % 3)], {}),
    "not_equal": ("not_equal", [A(I32), 4], {}),
    "greater_than": ("greater_than", [A(X), A(Y)], {}),
    "greater_equal": ("greater_equal", [A(X), 0.0], {}),
    "less_than": ("less_than", [A(X), A(Y)], {}),
    "less_equal": ("less_equal", [A(X), 0.1], {}),
    "allclose_true": ("allclose", [A(X), A(X + 1e-7)], {}),
    "allclose_false": ("allclose", [A(X), A(Y)], {}),
    # manipulation
    "reshape": ("reshape", [A(B3), [4, -1]], {}),
    "transpose": ("transpose", [A(B3), [2, 0, 1]], {}),
    "concat": ("concat", [[A(X), A(Y)]], {"axis": 1}),
    "stack": ("stack", [[A(X), A(Y)]], {"axis": -1}),
    "split_count": ("split", [A(B3), 2], {"axis": 2}),
    "split_sizes": ("split", [A(B3), [1, -1, 1]], {"axis": 1}),
    "chunk": ("chunk", [A(X), 2], {"axis": 1}),
    "unbind": ("unbind", [A(B3)], {"axis": 1}),
    "squeeze_all": ("squeeze", [A(X[None, :, None])], {}),
    "squeeze_axes": ("squeeze", [A(X[None, :, None])], {"axis": [0, 1]}),
    "unsqueeze": ("unsqueeze", [A(X)], {"axis": [0, -1]}),
    "flatten": ("flatten", [A(B3)], {"start_axis": 1}),
    "flatten_stop": ("flatten", [A(B3)], {"start_axis": 0, "stop_axis": 1}),
    "expand": ("expand", [A(X[:1])], {"shape": [2, 3, 4]}),
    "expand_keep": ("expand", [A(X[:, :1])], {"shape": [-1, 4]}),
    "broadcast_to": ("broadcast_to", [A(X[0])], {"shape": [3, 4]}),
    "tile": ("tile", [A(X)], {"repeat_times": [2, 1, 3]}),
    "gather": ("gather", [A(X), A(IDX)], {"axis": 0}),
    "gather_axis1": ("gather", [A(X), A(IDX)], {"axis": 1}),
    "gather_nd": ("gather_nd", [A(B3), A(np.array([[0, 2], [1, 1]]))], {}),
    "index_select": ("index_select", [A(X), A(IDX)], {"axis": 1}),
    "take_along_axis": ("take_along_axis",
                        [A(X), A(np.argsort(X, 1)[:, :2])], {"axis": 1}),
    "where": ("where", [A(MASK), A(X), A(Y)], {}),
    "masked_fill": ("masked_fill", [A(X), A(MASK), -1.0], {}),
    "topk": ("topk", [A(X), 2], {}),
    "topk_smallest_axis0": ("topk", [A(X), 2], {"axis": 0,
                                                "largest": False}),
    "sort": ("sort", [A(X)], {"axis": 1}),
    "sort_desc": ("sort", [A(X)], {"axis": 0, "descending": True}),
    "argsort": ("argsort", [A(X)], {"descending": True}),
    "repeat_interleave": ("repeat_interleave", [A(X), 2], {"axis": 1}),
    "repeat_interleave_flat": ("repeat_interleave", [A(X), 2], {}),
    "slice": ("slice", [A(B3)], {"axes": [1, 2], "starts": [1, -3],
                                 "ends": [10, -1]}),
}


def _np(t):
    """(numpy value, dtype name) of a tensor of either package."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        name = tname(t.dtype)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name
    name = jname(t.dtype)
    return np.asarray(t.numpy(), np.float32 if name == "bfloat16" else None), \
        name


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw = CASES[case]
    want = _flat(getattr(paddle, name)(*[_conv(paddle, a) for a in args],
                                       **kw))
    got = _flat(getattr(tp, name)(*[_conv(tp, a) for a in args], **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tp.Tensor) and g.device.type == "cpu"
        (gv, gn), (wv, wn) = _np(g), _np(w)
        assert gn == wn, (gn, wn)
        assert gv.shape == wv.shape, (gv.shape, wv.shape)
        if gv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(gv, wv)


def test_reshape_zero_copies_the_dimension():
    """Paddle's rule: a 0 keeps the input's dimension at that place. The
    reference's ``reshape`` hands the 0 to ``jnp.reshape`` (and raises), so
    the port is held to the reference with the dimension written out."""
    x = tp.to_tensor(B3)
    want = paddle.reshape(paddle.to_tensor(B3), [2, 3, -1, 1]).numpy()
    for shape in ([0, 0, -1, 1], [2, 0, 4, 1], [0, 3, 4, -1]):
        np.testing.assert_array_equal(tp.reshape(x, shape).numpy(), want)


def test_split_count_must_divide():
    with pytest.raises(ValueError, match="divisible"):
        tp.split(tp.to_tensor(X), 3, axis=1)
    with pytest.raises(ValueError, match="divisible"):
        paddle.split(paddle.to_tensor(X), 3, axis=1)


def test_where_with_condition_only_matches_reference():
    want = paddle.where(paddle.to_tensor(MASK))
    got = tp.where(tp.to_tensor(MASK))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (int(MASK.sum()), 1) and g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), w.numpy())


RANDOM = {
    "rand": (lambda pk: pk.rand([4000]), 0.0, 1.0, 0.5, 1 / 12 ** 0.5),
    "uniform": (lambda pk: pk.uniform([4000], min=-2.0, max=2.0), -2.0, 2.0,
                0.0, 4 / 12 ** 0.5),
    "randn": (lambda pk: pk.randn([4000]), -np.inf, np.inf, 0.0, 1.0),
    "normal": (lambda pk: pk.normal(1.0, 2.0, [4000]), -np.inf, np.inf, 1.0,
               2.0),
    "randint": (lambda pk: pk.randint(0, 10, [4000]), 0, 9, 4.5,
                (99 / 12) ** 0.5),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_op_shape_dtype_range_and_moments(case):
    make, lo, hi, mean, std = RANDOM[case]
    tp.seed(11)
    got = make(tp)
    want = make(paddle)
    assert tuple(got.shape) == tuple(want.shape)
    assert tname(got.dtype) == jname(want.dtype)
    v = got.double().numpy()
    assert v.min() >= lo and v.max() <= hi
    # 4000 samples: the mean within 5 standard errors, the std within 10%
    assert abs(v.mean() - mean) < 5 * std / 4000 ** 0.5
    assert abs(v.std() - std) < 0.1 * std
    tp.seed(11)
    assert torch.equal(make(tp), got)  # reseeding repeats the draw
    assert not torch.equal(make(tp), got)


def test_random_ops_take_a_dtype():
    assert tp.rand([2], dtype="bfloat16").dtype == torch.bfloat16
    assert tp.randint(0, 5, [3], dtype="int32").dtype == torch.int32
    assert tp.randint(5, shape=[3]).max() < 5
