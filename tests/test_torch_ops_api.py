"""Port parity of ``paddle_tpu_torch.ops.creation``, ``math`` and
``manipulation`` (exported at the top level) against the JAX package's
functions of the same name, on the same numpy inputs from a seed; a name
the reference does not export at the top level is taken from its module.

f32 outputs are held to rtol 1e-5 (atol 1e-6), the special functions
(``SPECIAL``) to rtol 1e-4 (atol 1e-5), integer and bool outputs exactly,
and every output's dtype by name. The cases include the places
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
from torch_port_util import as_numpy, cpu_device


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
MASK2 = Y > 0
U = (_R.rand(3, 4) * 1.6 - 0.8).astype(np.float32)  # inside (-1, 1)
XN = X.copy()
XN[0, 1], XN[2, 3] = np.nan, np.inf
TIES = np.array([[1, 3, 3, 2, 3, 0], [2, 2, 1, 2, 5, 5]], np.float32)
SQ = _R.randn(4, 4).astype(np.float32)
C64 = (X + 1j * Y).astype(np.complex64)
IMG = _R.randn(2, 3, 4, 5).astype(np.float32)


SPECIAL = {"digamma", "lgamma", "erfinv", "i0", "i1"}


class A:
    """A numpy argument each package turns into its own tensor."""

    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    if isinstance(v, A):
        return pkg.to_tensor(v.a)
    if isinstance(v, list) and v and isinstance(v[0], A):
        return [pkg.to_tensor(x.a) for x in v]
    if isinstance(v, tuple):  # an index expression
        return tuple(_conv(pkg, x) for x in v)
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
    # creation: the rest
    "linspace": ("linspace", [-1.0, 2.0, 7], {}),
    "logspace": ("logspace", [0.0, 2.0, 5], {"base": 2.0}),
    "diag_vector_pad": ("diag", [A(X[0])], {"offset": 1,
                                            "padding_value": -2.0}),
    "diag_matrix": ("diag", [A(X)], {"offset": -1}),
    "diagflat": ("diagflat", [A(X[:2, :2])], {"offset": 1}),
    "meshgrid": ("meshgrid", [A(X[0]), A(Y[:, 0])], {}),
    "meshgrid_list": ("meshgrid", [[A(X[0]), A(Y[:, 0])]], {}),
    "numel": ("numel", [A(B3)], {}),
    "shard_index": ("shard_index", [A(np.array([[1], [6], [12], [19]]))],
                    {"index_num": 20, "nshards": 2, "shard_id": 1}),
    # math: the rest
    "floor_divide": ("floor_divide", [A(X), A(P)], {}),
    "remainder": ("remainder", [A(X), A(P)], {}),
    "mod_scalar": ("mod", [A(X), 0.7], {}),
    "floor_mod": ("floor_mod", [A(I32), 5], {}),
    "fmax": ("fmax", [A(XN), A(Y)], {}),
    "fmin": ("fmin", [A(XN), A(Y)], {}),
    "atan2": ("atan2", [A(X), A(Y)], {}),
    "hypot": ("hypot", [A(X), A(Y)], {}),
    "heaviside": ("heaviside", [A(np.round(X)), A(Y)], {}),
    "copysign": ("copysign", [A(P), A(Y)], {}),
    "nextafter": ("nextafter", [A(X), A(Y)], {}),
    "gcd": ("gcd", [A(I32), A(I32 % 5 + 2)], {}),
    "lcm": ("lcm", [A(I32), A(I32 % 5 + 2)], {}),
    "ldexp": ("ldexp", [A(X), A(I32 % 4)], {}),
    "expm1": ("expm1", [A(X)], {}),
    "log2": ("log2", [A(P)], {}),
    "log10": ("log10", [A(P)], {}),
    "log1p": ("log1p", [A(P)], {}),
    "neg": ("neg", [A(X)], {}),
    "sign": ("sign", [A(X)], {}),
    "floor": ("floor", [A(X * 3)], {}),
    "ceil": ("ceil", [A(X * 3)], {}),
    "round_half_even": ("round", [A(np.array([0.5, 1.5, 2.5, -0.5, 1.2],
                                             np.float32))], {}),
    "trunc": ("trunc", [A(X * 3)], {}),
    "frac": ("frac", [A(X * 3)], {}),
    "sin": ("sin", [A(X)], {}),
    "cos": ("cos", [A(X)], {}),
    "tan": ("tan", [A(U)], {}),
    "asin": ("asin", [A(U)], {}),
    "acos": ("acos", [A(U)], {}),
    "atan": ("atan", [A(X)], {}),
    "sinh": ("sinh", [A(X)], {}),
    "cosh": ("cosh", [A(X)], {}),
    "asinh": ("asinh", [A(X)], {}),
    "acosh": ("acosh", [A(P + 1)], {}),
    "atanh": ("atanh", [A(U)], {}),
    "erf": ("erf", [A(X)], {}),
    "erfinv": ("erfinv", [A(U)], {}),
    "reciprocal": ("reciprocal", [A(P)], {}),
    "digamma": ("digamma", [A(P)], {}),
    "lgamma": ("lgamma", [A(P)], {}),
    "i0": ("i0", [A(X)], {}),
    "i1": ("i1", [A(X)], {}),
    "isnan": ("isnan", [A(XN)], {}),
    "isinf": ("isinf", [A(XN)], {}),
    "isfinite": ("isfinite", [A(XN)], {}),
    "logical_not": ("logical_not", [A(MASK)], {}),
    "bitwise_not": ("bitwise_not", [A(I32)], {}),
    "lerp": ("lerp", [A(X), A(Y), 0.3], {}),
    "lerp_tensor": ("lerp", [A(X), A(Y), A(P / 2)], {}),
    "nan_to_num": ("nan_to_num", [A(XN)], {"nan": 0.5}),
    "stanh": ("stanh", [A(X)], {}),
    "logical_and": ("logical_and", [A(MASK), A(MASK2)], {}),
    "logical_or": ("logical_or", [A(MASK), A(MASK2)], {}),
    "logical_xor": ("logical_xor", [A(MASK), A(MASK2)], {}),
    "bitwise_and": ("bitwise_and", [A(I32), A(I32 % 3)], {}),
    "bitwise_or": ("bitwise_or", [A(I32), A(I32 % 3)], {}),
    "bitwise_xor": ("bitwise_xor", [A(I32), A(I32 % 3)], {}),
    "equal_all_true": ("equal_all", [A(X), A(X)], {}),
    "equal_all_false": ("equal_all", [A(X), A(Y)], {}),
    "isclose": ("isclose", [A(X), A(X + 2e-5)], {}),
    "amax": ("amax", [A(B3)], {"axis": [0, 2]}),
    "amin": ("amin", [A(B3)], {"axis": -1, "keepdim": True}),
    "all": ("all", [A(MASK)], {"axis": 1}),
    "any": ("any", [A(MASK)], {}),
    "std": ("std", [A(B3)], {"axis": 1}),
    "var_biased": ("var", [A(B3)], {"axis": [0, 2], "unbiased": False}),
    "median_even": ("median", [A(X)], {"axis": 1}),
    "median_odd_keep": ("median", [A(X)], {"axis": 0, "keepdim": True}),
    "median_all": ("median", [A(B3)], {}),
    "quantile": ("quantile", [A(X), 0.3], {"axis": 0}),
    "quantile_list": ("quantile", [A(B3), [0.25, 0.75]], {"axis": [1, 2]}),
    "nanmean": ("nanmean", [A(np.where(np.isinf(XN), 1.0, XN))],
                {"axis": 1}),
    "nansum": ("nansum", [A(np.where(np.isinf(XN), 1.0, XN))], {}),
    "logsumexp": ("logsumexp", [A(B3)], {"axis": [0, 2]}),
    "logsumexp_all": ("logsumexp", [A(X)], {}),
    "cumprod": ("cumprod", [A(X)], {"dim": 1}),
    "cummax_ties": ("cummax", [A(TIES)], {"axis": 1}),
    "cummin_ties": ("cummin", [A(TIES)], {"axis": 1}),
    "cummax_flat": ("cummax", [A(TIES)], {}),
    "logcumsumexp": ("logcumsumexp", [A(X)], {"axis": 1}),
    "mm": ("mm", [A(X), A(W)], {}),
    "dot": ("dot", [A(X), A(Y)], {}),
    "inner": ("inner", [A(X), A(Y)], {}),
    "outer": ("outer", [A(X[0]), A(Y)], {}),
    "addmm": ("addmm", [A(np.ones((3, 5), np.float32)), A(X), A(W)],
              {"beta": 0.5, "alpha": 2.0}),
    "bmm": ("bmm", [A(B3), A(np.swapaxes(B3, 1, 2))], {}),
    "kron": ("kron", [A(X[:2, :2]), A(Y[:2, :3])], {}),
    "trace": ("trace", [A(SQ)], {"offset": 1}),
    "diagonal": ("diagonal", [A(B3)], {"offset": 1, "axis1": 1,
                                       "axis2": 2}),
    "mv": ("mv", [A(X), A(W[:, 0])], {}),
    "dist": ("dist", [A(X), A(Y)], {}),
    "dist_inf": ("dist", [A(X), A(Y)], {"p": np.inf}),
    "dist_1": ("dist", [A(X), A(Y)], {"p": 1}),
    "accuracy_tensor": ("accuracy_tensor", [A(X), A(np.array([3, 0, 1]))],
                        {}),
    # manipulation: the rest
    "t": ("t", [A(X)], {}),
    "t_vector": ("t", [A(X[0])], {}),
    "unstack": ("unstack", [A(B3)], {"axis": 2}),
    "expand_as": ("expand_as", [A(X[:1]), A(B3)], {}),
    "broadcast_shape": ("broadcast_shape", [[3, 1, 4], [2, 1]], {}),
    "broadcast_tensors": ("broadcast_tensors", [[A(X[:1]), A(B3)]], {}),
    "flip": ("flip", [A(B3)], {"axis": [0, 2]}),
    "roll": ("roll", [A(X)], {"shifts": 1, "axis": 1}),
    "roll_flat": ("roll", [A(X)], {"shifts": -2}),
    "rot90": ("rot90", [A(B3)], {"k": 3, "axes": [1, 2]}),
    "cast_manip": ("cast", [A(X), "float64"], {}),
    "put_along_axis": ("put_along_axis",
                       [A(X), A(np.array([[0], [2], [1]])), 9.0, 1], {}),
    "put_along_axis_add": ("put_along_axis",
                           [A(X), A(np.array([[0, 1], [2, 2], [3, 0]])),
                            A(Y[:, :2]), 1], {"reduce": "add"}),
    "put_along_axis_mul": ("put_along_axis",
                           [A(X), A(np.array([[1, 2]])), A(P[:1, :2]), 0],
                           {"reduce": "mul"}),
    "scatter": ("scatter", [A(X), A(np.array([2, 0])), A(Y[:2])], {}),
    "scatter_add": ("scatter", [A(X), A(np.array([2, 2])), A(Y[:2])],
                    {"overwrite": False}),
    "scatter_nd_add": ("scatter_nd_add",
                       [A(X), A(np.array([[0, 1], [2, 3], [0, 1]])),
                        A(np.array([1.0, 2.0, 3.0], np.float32))], {}),
    "scatter_nd": ("scatter_nd", [A(np.array([[1], [3], [1]])),
                                  A(Y[:, :2]), [5, 2]], {}),
    "index_sample": ("index_sample", [A(X), A(np.array([[0, 3], [1, 1],
                                                        [2, 0]]))], {}),
    "index_add": ("index_add", [A(X), A(np.array([0, 2, 0])), 1, A(Y[:, :3])],
                  {}),
    "masked_select": ("masked_select", [A(X), A(MASK)], {}),
    "masked_select_bcast": ("masked_select", [A(B3), A(MASK[0])], {}),
    "nonzero": ("nonzero", [A(MASK)], {}),
    "nonzero_tuple": ("nonzero", [A(MASK)], {"as_tuple": True}),
    "strided_slice": ("strided_slice", [A(B3)], {
        "axes": [1, 2], "starts": [0, 3], "ends": [3, -5], "strides": [2, -1]}),
    "crop": ("crop", [A(B3)], {"shape": [1, 2, 3], "offsets": [1, 1, 0]}),
    "getitem": ("getitem", [A(B3), (1, slice(None), [0, 2])], {}),
    "getitem_mask": ("getitem", [A(X), A(MASK)], {}),
    "searchsorted": ("searchsorted", [A(np.sort(X, 1)), A(Y)], {}),
    "searchsorted_right": ("searchsorted", [A(np.sort(X[0])), A(X)],
                           {"right": True, "out_int32": True}),
    "unique": ("unique", [A(TIES)], {}),
    "unique_all": ("unique", [A(TIES)], {"return_index": True,
                                         "return_inverse": True,
                                         "return_counts": True}),
    "unique_rows": ("unique", [A(np.array([[1, 2], [0, 1], [1, 2]]))],
                    {"axis": 0, "return_inverse": True,
                     "return_counts": True}),
    "unique_consecutive": ("unique_consecutive", [A(TIES)],
                           {"return_inverse": True, "return_counts": True}),
    "unique_consecutive_rows": ("unique_consecutive",
                                [A(np.array([[1, 2], [1, 2], [0, 1]]))],
                                {"axis": 0}),
    "bincount": ("bincount", [A(np.array([0, 3, 3, 1, 5]))], {}),
    "bincount_weights": ("bincount", [A(np.array([0, 3, 3, 1])),
                                      A(np.array([0.5, 1, 2, 3], np.float32))],
                         {"minlength": 6}),
    "histogram": ("histogram", [A(X)], {"bins": 5}),
    "histogram_range": ("histogram", [A(X)], {"bins": 4, "min": -1,
                                              "max": 1}),
    "pad_constant": ("pad", [A(B3), [1, 0, 0, 2, 1, 1]], {"value": 3.0}),
    "pad_reflect": ("pad", [A(IMG), [1, 2, 2, 1]], {"mode": "reflect"}),
    "pad_replicate": ("pad", [A(IMG), [1, 2, 2, 1]], {"mode": "replicate"}),
    "pad_circular": ("pad", [A(IMG), [1, 2, 2, 1]], {"mode": "circular"}),
    "pad_nhwc": ("pad", [A(IMG), [1, 0, 0, 2]], {"data_format": "NHWC"}),
    "atleast_1d": ("atleast_1d", [A(np.float32(2.0))], {}),
    "atleast_2d": ("atleast_2d", [A(X[0]), A(X)], {}),
    "atleast_3d": ("atleast_3d", [A(X[0])], {}),
    "as_real": ("as_real", [A(C64)], {}),
    "as_complex": ("as_complex", [A(np.stack([X, Y], -1))], {}),
    "real": ("real", [A(C64)], {}),
    "imag": ("imag", [A(C64)], {}),
    "imag_of_real": ("imag", [A(X)], {}),
    "conj": ("conj", [A(C64)], {}),
    "moveaxis": ("moveaxis", [A(B3), [0, 1], [2, 0]], {}),
    "swapaxes": ("swapaxes", [A(B3), 0, 2], {}),
    "transpose_": ("transpose_", [A(B3), 1, 2], {}),
    "builtins_sum": ("builtins_sum", [[1, 2, 3]], {}),
}


def _fn(pkg, name):
    """The package's top-level function, else its ``ops`` module's."""
    if hasattr(pkg, name):
        return getattr(pkg, name)
    for mod in ("math", "manipulation", "creation"):
        m = getattr(pkg.ops, mod)
        if hasattr(m, name):
            return getattr(m, name)
    raise AttributeError(name)


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_reference(case):
    name, args, kw = CASES[case]
    want = _flat(_fn(paddle, name)(*[_conv(paddle, a) for a in args], **kw))
    got = _flat(_fn(tp, name)(*[_conv(tp, a) for a in args], **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (int, float)):  # broadcast_shape, builtins_sum
            assert g == w
            continue
        assert isinstance(g, tp.Tensor) and g.device.type == "cpu"
        (gv, gn), (wv, wn) = as_numpy(g), as_numpy(w)
        assert gn == wn, (gn, wn)
        assert gv.shape == wv.shape, (gv.shape, wv.shape)
        if gv.dtype.kind in "fc":
            tol = (1e-4, 1e-5) if name in SPECIAL else (1e-5, 1e-6)
            np.testing.assert_allclose(gv, wv, rtol=tol[0], atol=tol[1],
                                       equal_nan=True)
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
    "gaussian": (lambda pk: pk.gaussian([4000], mean=-1.0, std=0.5), -np.inf,
                 np.inf, -1.0, 0.5),
    "standard_normal": (lambda pk: pk.standard_normal([4000]), -np.inf,
                        np.inf, 0.0, 1.0),
    "randint_like": (lambda pk: pk.randint_like(
        pk.to_tensor(np.zeros(4000, np.int32)), 3, 7), 3, 6, 4.5,
        (15 / 12) ** 0.5),
    "randperm": (lambda pk: pk.randperm(4000), 0, 3999, 1999.5,
                 ((4000 ** 2 - 1) / 12) ** 0.5),
    "bernoulli": (lambda pk: pk.bernoulli(pk.to_tensor(
        np.full(4000, 0.3, np.float32))), 0.0, 1.0, 0.3, 0.21 ** 0.5),
    "multinomial": (lambda pk: pk.multinomial(pk.to_tensor(
        np.array([1.0, 2.0, 3.0, 4.0], np.float32)), 4000, replacement=True),
        0, 3, 2.0, 1.0),
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


def test_randperm_is_a_permutation_and_multinomial_without_replacement():
    tp.seed(3)
    assert sorted(tp.randperm(50).tolist()) == list(range(50))
    rows = tp.multinomial(tp.to_tensor(np.ones((3, 8), np.float32)), 8)
    assert rows.shape == (3, 8) and rows.dtype == torch.int64
    for r in rows.tolist():
        assert sorted(r) == list(range(8))


def test_random_ops_take_a_dtype():
    assert tp.rand([2], dtype="bfloat16").dtype == torch.bfloat16
    assert tp.randint(0, 5, [3], dtype="int32").dtype == torch.int32
    assert tp.randint(5, shape=[3]).max() < 5
