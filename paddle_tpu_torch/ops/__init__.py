"""The op library (port of ``paddle_tpu/ops``).

``Tensor`` is ``torch.Tensor``, so the reference's method attachment
(``ops/__init__.py`` ``monkey_patch_tensor``) would patch torch for every
caller. :func:`attach_tensor_methods` follows the reference's own rule
(``if not hasattr(Tensor, name)``): it sets only the method names torch's
tensor lacks and never replaces an attribute torch has. Where torch has a
method of the name with other semantics (``scatter``, ``flip``, ``t``,
``roll``, ``split``, ``uniform_``, ...), the tensor method is torch's and
the function (``paddle_tpu_torch.scatter``) is Paddle's.
"""
from __future__ import annotations

# the reference's method lists (math, manipulation, linalg)
_MATH_METHODS = (
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "matmul", "mm", "dot", "inner", "outer", "bmm", "addmm",
    "kron", "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt",
    "rsqrt", "abs", "sign", "floor", "ceil", "round", "trunc", "frac", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "asinh",
    "acosh", "atanh", "erf", "erfinv", "reciprocal", "square", "digamma",
    "lgamma", "sigmoid", "clip", "lerp", "maximum", "minimum", "fmax",
    "fmin", "atan2", "sum", "mean", "max", "min", "prod", "std", "var",
    "median", "nanmean", "nansum", "logsumexp", "argmax", "argmin", "cumsum",
    "cumprod", "all", "any", "isnan", "isinf", "isfinite", "equal",
    "not_equal", "greater_than", "greater_equal", "less_than", "less_equal",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "allclose", "isclose",
    "equal_all", "cast", "scale", "trace", "diagonal", "dist", "neg",
    "heaviside",
)
_MANIPULATION_METHODS = (
    "reshape", "reshape_", "transpose", "t", "split", "chunk", "squeeze",
    "unsqueeze", "flatten", "expand", "expand_as", "broadcast_to", "tile",
    "repeat_interleave", "flip", "roll", "gather", "gather_nd", "scatter",
    "scatter_nd_add", "index_select", "index_sample", "index_add",
    "masked_select", "masked_fill", "topk", "sort", "argsort", "unbind",
    "unique", "unique_consecutive", "nonzero", "searchsorted", "bincount",
    "take_along_axis", "put_along_axis", "moveaxis", "as_real",
    "as_complex", "real", "imag", "conj", "pad", "unstack",
)
_LINALG_METHODS = ("cholesky", "inverse", "norm", "matrix_power", "pinv",
                   "solve")


def attach_tensor_methods():
    """The reference's tensor methods (and ``astype``) that ``torch.Tensor``
    lacks, as methods; returns the names attached."""
    import torch

    from . import linalg, manipulation, math

    done = []
    for mod, names in ((math, _MATH_METHODS),
                       (manipulation, _MANIPULATION_METHODS),
                       (linalg, _LINALG_METHODS),
                       (math, ("astype",))):
        for name in names:
            if not hasattr(torch.Tensor, name):
                fn = math.cast if name == "astype" else getattr(mod, name)
                setattr(torch.Tensor, name, fn)
                done.append(name)
    return done


ATTACHED = attach_tensor_methods()
