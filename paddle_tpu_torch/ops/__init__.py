"""The op library (port of ``paddle_tpu/ops``).

``Tensor`` is ``torch.Tensor``, so the reference's method attachment
(``ops/__init__.py`` ``monkey_patch_tensor``) would patch torch for every
caller. :func:`attach_tensor_methods` follows the reference's own rule
(``if not hasattr(Tensor, name)``): it sets only the method names torch's
tensor lacks and never replaces an attribute torch has. Where torch has a
method of the name with other semantics (``scatter``, ``flip``, ``t``,
``roll``, ``split``, ``uniform_``, ...), the tensor method is torch's and
the function (``paddle_tpu_torch.scatter``) is Paddle's.
:data:`TORCH_METHOD_CONFLICTS` names every such method whose Paddle-style
call gives another result than the reference's (or raises), each with the
form that gives Paddle's.
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


# The reference Tensor's methods and attributes that torch's tensor also has
# and that give another result than the reference's when called in Paddle's
# style (or raise). The tensor keeps torch's meaning (torch's own code calls
# them); the value is what gives Paddle's result. Every other name the two
# share gives the reference's result (tests/test_torch_api_parity.py holds
# both halves).
TORCH_METHOD_CONFLICTS = {
    "allclose": "paddle_tpu_torch.allclose(x, y)",  # a bool tensor
    "cumprod": "paddle_tpu_torch.cumprod(x, dim=None)",  # None: flattened
    "cumsum": "paddle_tpu_torch.cumsum(x, axis=None)",
    "dsplit": "paddle_tpu_torch.dsplit(x, sections=2)",
    "dtype": "paddle_tpu_torch.core.dtype.dtype_name(x.dtype) names it; "
             "the port's dtypes are torch's (paddle_tpu_torch.float32 is "
             "torch.float32)",
    "equal": "paddle_tpu_torch.equal(x, y)",  # elementwise
    "fill_diagonal_": "paddle_tpu_torch.fill_diagonal(x, value=0.0)",  # a copy
    "gather": "paddle_tpu_torch.gather(x, index, axis=0)",
    "imag": "paddle_tpu_torch.imag(x)",  # zeros for a real tensor
    "index_add": "paddle_tpu_torch.index_add(x, index, axis, value)",
    "index_add_": "paddle_tpu_torch.index_add(x, index, axis, value)",
    "index_fill": "paddle_tpu_torch.index_fill(x, idx, value=0.0)",
    "index_put": "paddle_tpu_torch.index_put(x, idx, v)",
    "index_select": "paddle_tpu_torch.index_select(x, index, axis=0)",
    "item": "x.flatten()[i].item() for item(i); torch's item() takes no "
            "index",
    "logsumexp": "paddle_tpu_torch.logsumexp(x, axis=None)",
    "median": "paddle_tpu_torch.median(x, axis=None)",  # mean of the middle
    "name": "Parameter.name; a plain torch tensor has no generated name",
    "nanmedian": "paddle_tpu_torch.nanmedian(x, axis=None)",
    "pin_memory": "x itself (torch's copies into pinned memory and needs a "
                  "CUDA runtime)",
    "renorm": "paddle_tpu_torch.renorm(x, p=2, axis=0, max_norm=1.0)",
    "renorm_": "paddle_tpu_torch.renorm(x, p=2, axis=0, max_norm=1.0)",
    "roll": "paddle_tpu_torch.roll(x, shifts, axis=None)",
    "scatter": "paddle_tpu_torch.scatter(x, index, updates, overwrite=True)",
    "scatter_": "paddle_tpu_torch.scatter_(x, index, updates, "
                "overwrite=True)",
    "select_scatter": "paddle_tpu_torch.select_scatter(x, src, axis=0, "
                      "index=0)",
    "shape": "list(x.shape); torch's is a torch.Size (a tuple)",
    "size": "x.numel(); torch's size is a method giving the shape",
    "slice_scatter": "paddle_tpu_torch.slice_scatter(x, src, axis=0, "
                     "start=0)",
    "solve": "paddle_tpu_torch.linalg.solve(x, y)",
    "sort": "paddle_tpu_torch.sort(x, axis=-1)",  # the values only
    "split": "paddle_tpu_torch.split(x, num_or_sections, axis=0)",
    "to": "paddle_tpu_torch.cast(x, dtype)",  # torch's reads a device
    "transpose": "paddle_tpu_torch.transpose(x, perm)",
    "unflatten": "paddle_tpu_torch.unflatten(x, axis=0, sizes=[1, 3])",
    "unfold": "paddle_tpu_torch.unfold(x, axis=0, size=2, step=1)",
    "uniform_": "paddle_tpu_torch.ops.inplace.uniform_(x, min=-1.0, "
                "max=1.0)",  # torch's draws on [0, 1)
    "vsplit": "paddle_tpu_torch.vsplit(x, sections=2)",
}


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


# the reference's name for its attachment; here it attaches only what torch's
# tensor lacks (idempotent)
monkey_patch_tensor = attach_tensor_methods

ATTACHED = attach_tensor_methods()
