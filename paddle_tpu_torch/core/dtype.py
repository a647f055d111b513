"""Dtypes (port of ``paddle_tpu/core/dtype.py``).

Paddle's dtype names (``paddle.float32``, ``"bfloat16"``, ``"int64"``, ...)
are ``torch.dtype`` objects here; ``convert_dtype`` also takes strings,
numpy dtypes and numpy scalar types. Ids and labels are int64, as the
reference's are under JAX's x64 mode.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_NAME_TO_DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}

_FLOATING = {float16, bfloat16, float32, float64}
_INTEGER = {uint8, int8, int16, int32, int64}
_COMPLEX = {complex64, complex128}


def convert_dtype(dtype):
    """Any user-supplied dtype spec as a ``torch.dtype`` (None stays None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype.replace("paddle.", "").replace("torch.", "")
        if name not in _NAME_TO_DTYPE:
            raise TypeError(f"Unsupported dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[name]
    try:
        name = np.dtype(dtype).name
    except TypeError:
        name = None
    if name is None and hasattr(dtype, "dtype"):
        return convert_dtype(dtype.dtype)
    if name not in _NAME_TO_DTYPE:
        raise TypeError(f"Unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING


def is_integer(dtype) -> bool:
    return convert_dtype(dtype) in _INTEGER


def is_complex(dtype) -> bool:
    return convert_dtype(dtype) in _COMPLEX


def dtype_name(dtype) -> str:
    d = convert_dtype(dtype)
    for name, v in _NAME_TO_DTYPE.items():
        if v == d:
            return name
    return str(d)


# paddle.get_default_dtype / set_default_dtype: process-wide, as the
# reference's module global
_default_dtype = float32


def set_default_dtype(d) -> None:
    global _default_dtype
    d = convert_dtype(d)
    if d not in _FLOATING:
        raise TypeError("set_default_dtype only accepts floating dtypes")
    _default_dtype = d


def get_default_dtype() -> torch.dtype:
    return _default_dtype


__all__ = ["bool_", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64", "complex64", "complex128",
           "convert_dtype", "is_floating_point", "is_integer", "is_complex",
           "dtype_name", "set_default_dtype", "get_default_dtype"]
