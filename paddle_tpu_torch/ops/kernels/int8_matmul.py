"""Weight-only int8 matmul (port of ``paddle_tpu/ops/kernels/int8_matmul.py``
``int8_matmul``).

``x @ dequant(qw).T`` (``transpose_w``, the GPT tied head, weight stored
``(N, K)``) or ``x @ dequant(qw)`` (the Llama head, ``(K, N)``), where
``dequant`` is exactly ``(q.float() * (scale / 127)).to(x.dtype)`` with one
per-tensor f32 scale — the expression ``serving/int8.dequantize_tree`` uses.
The kernels are in ``csrc/int8_matmul.cu`` (CUDA C++, sm_90a). In bf16
(the serving head) ``int8_matmul_mma`` streams the int8 weight through a
``cp.async`` ring in shared memory, dequantizes it exactly in registers and
multiplies on the tensor cores (``mma.sync``, f32 sums); f32 runs a CUDA-core
kernel. No dense copy of the weight is ever written. ``int8_matmul_plain``
is dequantize-then-matmul (``int8_dequant``, then ``@``).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel (and counts the launch in ``launches``) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["int8_matmul", "int8_matmul_plain", "int8_dequant", "launches"]

launches = 0  # kernel launches since the last reset (plain calls excluded)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"pt_int8_matmul": ((_I, _I, _P, _P, _P, _P, _I, _I, _I, _P), _I)}


def int8_dequant(qw, scale, dtype):
    """``(qw.float() * (scale / 127)).to(dtype)``, the reference's dequant;
    a tensor divisor keeps scale/127 a true f32 division on every device."""
    return (qw.float() * (scale / scale.new_tensor(127.0))).to(dtype)


def int8_matmul_plain(x, qw, scale, transpose_w=True):
    wd = int8_dequant(qw, scale, x.dtype)
    return x @ (wd.T if transpose_w else wd)


def int8_matmul(x, qw, scale, transpose_w=True):
    """x (..., K); qw int8 ``(N, K)`` if transpose_w else ``(K, N)``; scale a
    0-d f32 tensor. Leading dims of x are flattened into rows and restored."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qw, scale, transpose_w)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_matmul: dtype {x.dtype} not supported")
    if qw.dtype != torch.int8 or qw.dim() != 2:
        raise TypeError("int8_matmul: qw must be a 2-D int8 tensor")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("int8_matmul: scale must be one float32 value")
    if qw.device != x.device or scale.device != x.device:
        raise ValueError("int8_matmul: x, qw and scale must share a device")
    N = qw.shape[0] if transpose_w else qw.shape[1]
    if (qw.shape[1] if transpose_w else qw.shape[0]) != K or M == 0:
        raise ValueError(f"int8_matmul: x{tuple(x.shape)} against "
                         f"qw{tuple(qw.shape)} transpose_w={transpose_w}")
    if not (x2.is_contiguous() and qw.is_contiguous()):
        raise ValueError("int8_matmul: x and qw must be contiguous")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("int8_matmul", _SIGS)
    with torch.cuda.device(x.device):
        rc = lib.pt_int8_matmul(
            _DTYPES[x.dtype], int(bool(transpose_w)), x2.data_ptr(),
            qw.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, lib, "int8_matmul")
    global launches
    launches += 1
    return out.reshape(*lead, N)
