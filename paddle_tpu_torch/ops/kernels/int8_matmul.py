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
launches the kernel (and counts the launch in ``launches``) or raises. On
the CUDA route the bf16 kernel's weight rows a block resolve through the
kernel registry (``int8_matmul``: ``block_n`` 384 with
``FLAGS_kernel_autotune=off``, or 192); the plain version takes no config.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .registry import dtype_name, launch_config, pow2, register_kernel

__all__ = ["int8_matmul", "int8_matmul_plain", "int8_dequant",
           "int8_matmul_key", "launches"]

launches = 0  # kernel launches since the last reset (plain calls excluded)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"pt_int8_matmul": ((_I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I),
                             _I)}
_BLOCK_N = (384, 192)  # the bf16 kernel's weight rows a block (KR = 2, 1)


def int8_matmul_key(M, K, N, transpose_w, dtype) -> tuple:
    """Shape bucket: M (the decode batch) rounded up to a power of two; K
    and N are weight dims and exact."""
    return (pow2(M), int(K), int(N), bool(transpose_w), dtype_name(dtype))


def int8_dequant(qw, scale, dtype):
    """``(qw.float() * (scale / 127)).to(dtype)``, the reference's dequant;
    a tensor divisor keeps scale/127 a true f32 division on every device."""
    return (qw.float() * (scale / scale.new_tensor(127.0))).to(dtype)


def int8_matmul_plain(x, qw, scale, transpose_w=True):
    wd = int8_dequant(qw, scale, x.dtype)
    return x @ (wd.T if transpose_w else wd)


def int8_matmul(x, qw, scale, transpose_w=True, config=None):
    """x (..., K); qw int8 ``(N, K)`` if transpose_w else ``(K, N)``; scale a
    0-d f32 tensor. Leading dims of x are flattened into rows and restored.
    ``config``: the kernel's ``{"block_n": 384 or 192}``; None resolves it
    through the registry."""
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
    if config is None:
        config = launch_config("int8_matmul", int8_matmul_key, M, K, N,
                               transpose_w, x.dtype)
    block_n = int(config["block_n"])
    if block_n not in _BLOCK_N:
        raise ValueError(f"int8_matmul: block_n {block_n} not one of "
                         f"{_BLOCK_N}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _build.load("int8_matmul", _SIGS)
    with torch.cuda.device(x.device):
        rc = lib.pt_int8_matmul(
            _DTYPES[x.dtype], int(bool(transpose_w)), x2.data_ptr(),
            qw.data_ptr(), scale.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream, block_n)
    _build.check(rc, lib, "int8_matmul")
    global launches
    launches += 1
    return out.reshape(*lead, N)


# -- registry ----------------------------------------------------------------

def _valid(config, key):
    # the f32 CUDA-core kernel ignores block_n: only its default is a config
    return key[4] == "bfloat16" or int(config["block_n"]) == _BLOCK_N[0]


def _runner(key):
    """x, an int8 weight quantized from a normal one and its scale at the
    bucketed shape, on the card, as the reference's runner builds them."""
    M, K, N, transpose_w, dtype = key
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(
        "cuda", getattr(torch, dtype))
    w = rng.randn(*((N, K) if transpose_w else (K, N))).astype(np.float32)
    s = np.float32(np.abs(w).max())
    qw = torch.from_numpy(np.clip(np.round(w / (s / np.float32(127.0))),
                                  -127, 127).astype(np.int8)).cuda()
    scale = torch.tensor(s, dtype=torch.float32, device="cuda")

    def make(config):
        return lambda: int8_matmul(x, qw, scale, transpose_w, config=config)

    return make


register_kernel(
    "int8_matmul",
    defaults={"block_n": _BLOCK_N[0]},
    space={"block_n": _BLOCK_N},
    runner=_runner,
    valid=_valid,
    source="int8_matmul",
)
