"""Flash attention forward and backward (port of
``paddle_tpu/ops/pallas/flash_attention.py`` ``flash_attention_array``).

``flash_attention_array(q, k, v, causal)`` takes q (B, T, H, D) and k, v
(B, T_kv, H, D) and returns O (B, T, H, D): softmax(scale * Q K^T + mask) V
with scale = 1/sqrt(D), masked entries filled with -1e30 (k_pos >= T_kv, and
q_pos < k_pos when causal, top-left aligned as the reference does also for
T != T_kv), the row sum floored at 1e-30. The forward also returns the
per-row logsumexp (B, H, T) in f32, which the backward uses to recompute the
probabilities.

Three CUDA C++ kernels in ``csrc/flash_attention.cu`` (sm_90a) compute it:
``flash_attention_fwd`` (O and LSE), ``flash_attention_dq`` and
``flash_attention_dkv``. They read q, k, v and dO through strides in the
(B, T, H, D) layout, so the views that ``GPTAttention`` cuts out of the fused
QKV projection go in without a copy. In bf16 with D <= 128 the forward and
dK/dV are Hopper kernels (TMA loads from tensor maps built from those
strides, ``wgmma`` products); the source's header says which kernel runs
where. delta = rowsum(dO * O) is plain
PyTorch, as the reference computes it in XLA outside its kernels.
``flash_attention_plain`` is the exact masked-softmax formula in f32 with
autograd for its backward.

On a CPU tensor ``flash_attention_array`` runs the plain version; on a CUDA
tensor it launches the kernels (each launch counted in ``launches``) or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_array", "flash_attention_plain",
           "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "launches"]

# kernel launches per kernel since the last reset (plain calls excluded)
launches = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DIMS = (_I, _I, _I, _I, _I, _F, _I, _P)  # B, H, T, Tk, D, scale, causal, stream
_SIGS = {
    "pt_flash_fwd": ((_I, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
    "pt_flash_dq": ((_I, _P, _P, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
    "pt_flash_dkv": ((_I, _P, _P, _P, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
}


def flash_attention_plain(q, k, v, causal=False):
    """The exact formula in f32: returns (O in q's dtype, LSE (B, H, T) f32)."""
    D = q.shape[-1]
    T, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(D))
    if causal:
        keep = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _strided(x):
    """x as the kernels read it: unit-stride D, every row start and stride
    16-byte aligned (as TMA requires); otherwise a contiguous copy."""
    vec = 16 // x.element_size()
    if x.stride(-1) != 1 or x.data_ptr() % 16 \
            or any(s % vec for s in x.stride()[:-1]):
        x = x.contiguous()
    return x


def _check(name, q, k, v, *rest):
    if q.device.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    D = q.shape[-1]
    if D % 8 or D > 256 or 0 in q.shape or 0 in k.shape:
        raise ValueError(f"{name}: kernel takes D <= 256 with D % 8 == 0 and "
                         f"no empty axis (got q{tuple(q.shape)})")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"{name}: inputs on {t.device} and {q.device}")


def _strides(*xs):
    flat = [s for x in xs for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _dims(q, k, causal):
    B, T, H, D = q.shape
    return (B, H, T, k.shape[1], D, 1.0 / math.sqrt(D), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, causal=False):
    """Kernel: (O (B, T, H, D) in q's dtype, LSE (B, H, T) f32)."""
    _check("flash_attention_fwd", q, k, v)
    q, k, v = (_strided(x) for x in (q, k, v))
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention", _SIGS)
    strides = _strides(q, k, v)
    with torch.cuda.device(q.device):
        rc = lib.pt_flash_fwd(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                              strides, *_dims(q, k, causal))
    _build.check(rc, lib, "flash_attention_fwd")
    launches["flash_attention_fwd"] += 1
    return o, lse


def _delta(do, o):
    """rowsum(dO * O) in f32, laid out (B, H, T) like the LSE."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_args(q, k, v, do, lse, delta):
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("flash attention backward: lse and delta must be f32")
    B, T, H, _ = q.shape
    if lse.shape != (B, H, T) or delta.shape != (B, H, T) \
            or do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("flash attention backward: lse/delta must be "
                         f"{(B, H, T)} and dO like q{tuple(q.shape)}")
    q, k, v, do = (_strided(x) for x in (q, k, v, do))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_attention_dq(q, k, v, do, lse, delta, causal=False):
    """Kernel: dQ (B, T, H, D) from the forward's LSE and delta."""
    _check("flash_attention_dq", q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _SIGS)
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        rc = lib.pt_flash_dq(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                             v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                             delta.data_ptr(), dq.data_ptr(), strides,
                             *_dims(q, k, causal))
    _build.check(rc, lib, "flash_attention_dq")
    launches["flash_attention_dq"] += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False):
    """Kernel: (dK, dV), each (B, T_kv, H, D)."""
    _check("flash_attention_dkv", q, k, v, do, lse, delta)
    q, k, v, do, lse, delta = _bwd_args(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention", _SIGS)
    strides = _strides(q, k, v, do)
    with torch.cuda.device(q.device):
        rc = lib.pt_flash_dkv(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                              v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                              delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              strides, *_dims(q, k, causal))
    _build.check(rc, lib, "flash_attention_dkv")
    launches["flash_attention_dkv"] += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernels with their gradient: saves q, k, v, O and LSE; the
    backward computes delta, then launches the dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        delta = _delta(do, o)
        dq = flash_attention_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention_array(q, k, v, causal=False):
    """q (B, T, H, D), k/v (B, T_kv, H, D) → O (B, T, H, D), differentiable.
    k and v are cast to q's dtype, as the reference does."""
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_array: unsupported device {q.device}")
    return _FlashAttention.apply(q, k, v, bool(causal))
