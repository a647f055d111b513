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
``flash_attention_plain`` and ``flash_attention_bwd_plain`` are the exact
masked-softmax formula and its gradients with every sum in f32; on bf16
inputs they round where the reference's kernels round (P before P V in the
forward; P before dV = P^T dO, and dS before dQ = dS K and dK = dS^T Q in
the backward).

The three are PyTorch operators (``torch.library.custom_op``):
``torch.ops.paddle_tpu_torch.flash_attention_fwd``, ``flash_attention_dq``
and ``flash_attention_dkv``, each with a fake implementation (output shapes
from q and k, symbolic batch and length included), and the forward with its
gradient (delta in plain PyTorch, then the dQ and dK/dV operators). So
``torch.export`` records one forward node where attention runs, and a
replay of the exported program launches the kernels. An operator's
implementation takes the device of its tensors: on the CPU the plain
versions, on CUDA the kernels (each launch counted in ``launches`` when it
happens, so every replay counts) or an error; any other device raises.
``flash_attention_array`` is the differentiable entry; on the CUDA route
the kernels' tile resolves through the kernel registry (``flash_attention``,
whose one choice is the forward's compile-time 128 x 128 tile) inside the
operator, from the concrete shapes of the call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .builtin import flash_attention_key
from .registry import launch_config

__all__ = ["flash_attention_array", "flash_attention_plain",
           "flash_attention_bwd_plain", "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "launches", "flops"]

# kernel launches per kernel since the last reset (plain calls excluded)
launches = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
            "flash_attention_dkv": 0}
# the matmul FLOPs of those launches (2 * M * N * K a product, the causal
# half): the hand-written kernels' work, which torch's FlopCounterMode
# cannot see (auto_parallel's plan cost adds it)
flops = {"flash_attention_fwd": 0, "flash_attention_dq": 0,
         "flash_attention_dkv": 0}
# products of T x T_kv x D a launch computes: QK^T and PV; S again, dP and
# dQ; S again, dP, dV and dK
_PRODUCTS = {"flash_attention_fwd": 2, "flash_attention_dq": 3,
             "flash_attention_dkv": 4}


def _count(name, q, k, causal):
    B, T, H, D = q.shape
    f = 2 * _PRODUCTS[name] * B * H * T * k.shape[1] * D
    launches[name] += 1
    flops[name] += f // 2 if causal else f

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DIMS = (_I, _I, _I, _I, _I, _F, _I, _P)  # B, H, T, Tk, D, scale, causal, stream
_SIGS = {
    "pt_flash_fwd": ((_I, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
    "pt_flash_dq": ((_I, _P, _P, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
    "pt_flash_dkv": ((_I, _P, _P, _P, _P, _P, _P, _P, _P, _P) + _DIMS, _I),
}


def _scores(q, k, causal):
    """scale * Q K^T in f32, (B, H, T, T_kv), masked entries at -1e30 (top
    left aligned)."""
    T, Tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        keep = torch.ones(T, Tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _rounded(x, dtype):
    """x rounded to ``dtype`` and back to f32 (the identity in f32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def flash_attention_plain(q, k, v, causal=False):
    """The exact formula: returns (O in q's dtype, LSE (B, H, T) f32). In f32
    the probabilities are normalised before P V. Otherwise, as the
    reference's kernels (``_fwd_kernel_hd``): P = exp(s - m) is rounded to
    q's dtype before P V, and the f32 product is divided by the f32 row sum
    of the unrounded P."""
    s = _scores(q, k, causal)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1).clamp_min(1e-30)
    lse = m + torch.log(l)
    if q.dtype == torch.float32:
        o = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                         v.float())
    else:
        o = torch.einsum("bhqk,bkhd->bqhd", _rounded(p, q.dtype),
                         v.float()) / l.transpose(1, 2)[..., None]
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, do, o, lse, causal=False):
    """(dQ, dK, dV) in q's dtype from the forward's O and LSE, as the
    reference's ``_flash_hd_bwd_inner`` computes them: delta = rowsum(dO O)
    and P = exp(s - LSE) in f32; dV = P^T dO with P rounded to q's dtype;
    dS = P (dO V^T - delta); dQ = scale (dS K) with dS rounded, and
    dK = (scale dS)^T Q with scale dS rounded; every sum in f32."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return _bwd_plain(q, k, v, do, lse, delta, causal)


def _bwd_plain(q, k, v, do, lse, delta, causal, dq=True, dkv=True):
    """``flash_attention_bwd_plain`` from delta (B, H, T): dQ if ``dq``,
    then dK and dV if ``dkv``, as a tuple."""
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dof = do.float()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
              - delta[..., None])
    out = ()
    if dq:
        out += ((torch.einsum("bhqk,bkhd->bqhd", _rounded(ds, dt), k.float())
                 * scale).to(dt),)
    if dkv:
        dk = torch.einsum("bhqk,bqhd->bkhd", _rounded(ds * scale, dt),
                          q.float())
        dv = torch.einsum("bhqk,bqhd->bkhd", _rounded(p, dt), dof)
        out += (dk.to(dt), dv.to(dt))
    return out


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
    _count("flash_attention_fwd", q, k, causal)
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
    _count("flash_attention_dq", q, k, causal)
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
    _count("flash_attention_dkv", q, k, causal)
    return dk, dv


_TILE = (128, 128)  # FwdWg's BM x BN in csrc/flash_attention.cu


def _tile(q, k, causal, block_q, block_k):
    """Raise unless the tile is the kernels' own; 0 takes the registry's
    resolved config at the call's concrete shapes."""
    if not block_q or not block_k:
        B, T, H, D = q.shape
        cfg = launch_config("flash_attention", flash_attention_key, B, H, T,
                            k.shape[1], D, q.dtype, causal)
        block_q = block_q or cfg["block_q"]
        block_k = block_k or cfg["block_k"]
    if (int(block_q), int(block_k)) != _TILE:
        raise ValueError(f"flash_attention_array: the kernels' tile is "
                         f"{_TILE[0]} x {_TILE[1]}, got {block_q} x {block_k}")


def _route(name, q):
    """"cpu" or "cuda", from the tensors' device; any other raises."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")
    return q.device.type


@torch.library.custom_op("paddle_tpu_torch::flash_attention_fwd",
                         mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            block_q: int, block_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    if _route("flash_attention_fwd", q) == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal)
        return o.contiguous(), lse.contiguous()
    _tile(q, k, causal, block_q, block_k)
    return flash_attention_fwd(q, k, v, causal)


@_fwd_op.register_fake
def _fwd_fake(q, k, v, causal, block_q, block_k):
    B, T, H, D = q.shape
    return q.new_empty((B, T, H, D)), q.new_empty((B, H, T),
                                                  dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_dq",
                         mutates_args=())
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
           causal: bool) -> torch.Tensor:
    if _route("flash_attention_dq", q) == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal,
                          dkv=False)[0].contiguous()
    return flash_attention_dq(q, k, v, do, lse, delta, causal)


@_dq_op.register_fake
def _dq_fake(q, k, v, do, lse, delta, causal):
    return q.new_empty(q.shape)


@torch.library.custom_op("paddle_tpu_torch::flash_attention_dkv",
                         mutates_args=())
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if _route("flash_attention_dkv", q) == "cpu":
        dk, dv = _bwd_plain(q, k, v, do, lse, delta, causal, dq=False)
        return dk.contiguous(), dv.contiguous()
    return flash_attention_dkv(q, k, v, do, lse, delta, causal)


@_dkv_op.register_fake
def _dkv_fake(q, k, v, do, lse, delta, causal):
    return q.new_empty(k.shape), q.new_empty(k.shape)


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal = inputs[:4]
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal = causal
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _):
    """delta in plain PyTorch, then the dQ and dK/dV operators; the LSE
    carries no gradient."""
    q, k, v, o, lse = ctx.saved_tensors
    do = do.to(q.dtype)
    delta = _delta(do, o)
    dq = _dq_op(q, k, v, do, lse, delta, ctx.causal)
    dk, dv = _dkv_op(q, k, v, do, lse, delta, ctx.causal)
    return dq, dk, dv, None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def flash_attention_array(q, k, v, causal=False, block_q=None, block_k=None):
    """q (B, T, H, D), k/v (B, T_kv, H, D) → O (B, T, H, D), differentiable.
    k and v are cast to q's dtype, as the reference does. On the card
    ``block_q``/``block_k`` default to the registry's resolved config; the
    kernels' tile is fixed by their ``wgmma`` design, so 128 x 128 is the
    one value they take. The plain versions take no tile."""
    k = k.to(q.dtype)
    v = v.to(q.dtype)
    _route("flash_attention_array", q)
    o, _ = _fwd_op(q, k, v, bool(causal), int(block_q or 0),
                   int(block_k or 0))
    return o
