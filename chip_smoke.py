"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run; needs one CUDA card
    python3 chip_smoke.py --profile  # + device breakdowns of a decode step
                                     #   and of a train step

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. build: every CUDA kernel source in ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, started together); prints
   ptxas's registers and spill-store bytes of every kernel instantiation;
2. kernels: each kernel against its plain PyTorch version, in float32
   (tight tolerance: checks the algorithm) and bfloat16 (loose tolerance:
   checks the working type): the serving kernels at the serving path's
   shapes; the flash-attention forward (O, LSE) and backward (dQ, dK, dV)
   at small shapes (ragged causal tails, non-causal T != T_kv, a D=40 head,
   every head width instantiation), in bf16 at the training shape and at
   the long-sequence shape (T=8192, D=64); at every shape dK/dV is launched
   twice on the same inputs, and the two must agree bit for bit;
3. engine: GPT-3 1.3B at full width (24 layers, bf16, random weights from a
   seed) through ``serving.Engine`` over 32 greedy requests, (a) with the
   paged-attention kernel and (b) int8 weights with both kernels. Launch
   counts are zeroed just before each drive and read just after it; every
   output must have exactly prompt + 64 tokens and the pool must drain.
   One decode step built with the kernels is held against the same step
   built with the plain versions on the same pool state;
5. train: GPT-3 1.3B at full width and depth (bf16, seed 0, dropout 0,
   flash attention, fused LM-head loss, AdamW lr 1e-4) through
   ``jit.compile_train_step`` on one fixed b2 x s2048 batch: 2 warm-up and
   8 timed steps; the flash counters, zeroed just before the timed steps,
   must each read 24 x 8; losses finite and falling. A 4-layer full-width
   model's gradients through the kernels are held against the same
   backward with attention on the plain version. Runs before phase 4, so
   the timing rows carry its launch counts;
4. timing: each kernel (CUDA events) beside its plain version, the card's
   least time for the same work, and a one-call PyTorch yardstick where
   one exists; the flash kernels also with their TFLOP/s and the host time
   of one call, at the training shape and at the long-sequence shape.

The last three lines of stdout are the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``; the line before them,
``{"flash_long_shape": [...]}``, holds the flash kernels' times at the
long-sequence shape (no launches on the main path).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per second

# tolerances: |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # f32: the same math summed in another order
    ("paged_attention_rows", torch.float32): (1e-5, 1e-5),
    ("int8_matmul", torch.float32): (1e-3, 1e-4),
    # bf16: the kernel keeps f32 inside and rounds once; the plain version
    # rounds scores/probabilities (attention) or only the output (matmul)
    ("paged_attention_rows", torch.bfloat16): (1e-2, 1e-2),
    ("int8_matmul", torch.bfloat16): (1e-1, 1e-2),
    # flash f32: online vs direct softmax, sums in another order; the
    # gradients sum T products each
    ("flash_attention_fwd", torch.float32): (1e-5, 1e-5),
    ("flash_attention_lse", torch.float32): (1e-5, 1e-5),
    ("flash_attention_dq", torch.float32): (1e-4, 1e-4),
    ("flash_attention_dkv", torch.float32): (1e-4, 1e-4),
    # flash bf16 against the f32 plain version on the same bf16 inputs: the
    # kernel rounds P to bf16 before P V and O once at the end; the LSE
    # stays f32 from the same exact bf16 products
    ("flash_attention_fwd", torch.bfloat16): (2e-2, 2e-2),
    ("flash_attention_lse", torch.bfloat16): (1e-3, 1e-3),
}
LOGITS_REL_TOL = 5e-2  # ||kernel - plain|| / ||plain|| of a full bf16 step
# bf16 flash gradients: ||kernel - plain|| / ||plain||; P and dS are rounded
# to bf16 before their products and each gradient once at the end (~0.3%)
FLASH_GRAD_REL_TOL = 2e-2
# bf16 flash O, the same norm: P rounded to bf16 before P V and O once at the
# end (~0.3%); the elementwise O tolerance alone is loose where |O| is small
# (|O| ~ sqrt(e / T) for unit-normal inputs)
FLASH_O_REL_TOL = 1e-2
# 4-layer full-width GPT, one bf16 backward through the kernels against the
# same backward with attention on the plain version: per parameter
# ||g_kernel - g_plain|| / ||g_plain||; bf16 rounding of activations and
# gradients through 4 layers and the fused LM head
GRAD_REL_TOL = 5e-2
TRAIN_LAYERS_CHECK = 4
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# (B, T, T_kv, H, D, causal): the training shape of GPT-3 1.3B at b2 x s2048,
# and the long-sequence shape of bench.py's bench_gpt_8k_flash (hidden 1024,
# 16 heads, T=8192), where the reference takes its (B*H, T, D) route
FLASH_TRAIN = (2, 2048, 2048, 16, 128, True)
FLASH_LONG = (1, 8192, 8192, 16, 64, True)
_FA = "paddle_tpu/ops/pallas/flash_attention.py"
FLASH_REPLACES = {  # the TPU entry points each kernel takes over
    "flash_attention_fwd": f"{_FA}:719 (_flash_hd_fwd_inner); {_FA}:321 "
                           "(_flash_fwd_inner)",
    "flash_attention_dq": f"{_FA}:750 (_flash_hd_bwd_inner, dQ); {_FA}:1038 "
                          "(_flash_bwd_inner, dQ)",
    "flash_attention_dkv": f"{_FA}:750 (_flash_hd_bwd_inner, dK/dV); "
                           f"{_FA}:1038 (_flash_bwd_inner, dK/dV)",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20) -> float:
    """Device time per call: a sleep kernel keeps the card busy while the
    host queues every launch, so host overhead is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, dtype, out, ref):
    atol, rtol = TOL[(name, dtype)]
    out, ref = out.detach().float(), ref.detach().float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {dtype}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
             "or non-finite output")
    err = (out - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = float(err.max())
    print(f"  {name} {str(dtype)[6:]}: max_abs_err={max_err:.3e} "
          f"(atol={atol}, rtol={rtol}) {'ok' if not bad else 'MISMATCH'}")
    if bad:
        fail(f"{name} {dtype}: {bad} elements outside tolerance")
    return max_err


# -- kernel phase ------------------------------------------------------------

def paged_inputs(dtype, rep=1, B=32, KV=16, D=128, BS=16, MB=64, seed=0):
    """One layer's pool with per-row disjoint live blocks (dead table
    columns at trash block 0) and ragged positions that land on and across
    block edges."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    NB = B * MB + 1
    kpool = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    vpool = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, KV * rep, D, generator=g, device="cuda").to(dtype)
    pos = rng.randint(128, MB * BS, size=B)
    pos[:6] = [0, BS - 1, BS, 2 * BS - 1, 2 * BS, MB * BS - 1]
    perm = rng.permutation(np.arange(1, NB)).reshape(B, MB)
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        n_live = pos[b] // BS + 1
        tables[b, :n_live] = perm[b, :n_live]
    return (q, kpool, vpool, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos.astype(np.int32)).cuda())


def int8_inputs(dtype, M, transpose_w, K=2048, N=50304, seed=0):
    from paddle_tpu_torch.serving.int8 import quantize_to_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn(N, K, generator=g, device="cuda") * 0.02
    qw, scale = quantize_to_int8(w)
    if not transpose_w:
        qw = qw.T.contiguous()
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    return x, qw, torch.tensor(scale, dtype=torch.float32, device="cuda")


def kernel_phase():
    from paddle_tpu_torch.ops import kernels as K

    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rep in (1, 2):
            args = paged_inputs(dtype, rep=rep)
            out = K.paged_attention_rows(*args)
            torch.cuda.synchronize()
            e = compare("paged_attention_rows", dtype, out,
                        K.paged_attention_rows_plain(*args))
            if rep == 1:
                errs[("paged_attention_rows", dtype)] = e
        for M in (4, 32):
            for tw in (True, False):
                x, qw, s = int8_inputs(dtype, M, tw)
                out = K.int8_matmul(x, qw, s, transpose_w=tw)
                torch.cuda.synchronize()
                e = compare("int8_matmul", dtype, out,
                            K.int8_matmul_plain(x, qw, s, transpose_w=tw))
                if M == 32 and tw:
                    errs[("int8_matmul", dtype)] = e
    return errs


def flash_inputs(B, T, Tk, H, D, dtype, fused_qkv=False, seed=0):
    """q, k, v (and a cotangent dO) on the card. ``fused_qkv``: q, k, v are
    strided views of one (B, T, 3, H, D) tensor, as GPTAttention cuts them
    out of the QKV projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    if fused_qkv:
        q, k, v = rnd(B, T, 3, H, D).unbind(2)
    else:
        q, k, v = rnd(B, T, H, D), rnd(B, Tk, H, D), rnd(B, Tk, H, D)
    return q, k, v, rnd(B, T, H, D)


def flash_delta(do, o):
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def rel_err(out, ref):
    out, ref = out.detach().float(), ref.detach().float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        return float("inf")
    return float((out - ref).norm() / ref.norm().clamp_min(1e-30))


def flash_check(B, T, Tk, H, D, causal, dtype, fused_qkv=False):
    """The three flash kernels against the plain version (f32, autograd for
    the gradients) on the same inputs; a second dK/dV launch on the same
    inputs must agree bit for bit. Returns the max abs error per kernel
    (dkv: over dK and dV)."""
    from paddle_tpu_torch.ops import kernels as K

    q, k, v, do = flash_inputs(B, T, Tk, H, D, dtype, fused_qkv)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    delta = flash_delta(do, o)
    dq = K.flash_attention_dq(q, k, v, do, lse, delta, causal)
    dk, dv = K.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    dk2, dv2 = K.flash_attention_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    po, plse = K.flash_attention_plain(qf, kf, vf, causal)
    gq, gk, gv = torch.autograd.grad(po, (qf, kf, vf), do.float())
    print(f"  flash B={B} T={T} T_kv={Tk} H={H} D={D} causal={causal} "
          f"{str(dtype)[6:]}{' (strided q/k/v views)' if fused_qkv else ''}:")
    errs = {"flash_attention_fwd": compare("flash_attention_fwd", dtype, o, po)}
    compare("flash_attention_lse", dtype, lse, plse)
    pairs = {"flash_attention_dq": [(dq, gq)],
             "flash_attention_dkv": [(dk, gk), (dv, gv)]}
    if dtype == torch.bfloat16:
        pairs["flash_attention_fwd"] = [(o, po)]
    for name, outs in pairs.items():
        if dtype == torch.float32:
            errs[name] = max(compare(name, dtype, a, b) for a, b in outs)
            continue
        rels = [rel_err(a, b) for a, b in outs]
        errs[name] = max(float((a.float() - b).abs().max()) for a, b in outs)
        tol = FLASH_O_REL_TOL if name == "flash_attention_fwd" \
            else FLASH_GRAD_REL_TOL
        ok = max(rels) <= tol
        print(f"  {name} bf16: rel_norm_err={max(rels):.3e} max_abs_err="
              f"{errs[name]:.3e} (tol rel {tol}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} bf16: relative error {max(rels):.3e}")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        fail("flash_attention_dkv: two launches on the same inputs differ")
    print("  flash_attention_dkv: two launches bitwise equal")
    return errs


def flash_phase():
    """Small shapes in f32 and bf16 (every head-width instantiation, a D=40
    head that TMA zero-fills to a 64-column panel, ragged causal tails at
    T=200 and T=1000, non-causal T != T_kv with ragged T_kv, causal T <
    T_kv), then bf16 at the training shape through strided q/k/v views and
    at the reference's long-sequence shape. Returns the max abs errors at
    the training shape and at the long shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in ((1, 192, 192, 2, 64, True), (1, 200, 200, 3, 128, True),
                  (1, 128, 328, 2, 64, False), (1, 96, 160, 1, 256, True),
                  (2, 130, 130, 2, 32, True), (1, 256, 256, 2, 40, True),
                  (1, 1000, 1000, 2, 128, True), (1, 136, 200, 2, 64, False)):
        for dtype in (f32, bf16):
            flash_check(*shape, dtype)
    out = []
    for shape, fused in ((FLASH_TRAIN, True), (FLASH_LONG, False)):
        out.append({(n, bf16): e for n, e in
                    flash_check(*shape, bf16, fused_qkv=fused).items()})
        torch.cuda.empty_cache()
    return out


# -- timing phase ------------------------------------------------------------

def bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def timing_phase(errs, launches):
    from paddle_tpu_torch.ops import kernels as K

    rows = []
    dt = torch.bfloat16
    es = 2
    # paged attention at the engine decode shapes
    q, kp, vp, tables, pos = paged_inputs(dt, seed=1)
    B, H, D = q.shape
    KV = kp.shape[2]
    BS = kp.shape[1]
    live = (pos.long() + 1).sum().item()
    nbytes = (2 * B * H * D * es + 2 * live * KV * D * es
              + 4 * int((pos.long() // BS + 1).sum()) + 4 * B)
    b_ms, b_by = bound(nbytes, 4 * live * H * D, dt)
    rows.append({
        "name": "paged_attention_rows", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/kernels/paged_attention.py:134",
        "launches": launches["paged_attention_rows"],
        "max_abs_err": errs[("paged_attention_rows", dt)],
        "ms": time_ms(lambda: K.paged_attention_rows(q, kp, vp, tables, pos)),
        "plain_ms": time_ms(lambda: K.paged_attention_rows_plain(
            q, kp, vp, tables, pos), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        # no single PyTorch call reads attention through a block table
        "library_ms": None,
        "shape": f"B={B} H={H} KV={KV} D={D} BS={BS} MB={tables.shape[1]} "
                 f"mean_ctx={live / B:.1f} bf16",
    })
    # int8 LM head at the decode batch
    M, Kd, N = 32, 2048, 50304
    x, qw, s = int8_inputs(dt, M, True, seed=1)
    b_ms, b_by = bound(N * Kd + M * Kd * es + M * N * es + 4, 2 * M * N * Kd, dt)
    lib_ms, lib_note = None, "none"
    try:  # one PyTorch call for an int8-weight matmul, where the build has one
        scales = s.repeat(N) / 127.0
        torch._weight_int8pack_mm(x, qw, scales.to(dt))
        lib_ms = time_ms(lambda: torch._weight_int8pack_mm(x, qw, scales.to(dt)))
        lib_note = "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        lib_note = f"torch._weight_int8pack_mm unavailable: {str(e)[:80]}"
    rows.append({
        "name": "int8_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
        "replaces": "paddle_tpu/ops/kernels/int8_matmul.py:76",
        "launches": launches["int8_matmul"],
        "max_abs_err": errs[("int8_matmul", dt)],
        "ms": time_ms(lambda: K.int8_matmul(x, qw, s, transpose_w=True)),
        "plain_ms": time_ms(lambda: K.int8_matmul_plain(x, qw, s, True), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "shape": f"M={M} K={Kd} N={N} transpose_w bf16; library: {lib_note}",
    })
    rows += flash_timing(errs, launches)
    return rows


def host_us(fn, calls=200) -> float:
    """Host time of one call while the card is kept busy, so the launches
    queue and the host is not held up by the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def flash_timing(errs, launches, shape=FLASH_TRAIN, fused_qkv=True):
    """The three flash kernels at ``shape`` (bf16; at the training shape
    through strided q/k/v views as the model feeds them). Operations are the
    matmul FLOPs of the live (causal) score entries: 2 products forward, 3
    for dQ, 4 for dK/dV. The plain version's backward and the library's
    backward each compute dQ, dK and dV together; both backward rows carry
    that one time."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from paddle_tpu_torch.ops import kernels as K

    B, T, Tk, H, D, causal = shape
    dt = torch.bfloat16
    q, k, v, do = flash_inputs(B, T, Tk, H, D, dt, fused_qkv=fused_qkv, seed=1)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    delta = flash_delta(do, o)
    live = B * H * (T * (T + 1) // 2 if causal else T * Tk)
    elt = B * T * H * D * 2  # bytes of one (B, T, H, D) bf16 tensor
    rowf = B * H * T * 4     # bytes of one (B, H, T) f32 row vector
    calls = {
        "flash_attention_fwd": lambda: K.flash_attention_fwd(q, k, v, causal),
        "flash_attention_dq": lambda: K.flash_attention_dq(
            q, k, v, do, lse, delta, causal),
        "flash_attention_dkv": lambda: K.flash_attention_dkv(
            q, k, v, do, lse, delta, causal),
    }
    ms = {name: time_ms(fn) for name, fn in calls.items()}
    host = {name: host_us(fn) for name, fn in calls.items()}
    delta_ms = time_ms(lambda: flash_delta(do, o))
    qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
    po, _ = K.flash_attention_plain(qp, kp, vp, causal)
    plain = {"flash_attention_fwd": time_ms(
        lambda: K.flash_attention_plain(q, k, v, causal), iters=5)}
    plain["flash_attention_dq"] = plain["flash_attention_dkv"] = time_ms(
        lambda: torch.autograd.grad(po, (qp, kp, vp), do, retain_graph=True),
        iters=5)
    del po, qp, kp, vp
    torch.cuda.empty_cache()
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    doh = do.transpose(1, 2).contiguous()
    lo = sdpa(qh, kh, vh, is_causal=causal)
    lib = {"flash_attention_fwd": time_ms(
        lambda: sdpa(qh, kh, vh, is_causal=causal))}
    lib["flash_attention_dq"] = lib["flash_attention_dkv"] = time_ms(
        lambda: torch.autograd.grad(lo, (qh, kh, vh), doh, retain_graph=True))
    work = {  # (bytes, operations)
        "flash_attention_fwd": (4 * elt + rowf, 4 * D * live),
        "flash_attention_dq": (5 * elt + 2 * rowf, 6 * D * live),
        "flash_attention_dkv": (6 * elt + 2 * rowf, 8 * D * live),
    }
    rows = []
    for name, (nbytes, ops) in work.items():
        b_ms, b_by = bound(nbytes, ops, dt)
        note = "" if name == "flash_attention_fwd" else (
            f"; plain_ms and library_ms are whole backwards (dQ+dK+dV), "
            f"beside dq+dkv+delta = {ms['flash_attention_dq'] + ms['flash_attention_dkv'] + delta_ms:.4f} ms "
            f"(delta {delta_ms:.4f} ms)")
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": FLASH_REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[(name, dt)],
            "ms": ms[name], "plain_ms": plain[name],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib[name],
            "tflop_s": ops / ms[name] / 1e9,
            "host_us_per_call": host[name],
            "shape": f"B={B} T={T} H={H} D={D} causal={causal} bf16"
                     f"{', strided q/k/v views' if fused_qkv else ''}; "
                     f"library: torch scaled_dot_product_attention on "
                     f"(B, H, T, D){note}",
        })
    return rows


# -- engine phase ------------------------------------------------------------

def decode_profile(eng, tag, steps=16, B=32, ctx=640):
    """Where a decode step's time goes: the engine's own decode step at
    batch B and context ~ctx, run on this thread with the engine idle, under
    torch.profiler (CPU + CUDA). Prints the device busy share of the step
    window and the kernels that take the most device time."""
    bs = eng.config.block_size
    mb = 1
    while mb * bs <= ctx:
        mb *= 2
    dev = eng._dev
    live = ctx // bs + 1
    tab = np.zeros((B, mb), np.int32)  # dead columns at the trash block
    tab[:, :live] = np.arange(1, 1 + B * live).reshape(B, live)
    tables = dev(tab)
    pos = dev((ctx - np.arange(B)).astype(np.int32))
    toks = dev(np.arange(B, dtype=np.int32))
    temps = dev(np.zeros(B, np.float32))
    fn = eng._get_fn("decode", B, mb)

    def step():
        eng._kpool, eng._vpool, nxt = fn(eng._params, eng._kpool, eng._vpool,
                                         tables, pos, toks, temps, eng._gen)
        return nxt.cpu()  # the engine reads the tokens back every step

    with torch.inference_mode():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        device_breakdown(step, steps, f"profile ({tag}) B={B} ctx~{ctx}")


def device_breakdown(step, steps, label, top=8):
    """Run ``step`` ``steps`` times under torch.profiler (CPU + CUDA) and
    print the device busy share of the window and the kernels that take the
    most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    ev = sorted((e.start_ns(), e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    if not ev:
        fail(f"{label}: the trace holds no device activity")
    busy, end, by_name = 0, 0, {}
    for a, b, name in ev:
        busy += max(0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0) + (b - a)
    window = ev[-1][1] - ev[0][0]
    print(f"  {label}: device window "
          f"{window / 1e6 / steps:.3f} "
          f"ms/step, busy {busy / 1e6 / steps:.3f} ms/step, idle share "
          f"{1 - busy / window:.3f}, {len(ev) / steps:.0f} device ops/step")
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"    {ns / 1e6 / steps:8.3f} ms/step  {name[:90]}")


def engine_phase(profile=False):
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0)
    t0 = time.monotonic()
    model = GPTForPretraining(cfg, dtype=torch.bfloat16, seed=0).eval()
    torch.cuda.synchronize()
    print(f"  model: gpt3_1p3b bf16, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, "
          f"built in {time.monotonic() - t0:.1f}s")
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, size=32)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]
    new = 64
    total = {"paged_attention_rows": 0, "int8_matmul": 0}
    for tag, int8 in (("a", False), ("b", True)):
        set_flags({"FLAGS_serve_paged_kernel": True,
                   "FLAGS_serve_int8_kernel": int8})
        eng = Engine(model, block_size=16, num_blocks=2048, max_batch=32,
                     prefill_batch=4, max_seq_len=2048, int8=int8, seed=0)
        try:
            K.reset_launch_counts()
            t0 = time.monotonic()
            handles = [eng.submit(p, max_new_tokens=new) for p in prompts]
            outs = [h.result(timeout=900) for h in handles]
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts = K.launch_counts()
            for k in total:
                total[k] += counts[k]
            for p, o in zip(prompts, outs):
                if len(o) != len(p) + new or o[:len(p)] != p \
                        or not all(0 <= t < cfg.vocab_size for t in o):
                    fail(f"engine ({tag}): output of {len(o)} tokens for a "
                         f"{len(p)}-token prompt")
            deadline = time.monotonic() + 30
            while eng.stats()["pages_used"] and time.monotonic() < deadline:
                time.sleep(0.01)
            st = eng.stats()
            if st["pages_used"] != 0:
                fail(f"engine ({tag}): {st['pages_used']} pages still used")
            want = ("paged_attention_rows", "int8_matmul") if int8 \
                else ("paged_attention_rows",)
            if any(counts[k] == 0 for k in want):
                fail(f"engine ({tag}): kernel launches {counts}")
            if profile:
                decode_profile(eng, tag)
            kl, pl = eng._debug_step_logits(prompts[:8])
            if not (np.isfinite(kl).all() and kl.shape == (8, cfg.vocab_size)):
                fail(f"engine ({tag}): debug logits {kl.shape} non-finite")
            rel = float(np.linalg.norm(kl - pl) / np.linalg.norm(pl))
            agree = float((kl.argmax(-1) == pl.argmax(-1)).mean())
            print(f"  engine ({tag}) int8={int8}: {len(outs) * new} tokens in "
                  f"{wall:.2f}s = {len(outs) * new / wall:.1f} tok/s, "
                  f"decode steps {st['decode_steps']}, mean decode step "
                  f"{st['decode_step_ms_mean']:.2f} ms, launches {counts}; "
                  f"kernel-vs-plain step logits rel_err={rel:.3e} "
                  f"max_abs={float(np.abs(kl - pl).max()):.3e} "
                  f"argmax_agree={agree:.3f} (tol rel {LOGITS_REL_TOL})")
            if rel > LOGITS_REL_TOL:
                fail(f"engine ({tag}): kernel step logits rel_err {rel:.3e}")
        finally:
            eng.close()
        del eng
        torch.cuda.empty_cache()
    return total


# -- train phase -------------------------------------------------------------

def train_batch(cfg, B=2, T=2048, seed=0):
    rng = np.random.RandomState(seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T))).cuda()
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T))).cuda()
    return ids, labels


def train_model(layers=None):
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0, remat=False,
                    attention_impl="flash", fused_lm_loss=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return GPTForPretraining(cfg, dtype=torch.bfloat16, seed=0).train()


def grad_check():
    """One bf16 backward of a full-width 4-layer model through the flash
    kernels against the same backward with attention on the plain
    version (the module's ``flash_attention_array`` swapped for it)."""
    import paddle_tpu_torch.nn.functional.attention as A
    from paddle_tpu_torch.ops import kernels as K

    model = train_model(TRAIN_LAYERS_CHECK)
    ids, labels = train_batch(model.config)
    grads, losses = [], []
    kernel_fn = A.flash_attention_array
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        if plain:
            A.flash_attention_array = \
                lambda q, k, v, causal=False: K.flash_attention_plain(
                    q, k, v, causal)[0]
        try:
            loss = model.loss(ids, labels)
            loss.backward()
        finally:
            A.flash_attention_array = kernel_fn
        losses.append(loss.item())
        grads.append({n: p.grad.float() for n, p in model.named_parameters()})
    worst = max(((rel_err(grads[0][n], grads[1][n]), n) for n in grads[0]),
                key=lambda t: t[0])
    print(f"  grad check ({TRAIN_LAYERS_CHECK} layers, full width, bf16): "
          f"loss kernel {losses[0]:.5f} plain {losses[1]:.5f}; worst "
          f"per-parameter rel_norm_err {worst[0]:.3e} ({worst[1]}), tol "
          f"{GRAD_REL_TOL}")
    if not worst[0] <= GRAD_REL_TOL or abs(losses[0] - losses[1]) > 1e-2:
        fail(f"train grad check: {worst[1]} rel_err {worst[0]:.3e}, "
             f"losses {losses}")
    del model, grads
    torch.cuda.empty_cache()


def time_steps(step, ids, labels, n):
    """``n`` steps on the host clock: (losses, seconds until the last step
    was queued, seconds until the device had finished it)."""
    t0 = time.monotonic()
    losses = [step(ids, labels) for _ in range(n)]
    queued = time.monotonic() - t0
    torch.cuda.synchronize()
    return losses, queued, time.monotonic() - t0


def train_phase(profile=False):
    """GPT-3 1.3B bf16, 24 layers, b2 x s2048 through compile_train_step."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels as K

    grad_check()
    t0 = time.monotonic()
    model = train_model()
    cfg = model.config
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    step = pt.jit.compile_train_step(model, lambda m, i, l: m.loss(i, l), opt)
    ids, labels = train_batch(cfg)
    B, T = ids.shape
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  model: gpt3_1p3b bf16 train, {n_params / 1e9:.3f}B params, "
          f"{cfg.num_layers} layers, built in {time.monotonic() - t0:.1f}s")
    losses = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    timed, queued, wall = time_steps(step, ids, labels, TRAIN_STEPS)
    losses += timed
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses]
    want = cfg.num_layers * TRAIN_STEPS
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    # bench.py's count: 6N (forward + backward matmuls) + 6 L d T (attention)
    flops_tok = 6.0 * n_params + 6.0 * cfg.num_layers * cfg.hidden_size * T
    print(f"  train: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, step "
          f"{step_ms:.2f} ms (host clock, one sync at the end), "
          f"{tok_s:.1f} tokens/s, MFU {tok_s * flops_tok / 989e12:.4f} "
          f"(6N + 6*L*d*T = {flops_tok:.4e} FLOP/token against 989 TFLOP/s "
          f"bf16), peak memory {peak / 2**30:.2f} GiB, launches {counts}")
    # a drain near 0 means the host, not the device, sets the step time (the
    # device waits for launches); a drain that stays at tens of ms while the
    # queueing follows the device's time means the host waits for the device
    print(f"  host: the {TRAIN_STEPS} steps were queued in {queued * 1e3:.1f} "
          f"ms ({queued / TRAIN_STEPS * 1e3:.2f} ms/step); the device "
          f"drained {(wall - queued) * 1e3:.1f} ms after the last was queued")
    print(f"  losses: {[round(v, 4) for v in vals]}")
    bad = [k for k in ("flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv") if counts[k] != want]
    if bad:
        fail(f"train: launches {counts}, want {want} for each flash kernel")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"train: losses {vals}")
    if profile:
        device_breakdown(lambda: step(ids, labels), 2,
                         f"profile (train) b{B}xs{T}", top=14)
    del step, opt, model
    torch.cuda.empty_cache()
    return {k: counts[k] for k in FLASH_REPLACES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace each engine's decode step and one train "
                         "step on the device")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not (ROOT / "paddle_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        fail(f"paddle_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops import kernels as K

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")

    print("[1] build")
    t0 = time.monotonic()
    log = K.build()
    print(f"  built {sorted(log)} in {time.monotonic() - t0:.1f}s "
          f"(per kernel: {({k: v['seconds'] for k, v in log.items()})})")
    for name, entry in log.items():  # ptxas -v over every instantiation
        regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                            entry["ptxas"])]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                                  entry["ptxas"]))
        print(f"  {name}: {len(regs)} instantiations, registers "
              f"{min(regs, default=0)}-{max(regs, default=0)}, "
              f"spill-store bytes {spills}")
        for fn, st, reg in re.findall(
                r"Function properties for (\S+)\n.*?(\d+) bytes spill stores"
                r".*?\n.*?Used (\d+) registers", entry["ptxas"]):
            print(f"    {fn}: {reg} registers at entry, {st} spill-store "
                  "bytes")

    print("[2] kernels against their plain versions")
    errs = kernel_phase()
    train_errs, long_errs = flash_phase()
    errs.update(train_errs)

    print("[3] engine: gpt3_1p3b through serving.Engine")
    launches = engine_phase(profile=args.profile)

    print("[5] train: gpt3_1p3b through jit.compile_train_step")
    launches.update(train_phase(profile=args.profile))

    print("[4] kernel timing")
    rows = timing_phase(errs, launches)
    # the reference's (B*H, T, D) route shape: not on the port's main path
    long_rows = flash_timing(long_errs, dict.fromkeys(FLASH_REPLACES, 0),
                             FLASH_LONG, fused_qkv=False)
    for r in rows + long_rows:
        extra = (f", {r['tflop_s']:.1f} TFLOP/s, host "
                 f"{r['host_us_per_call']:.1f} us/call" if "tflop_s" in r
                 else "")
        print(f"  {r['name']}: {r['ms']:.4f} ms{extra} (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, library {r['library_ms']}) at {r['shape']}")
    print(json.dumps({"flash_long_shape": long_rows}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
