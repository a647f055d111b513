"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run; needs one CUDA card
    python3 chip_smoke.py --profile  # + device breakdowns of a decode step
                                     #   and of a train step

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. build: every CUDA kernel source in ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, started together); prints
   ptxas's registers and spill-store bytes of every kernel instantiation;
   ``cuobjdump -sass`` must find no int-to-float conversion (I2F, I2FP) in
   the bf16 int8 kernel;
2. kernels: each kernel against its plain PyTorch version, in float32
   (tight tolerance: checks the algorithm) and bfloat16 (loose tolerance
   and, for paged attention and the flash O and gradients, a
   relative-norm bound: checks the working type). Paged attention at
   every (batch, table width) each of the engine phase's engines can launch
   it with (its decode buckets by its gather widths, so every cluster size
   it launches with is run), at GPT's KV = 16 and at Llama's KV = 32, then
   for rep 2, 4 and 8 and at 48 rows; the cluster size the kernel reports
   (``pt_paged_split``) is held against ``paged_split_rule`` first at every
   checked (batch, table width, KV), and the checks must run each of 1, 2,
   4 and 8; the int8 head at every row count the engines can launch it with
   (decode buckets and prefill width), at GPT's head (K = 2048, N = 50304)
   and at Llama's (K = 4096, N = 32000), then two passes (48 rows), a
   ragged N and a ragged K, each in both weight layouts (bf16 also by
   relative norm against the f32 plain version), and one-hot and two-hot
   rows whose output must be the reference's dequant bit for bit, at every
   (K, N) (so at K = 4096 too); the
   flash-attention forward (O, LSE) and backward (dQ, dK, dV) at small
   shapes (ragged causal tails, non-causal T != T_kv, causal T < T_kv, a
   D=40 head, T=130 at D=128, every head width instantiation), in bf16 at
   the training shape and at the long-sequence shape (T=8192, D=64); at
   every shape dQ and dK/dV are each launched twice on the same inputs, and
   the two must agree bit for bit;
3. engine: GPT-3 1.3B at full width (24 layers, bf16, random weights from a
   seed) through ``serving.Engine`` over 32 greedy requests, (a) with the
   paged-attention kernel and (b) int8 weights with both kernels; then
   Llama-7B at full width and depth (32 layers, 32 heads, KV = 32, FFN
   11008, vocab 32000, untied head, bf16, random weights from a seed) the
   same way, (c) and (d). Launch counts are zeroed just before each drive
   and read just after it; every output must have exactly prompt + 64
   tokens and the pool must drain. One decode step built with the kernels
   is held against the same step built with the plain versions on the same
   pool state. Each model and its engines are freed before the next;
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
   of one call, at the training shape and at the long-sequence shape; the
   paged kernel at the four ``PAGED_SHAPES`` (Llama's decode shape among
   them); the int8 head at M = 1, 4 and 32 beside the dense bf16 head
   (``dense_bf16_ms``), GPT's in both layouts and Llama's in (K, N)
   (``llama_head``).

The last three lines of stdout are the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``; the three lines before them are
``{"flash_long_shape": [...]}``, the flash kernels' times at the
long-sequence shape (no launches on the main path),
``{"paged_shapes": [...]}``, the paged kernel's time, bound and cluster
size at each of ``PAGED_SHAPES``, and ``{"engine_drives": [...]}``, each
engine drive's tok/s, decode steps, mean decode-step ms, launches and
kernel-vs-plain logits error.
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
    # bf16: the kernel keeps f32 inside and rounds once; paged attention is
    # held against the f32 plain version on the same bf16 inputs (the bf16
    # plain version's own rounding of the probabilities reaches 1.6e-2 where
    # a short context leaves |O| large), the matmul against the bf16 plain
    # version, which rounds only the output
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
# bf16 flash dQ, the same norm: its own bound, tighter than the shared one
# (measured 2.4e-3 to 2.7e-3), so a dropped or misplaced K/V tile fails
FLASH_DQ_REL_TOL = 1e-2
# bf16 flash O, the same norm: P rounded to bf16 before P V and O once at the
# end (~0.3%); the elementwise O tolerance alone is loose where |O| is small
# (|O| ~ sqrt(e / T) for unit-normal inputs)
FLASH_O_REL_TOL = 1e-2
# bf16 paged-attention output against the f32 plain version on the same
# inputs, the same norm: the kernel rounds the output once (and takes the
# scale rounded to bf16, as the reference does)
PAGED_O_REL_TOL = 1e-2
# the engine phase's engines (GPT-3 1.3B: KV = 16 heads of D = 128; Llama-7B:
# KV = 32 heads of D = 128) and their drive: 32 greedy requests, prompts of
# 128 to 1024 tokens, 64 new each
ENGINE_KW = {"block_size": 16, "num_blocks": 2048, "max_batch": 32,
             "prefill_batch": 4, "max_seq_len": 2048}
DRIVE_REQUESTS, DRIVE_NEW = 32, 64
# the int8 LM heads of the engine phase's models (K, N): GPT-3 1.3B's hidden
# size and padded vocabulary, weight stored (N, K) (the tied embedding), and
# Llama-7B's, weight stored (K, N) (the untied head, ``transpose_w=False``)
INT8_HEAD = (2048, 50304)
LLAMA_HEAD = (4096, 32000)
# the weight layouts every int8 check runs (``transpose_w``): (N, K), GPT's
# tied head, and (K, N), Llama's untied head
INT8_LAYOUTS = (True, False)
# int8 head checks beyond the engine's own launches (M, K, N): two passes
# over the weight, a ragged N, a K that is not a multiple of the kernel's
# 128-byte chunk, and both at a row count that is not a multiple of 8
INT8_EXTRA_CHECKS = ((48, 2048, 50304), (32, 2048, 50257), (32, 1000, 50304),
                     (5, 1000, 50257))
# bf16 int8 head against the f32 plain version on the same bf16 inputs and
# dequantized weight, ||kernel - plain|| / ||plain||: only the output
# rounding (~2^-9 relative) separates them
INT8_REL_TOL = 1e-2
# the int8 heads' timing rows (M at INT8_HEAD in both layouts, and at
# LLAMA_HEAD in (K, N)): one stream, the prefill width and the full decode
# batch
INT8_TIMING_ROWS = (1, 4, 32)
INT8_MMA = "int8_matmul_mma"  # the bf16 tensor-core kernel's name
# paged checks beyond the engines' own launches (rep, B, MB, KV): every rep
# bound the kernel instantiates at 2, 4 and 8 blocks a row, and 48 rows (one
# block a row)
PAGED_REP_CHECKS = ((2, 32, 64, 16), (4, 32, 64, 16), (8, 32, 64, 16),
                    (8, 16, 128, 16), (8, 4, 128, 16), (1, 48, 64, 16))
# the paged kernel's timing shapes (B, MB, positions, KV; H = KV, D = 128,
# BS = 16, bf16): GPT's decode shape with ragged contexts (mean ~490), 32
# rows with every context near 2000, 2 rows at 2048, where a row's context
# is split over a cluster of thread blocks, and Llama-7B's decode shape
PAGED_SHAPES = (("decode", 32, 64, None, 16),
                ("b32_ctx2000", 32, 128, "near2000", 16),
                ("b2_ctx2048", 2, 128, "full", 16),
                ("llama_decode", 32, 64, None, 32))
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

FLASH_KERNELS = {"flash_attention_fwd": "fwd_wgmma",
                 "flash_attention_dq": "dq_wgmma",
                 "flash_attention_dkv": "dkv_wgmma"}  # bf16, D <= 128


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


def compare(name, dtype, out, ref, note=""):
    atol, rtol = TOL[(name, dtype)]
    out, ref = out.detach().float(), ref.detach().float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {dtype}: shape {tuple(out.shape)} vs {tuple(ref.shape)} "
             "or non-finite output")
    err = (out - ref).abs()
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = float(err.max())
    print(f"  {name} {str(dtype)[6:]}: max_abs_err={max_err:.3e} "
          f"(atol={atol}, rtol={rtol}) {'ok' if not bad else 'MISMATCH'}"
          f"{note}")
    if bad:
        fail(f"{name} {dtype}{note}: {bad} elements outside tolerance")
    return max_err


# -- build phase -------------------------------------------------------------

def ptxas_functions(text):
    """(function, spill-store bytes, registers) of every kernel
    instantiation in nvcc's ``-Xptxas -v`` report."""
    return [(fn, int(st), int(reg)) for fn, st, reg in re.findall(
        r"Function properties for (\S+)\n.*?(\d+) bytes spill stores"
        r".*?\n.*?Used (\d+) registers", text)]


def int8_sass_check():
    """No int8 -> float conversion instruction (I2F, I2FP) in any
    instantiation of the bf16 int8 kernel: its dequant goes through byte
    permutes and one FADD (``cuobjdump -sass`` of the built library)."""
    from paddle_tpu_torch.ops.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        fail(f"int8_matmul SASS: no cuobjdump beside nvcc ({tool}); I2F "
             "cannot be checked")
    res = subprocess.run([str(tool), "-sass", str(_build._target("int8_matmul"))],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass int8_matmul: {res.stderr.strip()[:400]}")
    funcs = [f for f in res.stdout.split("Function : ")[1:]
             if INT8_MMA in f.split(None, 1)[0]]
    conv = sum(len(re.findall(r"\bI2FP?\.", f)) for f in funcs)
    print(f"  int8_matmul SASS: {len(funcs)} {INT8_MMA} instantiations, "
          f"{conv} I2F/I2FP instructions {'ok' if funcs and not conv else 'MISMATCH'}")
    if not funcs or conv:
        fail(f"int8_matmul SASS: {len(funcs)} {INT8_MMA} functions, {conv} "
             "int-to-float conversions")


# -- kernel phase ------------------------------------------------------------

def paged_inputs(dtype, rep=1, B=32, KV=16, D=128, BS=16, MB=64, seed=0,
                 pos=None):
    """One layer's pool with per-row disjoint live blocks (dead table
    columns at trash block 0) and positions: by default ragged (from 128, or
    half the table on a short one), landing on and across block edges (the
    first six rows) and at the table's last position; ``"near2000"`` every
    row within [1900, MB * BS); ``"full"`` every row at MB * BS - 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.RandomState(seed)
    NB = B * MB + 1
    kpool = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    vpool = torch.randn(NB, BS, KV, D, generator=g, device="cuda").to(dtype)
    q = torch.randn(B, KV * rep, D, generator=g, device="cuda").to(dtype)
    if pos == "near2000":
        pos = rng.randint(1900, MB * BS, size=B)
    elif pos == "full":
        pos = np.full(B, MB * BS - 1)
    else:
        pos = rng.randint(min(128, MB * BS // 2), MB * BS, size=B)
        edges = [0, BS - 1, BS, 2 * BS - 1, 2 * BS][:B - 1] + [MB * BS - 1]
        pos[:len(edges)] = np.minimum(edges, MB * BS - 1)
    perm = rng.permutation(np.arange(1, NB)).reshape(B, MB)
    tables = np.zeros((B, MB), np.int32)
    for b in range(B):
        n_live = pos[b] // BS + 1
        tables[b, :n_live] = perm[b, :n_live]
    return (q, kpool, vpool, torch.from_numpy(tables).cuda(),
            torch.from_numpy(pos.astype(np.int32)).cuda())


def int8_weight(K, N, seed=0):
    """An int8 head weight ``(N, K)`` quantized from a seeded normal weight
    (std 0.02) by the port's own rounding, and its f32 scale on the card."""
    from paddle_tpu_torch.serving.int8 import quantize_to_int8

    g = torch.Generator(device="cuda").manual_seed(seed)
    qw, scale = quantize_to_int8(
        torch.randn(N, K, generator=g, device="cuda") * 0.02)
    return qw, torch.tensor(scale, dtype=torch.float32, device="cuda")


def int8_x(M, K, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return torch.randn(M, K, generator=g, device="cuda").to(dtype)


def engine_models():
    """(name, config, KV heads, int8 head (K, N)) of the engine phase's
    models, in the order they are driven: GPT-3 1.3B (drives a, b), then
    Llama-7B (drives c, d)."""
    from paddle_tpu_torch.models import gpt3_1p3b, llama_7b

    gpt = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0)
    llama = llama_7b()
    return [("gpt3_1p3b", gpt, gpt.num_heads, INT8_HEAD),
            ("llama_7b", llama, llama.kv_heads, LLAMA_HEAD)]


def engine_config(cfg):
    """``ENGINE_KW`` resolved against a model config, as its engine does."""
    from paddle_tpu_torch.serving import EngineConfig

    return EngineConfig(**ENGINE_KW).resolve(cfg.max_position_embeddings)


def engine_int8_rows():
    """Every row count the engine phase's engines can launch the int8 head
    with: their decode buckets and their prefill width."""
    rows = set()
    for _, cfg, _, _ in engine_models():
        ec = engine_config(cfg)
        rows |= set(ec.decode_buckets) | {ec.prefill_batch}
    return sorted(rows)


def int8_check_shapes():
    """(M, K, N) of every int8 head check: each engine's head at every row
    count it launches, then ``INT8_EXTRA_CHECKS``; each (K, N) is checked in
    both weight layouts."""
    return [(M, K, N) for _, _, _, (K, N) in engine_models()
            for M in engine_int8_rows()] + list(INT8_EXTRA_CHECKS)


def engine_paged_shapes():
    """(B, MB, KV) of every paged-attention launch the engine phase's engines
    can make: each model's KV heads, by its engine's decode buckets, by its
    gather widths (the powers of two below its table's most blocks, and that
    most)."""
    out = []
    for _, cfg, kv, _ in engine_models():
        ec = engine_config(cfg)
        most = -(-ec.max_seq_len // ec.block_size)
        widths = [1 << i for i in range(most.bit_length()) if 1 << i < most]
        out += [(B, MB, kv) for B in ec.decode_buckets
                for MB in widths + [most]]
    return out


def paged_check_shapes():
    """(rep, B, MB, KV) of every paged check: the engines' models (rep 1) at
    every (B, MB, KV) they can launch, then ``PAGED_REP_CHECKS``."""
    return [(1, B, MB, kv) for B, MB, kv in engine_paged_shapes()] \
        + list(PAGED_REP_CHECKS)


def paged_split_rule(B: int, KV: int, BS: int, MB: int, n_sm: int) -> int:
    """The thread blocks (a cluster) the paged kernel should split each
    (row, KV head) context over: doubled, up to 8, while the B * KV pairs
    would not give 4 blocks per SM and every block keeps at least 64
    positions of the MB * BS-position table. The kernel's own rule is
    ``split_for`` in ``csrc/paged_attention.cu``; ``paged_split_check``
    holds it to this one."""
    split = 1
    while split < 8 and B * KV * split < 4 * n_sm and MB * BS >= 128 * split:
        split *= 2
    return split


def kernel_split(B, KV, BS, MB):
    """The cluster size the built paged kernel launches with at this shape
    on the current card (its C entry ``pt_paged_split``)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as P

    fn = _build.load("paged_attention", P._SIGS).pt_paged_split
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    split = fn(B, KV, BS, MB)
    if split <= 0:
        fail(f"pt_paged_split: CUDA error {-split}")
    return split


def paged_split_check(shapes):
    """The kernel's cluster size against ``paged_split_rule`` at every check
    shape (GPT's KV = 16 and Llama's KV = 32), every timing shape and a few
    other head counts; the checks must run every cluster size, 1, 2, 4 and
    8. Returns {(B, MB, KV): split} at BS = 16."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    BMs = {(B, MB, KV) for _, B, MB, KV in shapes} | {
        (B, MB, KV) for _, B, MB, _, KV in PAGED_SHAPES}
    got = {}
    for B, KV, BS, MB in sorted({(B, KV, 16, MB) for B, MB, KV in BMs}
                                | {(1, 1, 16, 4), (1, 8, 16, 128),
                                   (8, 16, 16, 8)}):
        got[(B, KV, BS, MB)] = split = kernel_split(B, KV, BS, MB)
        want = paged_split_rule(B, KV, BS, MB, n_sm)
        if split != want:
            fail(f"paged split at B={B} KV={KV} BS={BS} MB={MB}: kernel "
                 f"{split}, rule {want} ({n_sm} SMs)")
    by_split = {}
    for key, split in sorted(got.items()):
        by_split.setdefault(split, []).append(key)
    print(f"  paged split: the kernel's cluster size as the rule gives on "
          f"{n_sm} SMs at {len(got)} shapes; (B, KV, BS, MB) by size: "
          f"{by_split}")
    ran = {got[(B, KV, 16, MB)] for _, B, MB, KV in shapes}
    if ran != {1, 2, 4, 8}:
        fail(f"paged checks run cluster sizes {sorted(ran)}, not each of "
             "1, 2, 4 and 8")
    return {(B, MB, KV): got[(B, KV, 16, MB)] for B, MB, KV in BMs}


def kernel_phase():
    from paddle_tpu_torch.ops import kernels as K

    shapes = paged_check_shapes()
    split = paged_split_check(shapes)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for rep, B, MB, KV in shapes:
            args = paged_inputs(dtype, rep=rep, B=B, KV=KV, MB=MB)
            out = K.paged_attention_rows(*args)
            torch.cuda.synchronize()
            q, kp, vp, tables, pos = args
            ref = K.paged_attention_rows_plain(q.float(), kp.float(),
                                               vp.float(), tables, pos)
            note = (f" at B={B} MB={MB} KV={KV} rep={rep} "
                    f"split={split[(B, MB, KV)]} max pos {int(args[4].max())}")
            rel = rel_err(out, ref)
            if dtype == torch.bfloat16:
                note += (f", rel_norm_err={rel:.3e} (tol rel "
                         f"{PAGED_O_REL_TOL})")
            e = compare("paged_attention_rows", dtype, out, ref, note)
            if dtype == torch.bfloat16 and not rel <= PAGED_O_REL_TOL:
                fail(f"paged_attention_rows bf16{note}: relative error "
                     f"{rel:.3e}")
            if (rep, B, MB, KV) == (1, 32, 64, 16):
                errs[("paged_attention_rows", dtype)] = e
            del args, q, kp, vp, out, ref
        torch.cuda.empty_cache()
    errs.update(int8_phase())
    return errs


def int8_exact_rows(K):
    """The rows of ``int8_exact_check`` for a K-wide x: 32 one-hot picks k_m
    spread over K (the first and last column included), and 32 two-hot
    pairs (a_m, b_m) of distinct picks."""
    ks = np.round(np.linspace(0, K - 1, 32)).astype(np.int64)
    return ks, np.stack([ks, np.roll(ks, -11)], axis=1)


def int8_exact_check(qw, s, tw, dtype):
    """Rows whose output is fixed bit for bit by the reference's dequant
    (+0 and -0 count as equal). One-hot rows x[m] = e_{k_m} must give the
    dequantized weight's columns k_m: an inexact int8 -> float conversion
    or a lane on the wrong k fails. Two-hot rows x[m] = e_a + e_b must give
    the sum of columns a and b, exact in f32, rounded once to the output
    dtype: a scale folded in after the sum, ``s127 * (q_a + q_b)`` rounded,
    fails, and in bf16 the check fails unless such a kernel would differ
    somewhere on these rows."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_dequant

    Kd = qw.shape[1] if tw else qw.shape[0]
    ks, pairs = (torch.from_numpy(v).cuda() for v in int8_exact_rows(Kd))
    a, b = pairs[:, 0], pairs[:, 1]
    rows = torch.arange(32, device="cuda")
    wd = int8_dequant(qw, s, dtype)
    wd, q = (wd.T, qw.T) if tw else (wd, qw)  # both (K, N)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32

    def differ(out, want):
        return int((~((out.view(bits) == want.view(bits))
                      | ((out == 0) & (want == 0)))).sum())

    x1 = torch.zeros(32, Kd, device="cuda", dtype=dtype)
    x1[rows, ks] = 1
    x2 = torch.zeros(32, Kd, device="cuda", dtype=dtype)
    x2[rows, a] = 1
    x2[rows, b] = 1
    want2 = (wd[a].float() + wd[b].float()).to(dtype)
    folded = ((q[a].float() + q[b].float()) * (s / s.new_tensor(127.0))).to(dtype)
    bad1 = differ(K.int8_matmul(x1, qw, s, transpose_w=tw), wd[ks])
    bad2 = differ(K.int8_matmul(x2, qw, s, transpose_w=tw), want2)
    sens = differ(folded, want2)
    n = 32 * wd.shape[1]
    ok = not bad1 and not bad2 and (sens or dtype != torch.bfloat16)
    print(f"  int8_matmul {str(dtype)[6:]} exact rows at K={Kd} "
          f"{'(N, K)' if tw else '(K, N)'}: one-hot {n - bad1}/{n}, two-hot "
          f"{n - bad2}/{n} bit-equal (a scale folded after the sum would "
          f"differ at {sens}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"int8_matmul {dtype} exact rows: {bad1} one-hot and {bad2} "
             f"two-hot elements differ from the reference's dequant; a folded "
             f"scale would differ at {sens}")


def int8_phase():
    """The int8 head against its plain version at every ``int8_check_shapes``
    shape, in both weight layouts, f32 and bf16; bf16 also by relative norm
    against the f32 plain version on the same bf16 inputs, and every weight
    through ``int8_exact_check``. Returns the max abs errors at the decode
    batch (M = 32, (N, K))."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_dequant

    errs = {}
    shapes = int8_check_shapes()
    for Kd, N in sorted({(k, n) for _, k, n in shapes}, reverse=True):
        qw_nk, s = int8_weight(Kd, N)
        for tw in INT8_LAYOUTS:
            qw = qw_nk if tw else qw_nk.T.contiguous()
            for dtype in (torch.float32, torch.bfloat16):
                wd = int8_dequant(qw, s, dtype).float()
                wd = wd.T if tw else wd
                for M in [m for m, k, n in shapes if (k, n) == (Kd, N)]:
                    x = int8_x(M, Kd, dtype)
                    out = K.int8_matmul(x, qw, s, transpose_w=tw)
                    torch.cuda.synchronize()
                    note = f" at M={M} K={Kd} N={N} {'(N, K)' if tw else '(K, N)'}"
                    rel = rel_err(out, x.float() @ wd)
                    if dtype == torch.bfloat16:
                        note += (f", rel_norm_err={rel:.3e} against the f32 "
                                 f"plain version (tol rel {INT8_REL_TOL})")
                    e = compare("int8_matmul", dtype, out,
                                K.int8_matmul_plain(x, qw, s, transpose_w=tw),
                                note)
                    if dtype == torch.bfloat16 and not rel <= INT8_REL_TOL:
                        fail(f"int8_matmul bf16{note}: relative error {rel:.3e}")
                    if (M, Kd, N, tw) == (32, *INT8_HEAD, True):
                        errs[("int8_matmul", dtype)] = e
                    del x, out
                int8_exact_check(qw, s, tw, dtype)
                del wd
            del qw
        del qw_nk
        torch.cuda.empty_cache()
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
    the gradients) on the same inputs; a second dQ and a second dK/dV launch
    on the same inputs must agree bit for bit. Returns the max abs error per
    kernel (dkv: over dK and dV)."""
    from paddle_tpu_torch.ops import kernels as K

    q, k, v, do = flash_inputs(B, T, Tk, H, D, dtype, fused_qkv)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    delta = flash_delta(do, o)
    dq = K.flash_attention_dq(q, k, v, do, lse, delta, causal)
    dq2 = K.flash_attention_dq(q, k, v, do, lse, delta, causal)
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
        tol = {"flash_attention_fwd": FLASH_O_REL_TOL,
               "flash_attention_dq": FLASH_DQ_REL_TOL}.get(
                   name, FLASH_GRAD_REL_TOL)
        ok = max(rels) <= tol
        print(f"  {name} bf16: rel_norm_err={max(rels):.3e} max_abs_err="
              f"{errs[name]:.3e} (tol rel {tol}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{name} bf16: relative error {max(rels):.3e}")
    if not torch.equal(dq, dq2):
        fail("flash_attention_dq: two launches on the same inputs differ")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        fail("flash_attention_dkv: two launches on the same inputs differ")
    print("  flash_attention_dq, flash_attention_dkv: two launches each "
          "bitwise equal")
    return errs


def flash_phase():
    """Small shapes in f32 and bf16 (every head-width instantiation, a D=40
    head that TMA zero-fills to a 64-column panel, ragged causal tails at
    T=200 and T=1000, non-causal T != T_kv with ragged T_kv, causal T <
    T_kv, causal T=136 < T_kv=200, and T=130 at D=128, one row past a
    128-row q tile), then bf16 at the training shape through strided q/k/v
    views and at the reference's long-sequence shape. Returns the max abs
    errors at the training shape and at the long shape."""
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in ((1, 192, 192, 2, 64, True), (1, 200, 200, 3, 128, True),
                  (1, 128, 328, 2, 64, False), (1, 96, 160, 1, 256, True),
                  (2, 130, 130, 2, 32, True), (1, 256, 256, 2, 40, True),
                  (1, 1000, 1000, 2, 128, True), (1, 136, 200, 2, 64, False),
                  (1, 136, 200, 2, 64, True), (1, 130, 130, 2, 128, True)):
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


def paged_timing(tag, B, MB, pos, KV=16, plain=True, split=True):
    """The paged kernel (and, with ``plain``, its plain version; with
    ``split``, the cluster size it reports) at one of ``PAGED_SHAPES``,
    beside the card's least time: each live token's K and
    V row read once, q and the output once, the live table entries and pos;
    4 FLOPs per live token, query head and column."""
    from paddle_tpu_torch.ops import kernels as K

    dt, es = torch.bfloat16, 2
    q, kp, vp, tables, pos_t = paged_inputs(dt, B=B, KV=KV, MB=MB, seed=1,
                                            pos=pos)
    H, D = q.shape[1:]
    KV, BS = kp.shape[2], kp.shape[1]
    live = int((pos_t.long() + 1).sum())
    nbytes = (2 * B * H * D * es + 2 * live * KV * D * es
              + 4 * int((pos_t.long() // BS + 1).sum()) + 4 * B)
    b_ms, b_by = bound(nbytes, 4 * live * H * D, dt)
    row = {"tag": tag,
           "ms": time_ms(lambda: K.paged_attention_rows(q, kp, vp, tables,
                                                        pos_t)),
           "bound_ms": b_ms, "bound_by": b_by,
           "shape": f"B={B} H={H} KV={KV} D={D} BS={BS} MB={MB} "
                    f"mean_ctx={live / B:.1f} max_ctx={int(pos_t.max()) + 1} "
                    "bf16"}
    if split:
        row["split"] = kernel_split(B, KV, BS, MB)
    if plain:
        row["plain_ms"] = time_ms(lambda: K.paged_attention_rows_plain(
            q, kp, vp, tables, pos_t), iters=5)
    del q, kp, vp
    torch.cuda.empty_cache()
    return row


def int8_head_times(Kd, N, layouts):
    """The bf16 int8 head at (K, N) = (Kd, N), stored in each of ``layouts``
    (``transpose_w``: True is (N, K), ``ms_by_m``; False is (K, N),
    ``kn_ms_by_m``), at every ``INT8_TIMING_ROWS``, beside
    ``dense_bf16_ms_by_m``: the same product on the weight dequantized to
    bf16 ahead of time and stored in ``layouts[0]``, what the head costs
    without int8, and the bytes bound of each row count (the int8 weight
    read once, x and the output once)."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_dequant

    dt, es = torch.bfloat16, 2
    qw, s = int8_weight(Kd, N, seed=1)
    out = {"shape": f"K={Kd} N={N} bf16"}
    for tw in layouts:
        w = qw if tw else qw.T.contiguous()
        times = out["ms_by_m" if tw else "kn_ms_by_m"] = {}
        for M in INT8_TIMING_ROWS:
            x = int8_x(M, Kd, dt, seed=1)
            times[M] = time_ms(lambda: K.int8_matmul(x, w, s, transpose_w=tw),
                               iters=50)
        if tw == layouts[0]:
            wd = int8_dequant(w, s, dt)
            wd = wd.T if tw else wd  # (K, N), a view of the stored layout
            dense = out["dense_bf16_ms_by_m"] = {}
            for M in INT8_TIMING_ROWS:
                x = int8_x(M, Kd, dt, seed=1)
                dense[M] = time_ms(lambda: x @ wd, iters=50)
            del wd
        del w
    out["bytes_bound_ms_by_m"] = {
        m: (N * Kd + m * Kd * es + m * N * es + 4) / HBM_BYTES_PER_S * 1e3
        for m in INT8_TIMING_ROWS}
    del qw
    torch.cuda.empty_cache()
    return out


def int8_timing(errs, launches, ptxas):
    """The int8 head's row: (N, K) bf16 at K, N = ``INT8_HEAD``, timed at
    every ``INT8_TIMING_ROWS`` (``ms`` at M = 32, the decode batch; the same
    weight stored (K, N) in ``kn_ms_by_m``), beside the card's least time at
    M = 32 (the int8 weight read once, x and the output once; 2 M N K
    operations), the plain version, one PyTorch call for an int8-weight
    matmul and the dense bf16 head (``int8_head_times``); Llama-7B's head,
    stored (K, N) at ``LLAMA_HEAD``, in ``llama_head``. ``ptxas``:
    [(function, spill-store bytes, registers)] of the bf16 kernel's
    instantiation at this shape, when this run built it."""
    from paddle_tpu_torch.ops import kernels as K

    dt, es = torch.bfloat16, 2
    Kd, N = INT8_HEAD
    times = int8_head_times(Kd, N, INT8_LAYOUTS)
    llama = int8_head_times(*LLAMA_HEAD, (False,))
    M = INT8_TIMING_ROWS[-1]
    qw, s = int8_weight(Kd, N, seed=1)
    x = int8_x(M, Kd, dt, seed=1)
    b_ms, b_by = bound(N * Kd + M * Kd * es + M * N * es + 4, 2 * M * N * Kd,
                       dt)
    lib_ms, lib_note = None, "none"
    try:  # one PyTorch call for an int8-weight matmul, where the build has one
        scales = (s.repeat(N) / 127.0).to(dt)
        torch._weight_int8pack_mm(x, qw, scales)
        lib_ms = time_ms(lambda: torch._weight_int8pack_mm(x, qw, scales))
        lib_note = "torch._weight_int8pack_mm"
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        lib_note = f"torch._weight_int8pack_mm unavailable: {str(e)[:80]}"
    row = {
        "name": "int8_matmul", "route": "cuda",
        "kernel": "int8_matmul_mma: cp.async ring of 128-byte K chunks, "
                  "exact byte-permute dequant in registers, mma.sync "
                  "m16n8k16 with the weight as the tall operand",
        "source": "paddle_tpu_torch/ops/kernels/csrc/int8_matmul.cu",
        "replaces": "paddle_tpu/ops/kernels/int8_matmul.py:76",
        "launches": launches["int8_matmul"],
        "max_abs_err": errs[("int8_matmul", dt)],
        "ms": times["ms_by_m"][M],
        "plain_ms": time_ms(lambda: K.int8_matmul_plain(x, qw, s, True),
                            iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "ms_by_m": times["ms_by_m"], "kn_ms_by_m": times["kn_ms_by_m"],
        "dense_bf16_ms": times["dense_bf16_ms_by_m"][M],
        "dense_bf16_ms_by_m": times["dense_bf16_ms_by_m"],
        "bytes_bound_ms_by_m": times["bytes_bound_ms_by_m"],
        "llama_head": llama,
        # ptxas's report of the instantiation this shape runs
        "registers": ptxas[0][2] if ptxas else None,
        "spill_bytes": ptxas[0][1] if ptxas else None,
        "shape": f"M={M} K={Kd} N={N} transpose_w bf16; library: {lib_note}",
    }
    del qw
    torch.cuda.empty_cache()
    return row


def timing_phase(errs, launches, int8_ptxas=()):
    """The kernels line's rows, and the paged kernel at every one of
    ``PAGED_SHAPES``."""
    rows = []
    paged = [paged_timing(*shape) for shape in PAGED_SHAPES]
    pg = paged[0]
    rows.append({
        "name": "paged_attention_rows", "route": "cuda",
        "kernel": "paged_attention_kernel: whole pool blocks by cp.async "
                  "into a 2-stage ring per warp, softmax per block, cluster "
                  "split of long contexts",
        "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/ops/kernels/paged_attention.py:134",
        "launches": launches["paged_attention_rows"],
        "max_abs_err": errs[("paged_attention_rows", torch.bfloat16)],
        "ms": pg["ms"], "plain_ms": pg["plain_ms"],
        "bound_ms": pg["bound_ms"], "bound_by": pg["bound_by"],
        # no single PyTorch call reads attention through a block table
        "library_ms": None,
        "shape": f"{pg['shape']}; {pg['split']} blocks a row; the other "
                 "shapes on the paged_shapes line",
    })
    rows.append(int8_timing(errs, launches, int8_ptxas))
    rows += flash_timing(errs, launches)
    return rows, paged


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
            "kernel": f"{FLASH_KERNELS[name]}<{64 if D <= 64 else 128}> "
                      "(TMA + wgmma)",
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

def decode_step(eng, B=32, ctx=640):
    """The engine's own decode step at batch B and context ~ctx, to run on
    this thread with the engine idle (inside ``torch.inference_mode()``);
    each call ends, as the engine's does, by copying the tokens back."""
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

    return step


def decode_profile(eng, tag, steps=16, B=32, ctx=640):
    """Where a decode step's time goes: ``decode_step`` under torch.profiler
    (CPU + CUDA). Prints the device busy share of the step window and the
    kernels that take the most device time."""
    with torch.inference_mode():
        step = decode_step(eng, B, ctx)
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        device_breakdown(step, steps, f"profile ({tag}) B={B} ctx~{ctx}",
                         watch=("paged_attention_kernel", INT8_MMA))


def device_breakdown(step, steps, label, top=8, watch=()):
    """Run ``step`` ``steps`` times under torch.profiler (CPU + CUDA) and
    print the device busy share of the window, the kernels that take the
    most device time and, below them, any other kernel whose name holds one
    of ``watch``."""
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    shown = ranked[:top] + [(n, ns) for n, ns in ranked[top:]
                            if any(w in n for w in watch)]
    for name, ns in shown:
        print(f"    {ns / 1e6 / steps:8.3f} ms/step  {name[:90]}")


def drive_prompts(vocab_size, seed=0):
    """The engine drive's prompts: ``DRIVE_REQUESTS`` of 128 to 1024 random
    tokens, from a seed."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=DRIVE_REQUESTS)
    return [rng.randint(0, vocab_size, size=n).tolist() for n in lens]


def build_engine_model(name, cfg):
    """One of ``engine_models()`` in bf16 on the card, random weights from
    seed 0, in eval mode."""
    from paddle_tpu_torch.models import GPTForPretraining, LlamaForCausalLM

    cls = {"gpt3_1p3b": GPTForPretraining, "llama_7b": LlamaForCausalLM}[name]
    return cls(cfg, dtype=torch.bfloat16, seed=0).eval()


def engine_drive(model, vocab_size, tag, int8, prompts, profile=False):
    """One drive: a fresh ``serving.Engine`` over ``model`` with the paged
    kernel (and, with ``int8``, int8 weights with the int8 head kernel)
    serves ``prompts`` greedily, ``DRIVE_NEW`` tokens each. Launch counts
    are zeroed just before the drive and read just after it; every output
    must be its prompt and ``DRIVE_NEW`` in-vocabulary tokens, the pool must
    drain, and one decode step built with the kernels must hold to the same
    step built with the plain versions within ``LOGITS_REL_TOL``. Returns
    the drive's row (launch counts, tok/s, decode steps and step ms)."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    new = DRIVE_NEW
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": int8})
    eng = Engine(model, **ENGINE_KW, int8=int8, seed=0)
    try:
        K.reset_launch_counts()
        t0 = time.monotonic()
        handles = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = K.launch_counts()
        for p, o in zip(prompts, outs):
            if len(o) != len(p) + new or o[:len(p)] != p \
                    or not all(0 <= t < vocab_size for t in o):
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
        if not (np.isfinite(kl).all() and kl.shape == (8, vocab_size)):
            fail(f"engine ({tag}): debug logits {kl.shape} non-finite")
        rel = float(np.linalg.norm(kl - pl) / np.linalg.norm(pl))
        agree = float((kl.argmax(-1) == pl.argmax(-1)).mean())
        row = {"drive": tag, "int8": int8, "tok_s": len(outs) * new / wall,
               "wall_s": wall, "decode_steps": st["decode_steps"],
               "decode_step_ms_mean": st["decode_step_ms_mean"],
               "launches": {k: counts[k] for k in
                            ("paged_attention_rows", "int8_matmul")},
               "logits_rel_err": rel, "argmax_agree": agree,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  engine ({tag}) int8={int8}: {len(outs) * new} tokens in "
              f"{wall:.2f}s = {row['tok_s']:.1f} tok/s, "
              f"decode steps {st['decode_steps']}, mean decode step "
              f"{st['decode_step_ms_mean']:.2f} ms, launches {counts}; "
              f"kernel-vs-plain step logits rel_err={rel:.3e} "
              f"max_abs={float(np.abs(kl - pl).max()):.3e} "
              f"argmax_agree={agree:.3f} (tol rel {LOGITS_REL_TOL}); peak "
              f"memory {row['peak_gib']:.2f} GiB")
        if rel > LOGITS_REL_TOL:
            fail(f"engine ({tag}): kernel step logits rel_err {rel:.3e}")
    finally:
        eng.close()
    return row


def engine_phase(profile=False):
    """Each of ``engine_models()`` at full width and depth through two
    drives: GPT-3 1.3B (a) paged kernel, (b) int8 weights with both kernels;
    then Llama-7B (c), (d) the same. Each model and its engines are freed
    before the next model is built. Returns the launch counts summed over
    the drives, and the drives' rows."""
    drives = {"gpt3_1p3b": (("a", False), ("b", True)),
              "llama_7b": (("c", False), ("d", True))}
    total = {"paged_attention_rows": 0, "int8_matmul": 0}
    rows = []
    for name, cfg, _, _ in engine_models():
        t0 = time.monotonic()
        model = build_engine_model(name, cfg)
        torch.cuda.synchronize()
        print(f"  model: {name} bf16, {cfg.num_layers} layers, "
              f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}B "
              f"params, built in {time.monotonic() - t0:.1f}s")
        prompts = drive_prompts(cfg.vocab_size)
        for tag, int8 in drives[name]:
            torch.cuda.reset_peak_memory_stats()
            row = engine_drive(model, cfg.vocab_size, tag, int8, prompts,
                               profile)
            rows.append({"model": name, **row})
            for k, n in row["launches"].items():
                total[k] += n
            torch.cuda.empty_cache()
        del model
        torch.cuda.empty_cache()
    return total, rows


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
        for fn, st, reg in ptxas_functions(entry["ptxas"]):
            print(f"    {fn}: {reg} registers at entry, {st} spill-store "
                  "bytes")
    main_fn = f"{INT8_MMA}ILi4ELb1E"  # <NT = 4, trans>
    int8_ptxas = [f for f in ptxas_functions(log["int8_matmul"]["ptxas"])
                  if main_fn in f[0]]
    print(f"  the decode batch runs {INT8_MMA}<4, trans>: " + (
              f"{int8_ptxas[0][2]} registers, {int8_ptxas[0][1]} spill-store "
              "bytes" if int8_ptxas else "no ptxas report (cached build)"))
    int8_sass_check()

    print("[2] kernels against their plain versions")
    errs = kernel_phase()
    train_errs, long_errs = flash_phase()
    errs.update(train_errs)

    print("[3] engine: gpt3_1p3b, then llama_7b, through serving.Engine")
    launches, drives = engine_phase(profile=args.profile)

    print("[5] train: gpt3_1p3b through jit.compile_train_step")
    launches.update(train_phase(profile=args.profile))

    print("[4] kernel timing")
    rows, paged = timing_phase(errs, launches, int8_ptxas)
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
    for r in paged:
        print(f"  paged_attention_rows ({r['tag']}): {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, {r['split']} blocks a row) at {r['shape']}")
    print(json.dumps({"flash_long_shape": long_rows}))
    print(json.dumps({"paged_shapes": paged}))
    print(json.dumps({"engine_drives": drives}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
