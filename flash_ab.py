"""Time builds of a kernel source in turns on one CUDA card (the flash
source by default, as the name says, the paged-attention source or the int8
head's source).

    python3 flash_ab.py parent=OLD.cu change=paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu
    python3 flash_ab.py parent=OLD.cu change=NEW.cu --train  # + train steps
    python3 flash_ab.py --lib paged_attention parent=OLD.cu \
        change=paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu
    python3 flash_ab.py --lib int8_matmul parent=OLD.cu \
        change=paddle_tpu_torch/ops/kernels/csrc/int8_matmul.cu

Each LABEL=PATH is a version of ``csrc/<lib>.cu`` (``--lib``, by default
``flash_attention``) with the same C interface. All are compiled by nvcc
with the port's flags (one nvcc per source, started together) into
``_proof/ab/`` (listed in ``.gitignore``) and loaded with ctypes. The port's
wrappers are then pointed at each library in turn, in the order given and
back (A B B A), so that drift of the card or the host reaches every build
alike. Prints the card's name and power limit, then one JSON line per turn.

Flash: each turn measures, at the training shape (B=2, T=2048, H=16, D=128,
causal, bf16, strided q/k/v views) and at the long-sequence shape (B=1,
T=8192, H=16, D=64, causal, bf16), the device time of the forward, dQ and
dK/dV kernels (CUDA events) and the host time of one wrapper call; with
``--train`` also 8 steps of GPT-3 1.3B (24 layers, b2 x s2048, as
``chip_smoke.py`` trains it) after 2 warm-up steps: step ms, the host's
queueing ms per step, and how long the device ran on after the last step
was queued.

Paged attention: each turn measures the kernel's device time at each of
``chip_smoke.PAGED_SHAPES``; the engine's decode step of GPT-3 1.3B (bf16,
paged kernel on; batch 32, context ~640, as ``chip_smoke.py --profile``
sets it up, without the profiler): host clock per step, each step ending
in the engine's copy of the tokens to the host; and the engine phase's
drive (a) (32 requests, prompts of 128 to 1024 tokens, 64 new each: ragged
contexts over every decode bucket) under torch.profiler: the paged
kernel's device time per decode step and per launch. An untimed drive
before the first turn brings every bucket's table width to its high-water
mark, so that every turn's drive launches the same shapes. Each turn also
times one drive without the profiler (tokens/s on the host clock).

The int8 head: each turn measures the kernel's device time at each of
``chip_smoke.INT8_TIMING_ROWS`` (bf16, K = 2048, N = 50304), with the weight
stored (N, K) (``m<M>_ms``, the GPT head) and (K, N) (``kn_m<M>_ms``, the
Llama head's layout);
and, as for paged attention, the decode step and the drives, on an engine
with int8 weights and both kernels on (the engine phase's drive (b)): the
int8 head's device time per decode step and per launch (prefill launches
included).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

import chip_smoke as cs

OUT = cs.ROOT / "_proof" / "ab"
SIGS = {"flash_attention": "paddle_tpu_torch.ops.kernels.flash_attention",
        "paged_attention": "paddle_tpu_torch.ops.kernels.paged_attention",
        "int8_matmul": "paddle_tpu_torch.ops.kernels.int8_matmul"}
# the engine libraries: (their wrapper's launch count, a name every build's
# kernel carries in the trace, the drive keys' tag)
ENGINE_LIBS = {"paged_attention": ("paged_attention_rows",
                                   "paged_attention_kernel", "paged"),
               "int8_matmul": ("int8_matmul", "int8_matmul", "int8")}
DECODE_STEPS = 30


def build(variants, lib):
    """{label: loaded library} for {label: source path} of ``csrc/<lib>.cu``."""
    import importlib

    from paddle_tpu_torch.ops.kernels import _build

    sigs = importlib.import_module(SIGS[lib])._SIGS
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in variants.items():
        so = OUT / f"lib{lib}-{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        so)
    libs = {}
    for label, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"{label}: nvcc exited {proc.returncode}\n{text}")
        libs[label] = _build.open_library(so, sigs)
    return libs


def use(name, lib):
    from paddle_tpu_torch.ops.kernels import _build

    with _build._lock:
        _build._libs[name] = lib


def kernel_turn(row, tag, shape, fused_qkv):
    from paddle_tpu_torch.ops import kernels as K

    B, T, Tk, H, D, causal = shape
    q, k, v, do = cs.flash_inputs(B, T, Tk, H, D, torch.bfloat16,
                                  fused_qkv=fused_qkv, seed=1)
    o, lse = K.flash_attention_fwd(q, k, v, causal)
    delta = cs.flash_delta(do, o)
    calls = {
        "fwd": lambda: K.flash_attention_fwd(q, k, v, causal),
        "dq": lambda: K.flash_attention_dq(q, k, v, do, lse, delta, causal),
        "dkv": lambda: K.flash_attention_dkv(q, k, v, do, lse, delta, causal),
    }
    for name, fn in calls.items():
        row[f"{tag}_{name}_ms"] = cs.time_ms(fn, iters=50)
        row[f"{tag}_{name}_host_us"] = cs.host_us(fn, calls=500)


def paged_turn(row):
    for tag, B, MB, pos, kv in cs.PAGED_SHAPES:
        r = cs.paged_timing(tag, B, MB, pos, kv, plain=False, split=False)
        row[f"{tag}_ms"] = r["ms"]
        row[f"{tag}_bound_ms"] = r["bound_ms"]


def int8_turn(row):
    from paddle_tpu_torch.ops import kernels as K

    qw, s = cs.int8_weight(*cs.INT8_HEAD, seed=1)
    qkn = qw.T.contiguous()
    for M in cs.INT8_TIMING_ROWS:
        x = cs.int8_x(M, cs.INT8_HEAD[0], torch.bfloat16, seed=1)
        row[f"m{M}_ms"] = cs.time_ms(
            lambda: K.int8_matmul(x, qw, s, transpose_w=True), iters=50)
        row[f"kn_m{M}_ms"] = cs.time_ms(
            lambda: K.int8_matmul(x, qkn, s, transpose_w=False), iters=50)
    del qw, qkn
    torch.cuda.empty_cache()


def decode_setup(int8=False):
    """GPT-3 1.3B bf16 behind an idle engine with the paged kernel on (and
    with ``int8``, int8 weights and the int8 head kernel), and its decode
    step at batch 32, context ~640."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b
    from paddle_tpu_torch.serving import Engine

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForPretraining(cfg, dtype=torch.bfloat16, seed=0).eval()
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": int8})
    eng = Engine(model, **cs.ENGINE_KW, int8=int8, seed=0)
    with torch.inference_mode():
        step = cs.decode_step(eng)
    return eng, step, cs.drive_prompts(cfg.vocab_size)


def drive(eng, prompts):
    handles = [eng.submit(p, max_new_tokens=cs.DRIVE_NEW) for p in prompts]
    for h in handles:
        h.result(timeout=900)
    deadline = time.monotonic() + 30  # the scheduler ends its last step
    while eng.stats()["running"] and time.monotonic() < deadline:
        time.sleep(0.01)
    torch.cuda.synchronize()


def drive_turn(row, eng, prompts, lib):
    """One engine drive on the host clock (tokens/s), then one under
    torch.profiler: ``lib``'s kernel's device time per decode step and per
    launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    count, kernel, tag = ENGINE_LIBS[lib]
    t0 = time.monotonic()
    drive(eng, prompts)
    row["drive_tok_s"] = len(prompts) * cs.DRIVE_NEW / (time.monotonic() - t0)
    steps = eng.stats()["decode_steps"]
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive(eng, prompts)
    steps = eng.stats()["decode_steps"] - steps
    launches = K.launch_counts()[count]
    ns = [e.end_ns() - e.start_ns()
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA and kernel in e.name()]
    row["drive_decode_steps"] = steps
    row[f"drive_{tag}_launches"] = launches
    row[f"drive_{tag}_traced"] = len(ns)  # 0: the trace missed the kernels
    row[f"drive_{tag}_ms_per_step"] = sum(ns) / 1e6 / steps if ns else None
    row[f"drive_{tag}_us_per_launch"] = sum(ns) / 1e3 / len(ns) if ns else None


def decode_turn(row, step):
    with torch.inference_mode():
        for _ in range(3):
            step()
        ms = []
        for _ in range(DECODE_STEPS):
            t0 = time.perf_counter()
            step()
            ms.append((time.perf_counter() - t0) * 1e3)
    row["decode_step_ms_median"] = statistics.median(ms)
    row["decode_step_ms_mean"] = statistics.fmean(ms)


def train_turn(row, step, ids, labels):
    for _ in range(cs.TRAIN_WARMUP):
        step(ids, labels)
    torch.cuda.synchronize()
    losses, queued, wall = cs.time_steps(step, ids, labels, cs.TRAIN_STEPS)
    row["step_ms"] = wall / cs.TRAIN_STEPS * 1e3
    row["queued_ms_per_step"] = queued / cs.TRAIN_STEPS * 1e3
    row["drain_ms"] = (wall - queued) * 1e3
    row["last_loss"] = losses[-1].item()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", metavar="LABEL=PATH")
    ap.add_argument("--lib", choices=sorted(SIGS), default="flash_attention",
                    help="the kernel source the variants are versions of")
    ap.add_argument("--train", action="store_true",
                    help="flash: also time GPT-3 1.3B train steps in each "
                         "turn")
    ap.add_argument("--kernels-only", action="store_true",
                    help="paged attention, int8 head: time the kernel only, "
                         "with no engine")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    variants = dict(v.split("=", 1) for v in args.variants)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    libs = build(variants, args.lib)
    train = eng = None
    if args.lib in ENGINE_LIBS and not args.kernels_only:
        eng, step, prompts = decode_setup(int8=args.lib == "int8_matmul")
        use(args.lib, libs[next(iter(variants))])
        drive(eng, prompts)
    elif args.train:
        import paddle_tpu_torch as pt

        model = cs.train_model()
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.named_parameters())
        step = pt.jit.compile_train_step(model, lambda m, i, l: m.loss(i, l),
                                         opt)
        train = (step, *cs.train_batch(model.config))
    try:
        for label in list(variants) + list(reversed(variants)):
            use(args.lib, libs[label])
            row = {"build": label}
            if args.lib in ENGINE_LIBS:
                (int8_turn if args.lib == "int8_matmul" else paged_turn)(row)
                if eng is not None:
                    decode_turn(row, step)
                    drive_turn(row, eng, prompts, args.lib)
            else:
                kernel_turn(row, "train", cs.FLASH_TRAIN, True)
                kernel_turn(row, "long", cs.FLASH_LONG, False)
                if train:
                    train_turn(row, *train)
            print(json.dumps(row), flush=True)
    finally:
        if eng is not None:
            eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
