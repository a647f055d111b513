"""Time builds of a kernel source in turns on one CUDA card (the flash
source by default, as the name says, or the paged-attention source).

    python3 flash_ab.py parent=OLD.cu change=paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu
    python3 flash_ab.py parent=OLD.cu change=NEW.cu --train  # + train steps
    python3 flash_ab.py --lib paged_attention parent=OLD.cu \
        change=paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu

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
mark, so that every turn's drive launches the same shapes.
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
        "paged_attention": "paddle_tpu_torch.ops.kernels.paged_attention"}
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
    for tag, B, MB, pos in cs.PAGED_SHAPES:
        r = cs.paged_timing(tag, B, MB, pos, plain=False, split=False)
        row[f"{tag}_ms"] = r["ms"]
        row[f"{tag}_bound_ms"] = r["bound_ms"]


def decode_setup():
    """GPT-3 1.3B bf16 behind an idle engine with the paged kernel on, and
    its decode step at batch 32, context ~640."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b
    from paddle_tpu_torch.serving import Engine

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0)
    model = GPTForPretraining(cfg, dtype=torch.bfloat16, seed=0).eval()
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    eng = Engine(model, **cs.ENGINE_KW, seed=0)
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


def drive_turn(row, eng, prompts):
    """The engine drive under torch.profiler: the paged kernel's device
    time per decode step and per launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops import kernels as K

    steps = eng.stats()["decode_steps"]
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drive(eng, prompts)
    steps = eng.stats()["decode_steps"] - steps
    launches = K.launch_counts()["paged_attention_rows"]
    ns = [e.end_ns() - e.start_ns()
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA
          and "paged_attention_kernel" in e.name()]
    row["drive_decode_steps"] = steps
    row["drive_paged_launches"] = launches
    row["drive_paged_traced"] = len(ns)  # 0: the trace missed the kernels
    row["drive_paged_ms_per_step"] = sum(ns) / 1e6 / steps if ns else None
    row["drive_paged_us_per_launch"] = sum(ns) / 1e3 / len(ns) if ns else None


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
    if args.lib == "paged_attention":
        eng, step, prompts = decode_setup()
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
            if eng is not None:
                paged_turn(row)
                decode_turn(row, step)
                drive_turn(row, eng, prompts)
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
