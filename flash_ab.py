"""Time builds of the flash-attention source in turns on one CUDA card.

    python3 flash_ab.py parent=OLD.cu change=paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu
    python3 flash_ab.py parent=OLD.cu change=NEW.cu --train  # + train steps

Each LABEL=PATH is a version of ``csrc/flash_attention.cu`` with the same C
interface. All are compiled by nvcc with the port's flags (one nvcc per
source, started together) into ``_proof/ab/`` (listed in ``.gitignore``) and
loaded with ctypes. The port's wrappers are then pointed at each library in
turn, in the order given and back (A B B A), so that drift of the card or the
host reaches every build alike. Each turn measures, at the training shape
(B=2, T=2048, H=16, D=128, causal, bf16, strided q/k/v views) and at the
long-sequence shape (B=1, T=8192, H=16, D=64, causal, bf16), the device time
of the forward, dQ and dK/dV kernels (CUDA events) and the host time of one
wrapper call; with ``--train`` also 8 steps of GPT-3 1.3B (24 layers,
b2 x s2048, as ``chip_smoke.py`` trains it) after 2 warm-up steps: step ms,
the host's queueing ms per step, and how long the device ran on after the
last step was queued. Prints the card's name and power limit, then one JSON
line per turn.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

import chip_smoke as cs

OUT = cs.ROOT / "_proof" / "ab"


def build(variants):
    """{label: loaded library} for {label: source path}."""
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels.flash_attention import _SIGS

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, src in variants.items():
        so = OUT / f"lib{label}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        so)
    libs = {}
    for label, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"{label}: nvcc exited {proc.returncode}\n{text}")
        libs[label] = _build.open_library(so, _SIGS)
    return libs


def use(lib):
    from paddle_tpu_torch.ops.kernels import _build

    with _build._lock:
        _build._libs["flash_attention"] = lib


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
    ap.add_argument("--train", action="store_true",
                    help="also time GPT-3 1.3B train steps in each turn")
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
    libs = build(variants)
    train = None
    if args.train:
        import paddle_tpu_torch as pt

        model = cs.train_model()
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.named_parameters())
        step = pt.jit.compile_train_step(model, lambda m, i, l: m.loss(i, l),
                                         opt)
        train = (step, *cs.train_batch(model.config))
    for label in list(variants) + list(reversed(variants)):
        use(libs[label])
        row = {"build": label}
        kernel_turn(row, "train", cs.FLASH_TRAIN, True)
        kernel_turn(row, "long", cs.FLASH_LONG, False)
        if train:
            train_turn(row, *train)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
