"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run; needs one CUDA card
    python3 chip_smoke.py --profile  # + a device breakdown of the decode step

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. build: both CUDA kernels from ``paddle_tpu_torch/ops/kernels/csrc`` with
   nvcc for sm_90a (one nvcc per source, started together);
2. kernels: each kernel against its plain PyTorch version at the serving
   path's shapes, in float32 (tight tolerance: checks the algorithm) and
   bfloat16 (loose tolerance: checks the working type);
3. engine: GPT-3 1.3B at full width (24 layers, bf16, random weights from a
   seed) through ``serving.Engine`` over 32 greedy requests, (a) with the
   paged-attention kernel and (b) int8 weights with both kernels. Launch
   counts are zeroed just before each drive and read just after it; every
   output must have exactly prompt + 64 tokens and the pool must drain.
   One decode step built with the kernels is held against the same step
   built with the plain versions on the same pool state;
4. timing: each kernel (CUDA events) beside its plain version, the card's
   least time for the same work, and a one-call PyTorch yardstick where
   one exists.

The last two lines of stdout are the ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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
}
LOGITS_REL_TOL = 5e-2  # ||kernel - plain|| / ||plain|| of a full bf16 step


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
    out, ref = out.float(), ref.float()
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
    return rows


# -- engine phase ------------------------------------------------------------

def decode_profile(eng, tag, steps=16, B=32, ctx=640):
    """Where a decode step's time goes: the engine's own decode step at
    batch B and context ~ctx, run on this thread with the engine idle, under
    torch.profiler (CPU + CUDA). Prints the device busy share of the step
    window and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
    ev = sorted((e.start_ns(), e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA)
    if not ev:
        fail(f"profile ({tag}): the trace holds no device activity")
    busy, end, by_name = 0, 0, {}
    for a, b, name in ev:
        busy += max(0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0) + (b - a)
    window = ev[-1][1] - ev[0][0]
    print(f"  profile ({tag}) B={B} ctx~{ctx}: device window "
          f"{window / 1e6 / steps:.3f} "
          f"ms/step, busy {busy / 1e6 / steps:.3f} ms/step, idle share "
          f"{1 - busy / window:.3f}, {len(ev) / steps:.0f} device ops/step")
    for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace each engine's decode step on the device")
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

    print("[2] kernels against their plain versions")
    errs = kernel_phase()

    print("[3] engine: gpt3_1p3b through serving.Engine")
    launches = engine_phase(profile=args.profile)

    print("[4] kernel timing")
    rows = timing_phase(errs, launches)
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']}) at {r['shape']}")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
