"""Cost model (port of ``paddle_tpu/cost_model/__init__.py``): analytic
kernel-config estimates that order the autotuner's visits, a measured
profile of one callable, and a step program's memory footprint
(:func:`executable_memory` over a :class:`MeasuredStep`).

The reference takes a program's flops and bytes from XLA's
``cost_analysis()``; the port runs eagerly, so ``profile_measure`` counts
flops with ``torch.utils.flop_counter.FlopCounterMode`` and times the
callable on the monotonic clock. ``kernel_estimate`` keeps the reference's
branches (``flash_attention``, ``fused_ce``, ``paged_attention``,
``int8_matmul``, ``tp_collective``): on the CPU with the reference's CPU
constants and formulas where the port's kernel has the reference's axis
(``fused_ce``, ``flash_attention``, ``tp_collective``); on ``cuda`` with one
H100's figures; and for the port's own axes (the paged kernel's cluster
split, the int8 head's weight rows a block) with terms those kernels really
have.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

__all__ = ["CostModel", "MeasuredStep", "MEASURED_CALLS", "executable_memory",
           "leaves", "device_sync", "H100"]

# one H100 SXM (NVIDIA's data sheet): dense bf16 tensor-core rate, HBM3
# rate, SMs, shared memory a block can take, NVLink one way; and the host
# cost of one eager launch (an estimate: only ratios order the visits)
H100 = {"peak_flops": 989e12, "peak_bw": 3.35e12, "sms": 132,
        "smem": 232448, "link_bw": 4.5e11, "launch_ms": 5e-3}
# the reference's coarse non-TPU figures (its ``platform != "tpu"`` branch)
_CPU = {"peak_flops": 1e11, "peak_bw": 5e10, "overhead_ms": 2e-2,
        "link_bw": 5e9}

# the int8 head's bf16 kernel (csrc/int8_matmul.cu): a ring of kStages
# stages, each block_n weight rows x kC bytes of K plus kMP x rows of
# kXPitch bf16; one pass over the weight per kMP rows of x
_INT8_STAGES, _INT8_KC, _INT8_MP, _INT8_XPITCH = 4, 128, 32, 136
# the paged kernel (csrc/paged_attention.cu): warps a block, the blocks an
# SM should hold before the split stops doubling, the most a cluster takes
_PAGED_WARPS, _PAGED_BLOCKS_PER_SM, _PAGED_MAX_SPLIT = 4, 4, 8


# A step program's signature is measured on this many first calls, and its
# later calls are admitted with the last measurement. The first call builds
# the optimizer state and keeps the gradients, which every later call finds
# already in the live census; only the second call rises from where the
# calls after it start, so only it predicts them.
MEASURED_CALLS = 2


def leaves(out):
    """The tensors of a nested output (a tensor, tuples, lists, dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in leaves(o)]
    return []


def device_sync(out) -> None:
    """``torch.cuda.synchronize()`` when any tensor of ``out`` is on the
    card: a host clock read after it sees the device's work done."""
    if any(t.is_cuda for t in leaves(out)):
        torch.cuda.synchronize()


class MeasuredStep:
    """One call of a step program, measured: the port's counterpart of a
    compiled XLA executable's ``memory_analysis()``.

    A context manager around the call. On a CUDA device it resets the
    caching allocator's peak (``reset_peak_memory_stats``, process-wide for
    that device), reads ``memory_allocated`` before and after the call and
    ``max_memory_allocated`` after it, all host-side counters that never
    wait on the device. On the CPU it takes the profiler's census before
    and after (the live tensors ``gc`` can see) and has no peak. A call
    that raises is not measured. :meth:`memory_analysis` then answers as
    XLA's does, with ``argument_size_in_bytes`` (the live bytes before the
    call), ``output_size_in_bytes`` (their growth across it: the optimizer
    state a first step creates, the gradients it keeps),
    ``temp_size_in_bytes`` (the peak less the live bytes after; 0 on the
    CPU) and ``alias_size_in_bytes`` (0: the update writes in place and
    nothing is donated)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._before = self._after = self._peak = None

    def _live(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.memory_allocated(self.device))
        from .. import profiler

        return int(profiler.memory_census(self.device)["live_bytes"])

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self._before = self._live()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        self._after = self._live()
        self._peak = (int(torch.cuda.max_memory_allocated(self.device))
                      if self.device.type == "cuda" else self._after)
        return False

    def memory_analysis(self):
        if self._after is None:
            return None
        from types import SimpleNamespace

        return SimpleNamespace(
            argument_size_in_bytes=self._before,
            output_size_in_bytes=max(self._after - self._before, 0),
            temp_size_in_bytes=max(self._peak - self._after, 0),
            alias_size_in_bytes=0)


def executable_memory(compiled) -> Optional[Dict[str, int]]:
    """A step program's memory footprint: argument/output/temp/alias bytes
    plus the derived ``peak_bytes`` (argument + output + temp - alias, the
    reference's rule). ``compiled`` is anything with the reference's
    ``memory_analysis()``; in the port that is a :class:`MeasuredStep`.
    None when nothing could be measured (the call raised, or the object
    has no analysis).

    The reference predicts these numbers at compile time from XLA's
    analysis of the executable; the port measures them over a call that
    already happened. A first step's output includes the optimizer state it
    created and the gradients it kept, which the next call finds in the
    live census, so admitting from it would count them twice: the step
    programs measure a signature's first :data:`MEASURED_CALLS` calls and
    admit the later ones with the last measurement. ``fault/memory.py``
    keys these dicts by the step's signature and feeds the preflight HBM
    admission check."""
    try:
        ma = compiled.memory_analysis()
    except Exception:
        return None
    if ma is None:
        return None

    def g(name):
        return int(getattr(ma, name, 0) or 0)

    arg = g("argument_size_in_bytes")
    out = g("output_size_in_bytes")
    tmp = g("temp_size_in_bytes")
    alias = g("alias_size_in_bytes")
    return {
        "argument_bytes": arg,
        "output_bytes": out,
        "temp_bytes": tmp,
        "alias_bytes": alias,
        "peak_bytes": max(arg + out + tmp - alias, 0),
    }


def _pad(n, b):
    b = max(int(b), 1)
    return (-(-int(n) // b)) * b


def paged_split_rule(B, KV, BS, MB, n_sm=H100["sms"]) -> int:
    """The paged kernel's own cluster size (``split_for``): doubled while
    the B * KV blocks would not give 4 an SM and every block keeps at least
    64 positions of the MB * BS-position table."""
    split = 1
    while (split < _PAGED_MAX_SPLIT
           and B * KV * split < _PAGED_BLOCKS_PER_SM * n_sm
           and MB * BS >= 128 * split):
        split *= 2
    return split


def int8_blocks(n, block_n, n_sm=H100["sms"], smem=H100["smem"]):
    """(blocks, blocks an SM holds, waves) of the bf16 int8 head at N = n
    with ``block_n`` weight rows a block: ``ceil(n / block_n)`` blocks, as
    many resident an SM as its shared memory (``kSmemBytes``) allows."""
    blocks = -(-int(n) // int(block_n))
    stage = int(block_n) * _INT8_KC + _INT8_MP * _INT8_XPITCH * 2
    resident = max(smem // (_INT8_STAGES * stage), 1)
    return blocks, resident, -(-blocks // (n_sm * resident))


class CostModel:
    """``platform``: ``"cuda"`` or ``"cpu"``; by default the platform the
    port's entry points run on (``cuda`` when a card is present)."""

    def __init__(self, platform: Optional[str] = None):
        if platform is None:
            platform = "cuda" if torch.cuda.is_available() else "cpu"
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"platform must be cuda or cpu, got {platform!r}")
        self.platform = platform
        self._static_cache: Dict[tuple, dict] = {}
        self._ops = None  # ops.registry.all_ops(), read at first use
        self._inputs: Dict[tuple, torch.Tensor] = {}  # (shape, dtype) -> x

    # -- measured profile (reference profile_measure) -------------------------
    def profile_measure(self, program=None, startup_program=None,
                        device="gpu", fetch_cost_list=("time",), fn=None,
                        args=None, iters=10):
        """Time ``fn(*args)`` and count its flops. Returns ``{"time": ms per
        call, "flops": ...}``: the first call is excluded, the next
        ``iters`` calls run back to back on the monotonic clock with one
        device sync at the end; flops are one call's, counted by
        ``FlopCounterMode``."""
        if fn is None:
            raise ValueError("pass fn=<callable>, args=<inputs>")
        args = tuple(args or ())
        device_sync(fn(*args))
        t0 = time.monotonic()
        out = None
        for _ in range(int(iters)):
            out = fn(*args)
        device_sync(out)
        dt = (time.monotonic() - t0) / max(int(iters), 1)
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as fc:
            fn(*args)
        return {"time": dt * 1e3, "flops": float(fc.get_total_flops())}

    # -- kernel-config cost estimates (ops/kernels autotune ordering) --------
    def kernel_estimate(self, name, key, config):
        """Analytic cost estimate (ms-scale score) of one kernel config at one
        shape bucket: the ordering that decides which candidates the
        measured search visits first under its budget
        (``ops/kernels/autotune.candidates``). Relative order is all that
        matters; an unknown kernel scores 0.0 (stub kernels keep declared
        order)."""
        if self.platform == "cpu":
            peak_flops, peak_bw = _CPU["peak_flops"], _CPU["peak_bw"]
            overhead_ms, link_bw = _CPU["overhead_ms"], _CPU["link_bw"]
        else:
            peak_flops, peak_bw = H100["peak_flops"], H100["peak_bw"]
            overhead_ms, link_bw = H100["launch_ms"], H100["link_bw"]
        n_sm = H100["sms"]

        if name == "flash_attention":
            # the reference's roofline over padded tiles, a per-program
            # overhead and a spill penalty when the tiles outgrow fast memory
            bh, h, t, t_kv, d, dtype, causal = key
            bq, bk = int(config["block_q"]), int(config["block_k"])
            tq, tk = _pad(t, bq), _pad(t_kv, bk)
            flops = 4.0 * bh * tq * tk * d * (0.5 if causal else 1.0)
            bytes_ = 2.0 * bh * (tq + 2 * tk) * d * 4
            progs = bh * (tq // min(bq, tq))
            vmem = (bq * d + 2 * bk * d + bq * bk) * 4
            spill = 4.0 if vmem > 8 * 1024 * 1024 else 1.0
            if self.platform == "cuda":
                # one launch; the blocks run in parallel, so no per-block
                # overhead (the tile is the wgmma design's, one choice)
                progs, spill = 1, 1.0
        elif name == "fused_ce":
            # fwd + remat-bwd: 3 block-logits products over the padded rows
            n, d, v, dtype = key
            br = int(config["block_rows"])
            nr = _pad(n, br)
            flops = 3.0 * 2.0 * nr * d * v
            bytes_ = (nr * d + 2 * v * d + br * v) * 4.0
            progs = nr // br
            vmem = br * v * 4
            spill = 4.0 if vmem > 16 * 1024 * 1024 else 1.0
            if self.platform == "cuda":
                # the block logits go through device memory whatever the
                # block (written and read ~10 times over fwd + bwd), and each
                # block costs ~20 eager launches of host time
                bytes_ = (nr * d + 2 * v * d) * 4.0 + 10.0 * nr * v * 4
                progs, spill = 20 * (nr // br), 1.0
        elif name == "paged_attention":
            b, mb, bs, kv, rep, d, dtype = key
            split = int(config["split"]) or paged_split_rule(b, kv, bs, mb)
            es = 2 if str(dtype) == "bfloat16" else 4
            ctx = 0.5 * mb * bs  # live positions a row, on average
            flops = 4.0 * b * kv * rep * ctx * d
            bytes_ = 2.0 * b * ctx * kv * d * es + 2.0 * b * kv * rep * d * es
            blocks = b * kv * split
            # the bytes stream at the card's rate only with ~4 blocks an SM
            # in flight; a split adds its cluster merge: every warp's partial
            # (max, sum, rep x D output) read once, and two cluster barriers
            fill = min(1.0, blocks / (_PAGED_BLOCKS_PER_SM * n_sm))
            merge = 0.0 if split == 1 else (
                blocks * _PAGED_WARPS * (rep * d + 2 * rep) * 4.0 / peak_bw
                * 1e3 + 2e-3)
            return (max(flops / peak_flops, bytes_ / peak_bw) * 1e3 / fill
                    + merge + overhead_ms)
        elif name == "int8_matmul":
            m, k_dim, n, transpose_w, dtype = key
            bn = int(config["block_n"])
            blocks, resident, waves = int8_blocks(n, bn)
            # each resident block streams its bn x K weight bytes at one SM's
            # share of the card's rate; a wave ends when its blocks do (plus
            # ~1 us of latency and epilogue); one pass per 32 rows of x
            per_block_ms = bn * k_dim / (peak_bw / (n_sm * resident)) * 1e3
            passes = -(-int(m) // _INT8_MP)
            return (passes * (waves * (per_block_ms + 1e-3) + overhead_ms)
                    + 2.0 * m * k_dim * n / peak_flops * 1e3)
        elif name == "tp_collective":
            # the tensor-parallel all_gather of a decode step: key =
            # (wire_bytes, tp); the whole payload once over the link plus one
            # launch overhead a collective boundary
            wire_bytes, tp = key
            boundaries = max(int(tp) - 1, 1)
            return (float(wire_bytes) / link_bw) * 1e3 \
                + boundaries * overhead_ms
        else:
            return 0.0
        ms = (flops / peak_flops + bytes_ / peak_bw) * 1e3 * spill
        return ms + progs * overhead_ms

    # -- per-op costs (reference static_cost_data/get_static_op_time) --------
    def static_cost_data(self):
        """The measured per-op table built so far (``op/forward/dtype/shape``
        -> cost dict)."""
        return {f"{k[0]}/{k[1]}/{k[2]}/{k[3]}": v
                for k, v in self._static_cache.items()}

    def get_static_op_time(self, op_name, forward=True, dtype="float32",
                           shape=(1024, 1024), iters=5):
        """Measure (and cache by (op, forward, dtype, shape)) one op of
        ``ops.registry.all_ops()`` on one input of ``shape`` (uniform on
        [0.5, 1.5) from seed 0, on this model's platform): the forward, or
        with ``forward=False`` the forward and the backward of its (first)
        output's sum. Returns ``{"op_time": ms a call, "dtype", "bytes_in",
        "bytes_out"}``: CUDA events around ``iters`` calls after one
        untimed call on the card, ``perf_counter`` on the CPU."""
        import numpy as np

        from ..core import dtype as dtypes
        from ..ops.registry import all_ops

        key = (op_name, bool(forward), str(dtype), tuple(shape))
        if key in self._static_cache:
            return self._static_cache[key]
        if self._ops is None:
            self._ops = all_ops()
        ops = self._ops
        op = ops.get(op_name) or ops.get(f"functional.{op_name}")
        if op is None:
            raise KeyError(f"unknown op {op_name!r} (registry has "
                           f"{len(ops)})")
        dt = dtypes.convert_dtype(dtype)
        base = self._inputs.get((tuple(shape), dt))
        if base is None:  # drawn once a shape: the draw costs more than ops
            rng = np.random.RandomState(0)
            base = torch.from_numpy(rng.rand(*shape).astype(np.float32)
                                    + 0.5).to(self.platform).to(dt)
            self._inputs[(tuple(shape), dt)] = base
        x = base.clone()  # ops may write their input
        first = [None]

        if forward:
            def run():
                first[0] = op(x)
        else:
            x.requires_grad_(True)

            def run():
                out = op(x)
                out = out[0] if isinstance(out, (tuple, list)) else out
                first[0] = out
                out.sum().backward()
                x.grad = None
        run()
        out = first[0]
        outs = leaves(out)
        if self.platform == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(int(iters)):
                run()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / int(iters)
        else:
            t0 = time.perf_counter()
            for _ in range(int(iters)):
                run()
            ms = (time.perf_counter() - t0) / int(iters) * 1e3
        cost = {"op_time": ms, "dtype": str(dtype),
                "bytes_in": x.numel() * x.element_size(),
                "bytes_out": sum(o.numel() * o.element_size()
                                 for o in outs)}
        self._static_cache[key] = cost
        return cost
