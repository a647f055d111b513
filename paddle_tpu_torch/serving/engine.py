"""Serving engine — continuous batching over a paged KV cache (port of the
main path of ``paddle_tpu/serving/engine.py``).

* ``submit()`` enqueues from any thread; a dedicated scheduler thread admits
  and retires sequences EVERY decode step (continuous batching);
* prompts prefill as dense causal passes batched by length bucket (powers of
  two in block units) at a fixed prefill batch width; decode runs one packed
  batch at the smallest bucket width covering the live set;
* the KV cache is a preallocated pool of fixed-size blocks (``pool.py``) with
  a block table per sequence. Pool exhaustion is backpressure: admission
  waits, and a sequence that cannot grow evicts the youngest peer (its
  tokens are requeued for re-prefill) rather than failing anything;
* ``FLAGS_serve_paged_kernel`` routes decode attention through the
  paged-attention kernel; ``int8=True`` serves weight-only int8 weights
  (``int8.py``) and ``FLAGS_serve_int8_kernel`` keeps the LM head int8
  through the int8 matmul kernel.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without CUDA
and without that request it raises. The scheduler thread enters
``torch.inference_mode()`` and sets the CUDA device itself (both are
thread-local in PyTorch).
"""
from __future__ import annotations

import collections
import copy
import itertools
import queue as _queue
import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.place import resolve_device
from ..framework import flags
from ..models import generation as G
from ..profiler import counter_inc, span
from .int8 import attach_int8_head, dequantize_tree, quantize_params
from .pool import TRASH_BLOCK, PagePool

__all__ = ["Engine", "EngineConfig", "RequestHandle", "ServeError",
           "RequestCancelled"]


class ServeError(RuntimeError):
    pass


class RequestCancelled(ServeError):
    pass


class EngineConfig:
    """Serving knobs. ``None`` fields resolve from the ``FLAGS_serve_*``
    registry at engine construction; ``device`` None means ``cuda``."""

    def __init__(self, block_size=None, num_blocks=None, max_batch=None,
                 max_seq_len=None, prefill_batch=None, int8=None,
                 decode_buckets=None, seed=0, device=None):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.prefill_batch = prefill_batch
        self.int8 = int8
        self.decode_buckets = decode_buckets
        self.seed = seed
        self.device = device

    def resolve(self, model_max_positions: int) -> "EngineConfig":
        def pick(v, name):
            # explicit 0 must reach validation, not silently fall back
            return int(v if v is not None else flags.flag(name))

        self.block_size = pick(self.block_size, "FLAGS_serve_block_size")
        self.num_blocks = pick(self.num_blocks, "FLAGS_serve_num_blocks")
        self.max_batch = pick(self.max_batch, "FLAGS_serve_max_batch")
        self.prefill_batch = pick(self.prefill_batch, "FLAGS_serve_prefill_batch")
        max_seq = pick(self.max_seq_len, "FLAGS_serve_max_seq_len")
        self.max_seq_len = min(max_seq, int(model_max_positions))
        if self.int8 is None:
            self.int8 = bool(flags.flag("FLAGS_serve_int8", False))
        if self.block_size < 1 or self.num_blocks < 2 or self.max_batch < 1 \
                or self.prefill_batch < 1 or self.max_seq_len < 1:
            raise ValueError(
                "serving: block_size/max_batch/prefill_batch/max_seq_len "
                ">= 1 and num_blocks >= 2 required")
        if self.decode_buckets is None:
            b, buckets = 1, []
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            self.decode_buckets = tuple(buckets) + (self.max_batch,)
        else:
            # drop widths past the ceiling, keep ascending order, and make
            # sure max_batch itself is present so every live set has a bucket
            kept = sorted({int(b) for b in self.decode_buckets
                           if 0 < int(b) <= self.max_batch})
            if not kept or kept[-1] != self.max_batch:
                kept.append(self.max_batch)
            self.decode_buckets = tuple(kept)
        return self


class _Request:
    __slots__ = ("id", "prompt", "max_new_tokens", "eos_token_id",
                 "temperature", "tokens", "error", "done", "stream_q",
                 "cancelled")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id, temperature,
                 stream):
        self.id = rid
        self.prompt = prompt  # list[int]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.tokens: Optional[List[int]] = None  # final ids, set at finish
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.stream_q = _queue.Queue() if stream else None
        self.cancelled = False


def _finish(req: _Request, tokens=None, error=None) -> bool:
    """Terminal state for a request (first writer wins)."""
    if req.done.is_set():
        return False
    req.tokens = list(tokens) if tokens is not None else None
    req.error = error
    counter_inc("serve_cancelled" if isinstance(error, RequestCancelled)
                else "serve_failed" if error is not None else "serve_retired")
    if req.stream_q is not None:
        req.stream_q.put(None)
    req.done.set()
    return True


class _Seq:
    """Scheduler-side state of one admitted sequence. ``tokens`` holds
    prompt + generated ids; the newest id's KV is NOT yet in cache — its
    write position is ``pos = len(tokens) - 1``."""

    __slots__ = ("req", "tokens", "blocks", "prompt_len")

    def __init__(self, req: _Request, tokens: List[int]):
        self.req = req
        self.tokens = tokens
        self.blocks: List[int] = []
        self.prompt_len = len(req.prompt)

    @property
    def pos(self) -> int:
        return len(self.tokens) - 1

    @property
    def generated(self) -> int:
        return len(self.tokens) - self.prompt_len


class RequestHandle:
    """Client-side handle: blocking ``result()``, streaming iteration, and
    ``cancel()``."""

    def __init__(self, req: _Request, engine: "Engine"):
        self._req = req
        self._engine = engine

    @property
    def request_id(self) -> int:
        return self._req.id

    @property
    def done(self) -> bool:
        return self._req.done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Full token ids (prompt + generated). Raises the request's
        failure (``RequestCancelled`` after ``cancel()``)."""
        if not self._req.done.wait(timeout):
            raise TimeoutError(f"request {self._req.id} still in flight")
        if self._req.error is not None:
            raise self._req.error
        return list(self._req.tokens)

    def cancel(self) -> None:
        self._engine._cancel(self._req)

    def __iter__(self):
        """Generated token ids as they land (``submit(stream=True)``). Ends
        cleanly on completion OR cancellation; terminal errors re-raise."""
        if self._req.stream_q is None:
            raise ServeError("submit(stream=True) to iterate tokens")

        def finish():
            if self._req.error is not None and not isinstance(
                    self._req.error, RequestCancelled):
                raise self._req.error

        while True:
            try:
                item = self._req.stream_q.get(timeout=0.1)
            except _queue.Empty:
                if self._req.done.is_set() and self._req.stream_q.empty():
                    finish()
                    return
                continue
            if item is None:
                finish()
                return
            yield item


class Engine:
    """Continuous-batching serving engine over a paged KV cache.

    ``model`` is a ``GPTForPretraining`` or a ``LlamaForCausalLM``. The
    scheduler thread owns all scheduler state; only the submission queue and
    stop flag cross threads.
    """

    def __init__(self, model, config: Optional[EngineConfig] = None,
                 **overrides):
        if hasattr(model, "gpt"):
            decode_state = G.gpt_decode_state
        elif hasattr(model, "lm_head") and hasattr(model, "model"):
            decode_state = G.llama_decode_state
        else:
            raise TypeError(f"serving.Engine: unsupported model "
                            f"{type(model).__name__} (expected "
                            "GPTForPretraining or LlamaForCausalLM)")
        if config is not None and overrides:
            raise ValueError("pass EngineConfig OR keyword overrides, not both")
        cfg = copy.copy(config or EngineConfig(**overrides))
        device = resolve_device(cfg.device)
        _, arch, params, max_pos = decode_state(model, device)
        self.config = cfg.resolve(max_pos)
        self._device = device
        self._arch = arch
        self._dtype = params["wte"].dtype
        if cfg.int8:
            tagged = quantize_params(params)
            self._plain_params = dequantize_tree(tagged, self._dtype)
            self._params = (attach_int8_head(self._plain_params, tagged)
                            if flags.flag("FLAGS_serve_int8_kernel", False)
                            else self._plain_params)
        else:
            self._params = self._plain_params = params
        del params
        self._n_layers = len(self._params["layers"])
        self._max_blocks = -(-cfg.max_seq_len // cfg.block_size)
        # zeros, never empty: padding rows read trash block 0 under a -inf
        # mask on the plain path, and 0 * NaN would poison it
        shape = (self._n_layers, cfg.num_blocks, cfg.block_size,
                 arch["kv_heads"], arch["head_dim"])
        self._kpool = torch.zeros(shape, dtype=self._dtype, device=self._device)
        self._vpool = torch.zeros(shape, dtype=self._dtype, device=self._device)
        self._pool = PagePool(cfg.num_blocks)
        self._prefill_buckets = self._make_prefill_buckets()

        # scheduler-thread-only state
        self._fns: Dict[tuple, object] = {}
        self._decode_mb: Dict[int, int] = {}
        self._running: List[_Seq] = []
        self._resume: List[_Seq] = []  # preempted, awaiting re-prefill
        self._admitting: List[_Seq] = []  # popped off the queue, mid-prefill
        self._gen = torch.Generator(device=self._device).manual_seed(cfg.seed)
        self._rng = np.random.default_rng(cfg.seed)
        self._step_i = 0
        self._occ_live = 0
        self._occ_slots = 0
        self._decode_s = 0.0  # host time of decode steps, each ending in a sync

        # cross-thread state
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiting: "collections.deque[_Request]" = collections.deque()  # guarded_by: _cv
        self._stop = False  # guarded_by: _cv
        self._broken: Optional[BaseException] = None
        self._ids = itertools.count(1)
        # the thread holds the engine only through a weakref, so an
        # abandoned engine stays collectable (__del__ closes it)
        self._thread = threading.Thread(
            target=_engine_loop, args=(weakref.ref(self), self._device),
            daemon=True, name="paddle_tpu_torch_serving")
        self._thread.start()

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, temperature: float = 0.0,
               stream: bool = False) -> RequestHandle:
        """Enqueue one request (any thread). ``temperature == 0`` is greedy.
        ``stream=True`` additionally feeds the handle's iterator per token."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("serving: empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("serving: max_new_tokens must be >= 1")
        total = len(prompt) + int(max_new_tokens)
        if total > self.config.max_seq_len:
            raise ValueError(
                f"serving: prompt + max_new_tokens = {total} exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        if -(-total // self.config.block_size) > self._pool.num_blocks - 1:
            raise ValueError(
                "serving: request needs more KV blocks than the whole pool; "
                "raise FLAGS_serve_num_blocks")
        with self._cv:
            if self._stop or self._broken is not None:
                raise ServeError("serving engine is closed") from self._broken
            req = _Request(next(self._ids), prompt, max_new_tokens,
                           eos_token_id, temperature, stream)
            self._waiting.append(req)
            counter_inc("serve_requests")
            self._cv.notify()
        return RequestHandle(req, self)

    def generate(self, prompt_ids, **kw) -> List[int]:
        """Synchronous convenience: submit + wait."""
        return self.submit(prompt_ids, **kw).result()

    def stats(self) -> dict:
        """Scheduler gauges (safe from any thread; racy snapshots)."""
        with self._lock:
            depth = len(self._waiting)
        steps = self._step_i
        return {
            "queue_depth": depth,
            "running": len(self._running),
            "preempted_waiting": len(self._resume),
            "batch_occupancy_mean": round(
                self._occ_live / self._occ_slots if self._occ_slots else 0.0, 4),
            "pages_total": self._pool.num_blocks - 1,
            "pages_used": self._pool.used_blocks,
            "pages_free": self._pool.free_blocks,
            "compiles": len(self._fns),
            "decode_steps": steps,
            "decode_step_ms_mean": (1e3 * self._decode_s / steps
                                    if steps else 0.0),
        }

    def close(self, timeout: float = 30.0) -> None:
        """Stop the scheduler thread and fail outstanding requests with
        ``ServeError``. Idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout)
            if self._thread.is_alive():
                self._broken = self._broken or ServeError(
                    f"serving scheduler thread did not stop within {timeout}s")
                # handle state only: a live thread may still own the pool
                with self._cv:
                    waiting = list(self._waiting)
                    self._waiting.clear()
                for req in waiting + [s.req for s in self._running
                                      + self._resume + self._admitting]:
                    _finish(req, error=ServeError(str(self._broken)))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close(timeout=2.0)
        except Exception:
            pass

    # ------------------------------------------------------- engine thread
    def _run_once(self) -> bool:
        """One scheduler iteration (bounded idle wait). True = stopped."""
        with self._cv:
            idle = not (self._waiting or self._running or self._resume)
            if not self._stop and idle:
                self._cv.wait(timeout=0.5)
            if self._stop:
                return True
            has_work = bool(self._waiting or self._running or self._resume)
        if has_work:
            self._step_impl()
        return False

    def _step_impl(self):
        with span("schedule", step=self._step_i, running=len(self._running)):
            self._drain_cancels()
            # tracked so a crash mid-prefill fails their handles too
            self._admitting = self._admit()
            if self._admitting:
                self._prefill(self._admitting)
            self._admitting = []
            if self._running:
                self._decode()

    # -- admission ----------------------------------------------------------
    def _make_prefill_buckets(self):
        bs = self.config.block_size
        t_pad = self._max_blocks * bs
        buckets, b = [], bs
        while b < t_pad:
            buckets.append(b)
            b *= 2
        buckets.append(t_pad)
        return tuple(buckets)

    def _bucket_for(self, n: int) -> int:
        for b in self._prefill_buckets:
            if b >= n:
                return b
        raise ValueError(f"no prefill bucket covers length {n}")

    def _headroom_ok(self, need: int, extra_running: int) -> bool:
        # AFTER granting `need`, keep one spare block per running sequence so
        # the next decode steps don't immediately preempt what admission
        # just packed in
        return self._pool.free_blocks - need >= len(self._running) + extra_running

    def _grant(self, n_tokens: int, extra_running: int):
        need = -(-n_tokens // self.config.block_size)
        return self._pool.alloc(need) if self._headroom_ok(
            need, extra_running) else None

    def _admit(self) -> List[_Seq]:
        """Preempted sequences first, then the queue in FIFO order; stops at
        the first request the pool's headroom cannot take."""
        admitted: List[_Seq] = []
        max_batch = self.config.max_batch
        with span("admit") as sp:
            still_resume = []
            for seq in self._resume:
                blocks = (self._grant(len(seq.tokens), len(admitted) + 1)
                          if len(self._running) + len(admitted) < max_batch
                          else None)
                if blocks is None:
                    still_resume.append(seq)
                    continue
                seq.blocks = blocks
                admitted.append(seq)
            self._resume = still_resume
            with self._cv:
                cand = list(self._waiting)
            for req in cand:
                if len(self._running) + len(admitted) >= max_batch:
                    break
                with self._cv:
                    blocks = self._grant(len(req.prompt), len(admitted) + 1)
                    if blocks is None:
                        counter_inc("serve_backpressure")
                        break
                    try:
                        self._waiting.remove(req)
                    except ValueError:  # raced away mid-pass — undo the grant
                        self._pool.free(blocks)
                        continue
                seq = _Seq(req, list(req.prompt))
                seq.blocks = blocks
                admitted.append(seq)
            if admitted:
                counter_inc("serve_admitted", len(admitted))
            sp.set(admitted=len(admitted), resume_waiting=len(self._resume))
        return admitted

    # -- prefill -------------------------------------------------------------
    def _prefill(self, seqs: List[_Seq]):
        bw = self.config.prefill_batch
        groups: Dict[int, List[_Seq]] = {}
        for s in seqs:
            groups.setdefault(self._bucket_for(len(s.tokens)), []).append(s)
        for t_bucket in sorted(groups):
            group = groups[t_bucket]
            for i in range(0, len(group), bw):
                chunk = group[i:i + bw]
                with span("prefill", bucket_t=t_bucket, bucket_b=bw,
                          rows=len(chunk)):
                    fn = self._get_fn("prefill", bw, t_bucket)
                    ids = np.zeros((bw, t_bucket), np.int32)
                    lens = np.ones((bw,), np.int32)
                    tables = np.full((bw, self._max_blocks), TRASH_BLOCK,
                                     np.int32)
                    for r, s in enumerate(chunk):
                        ids[r, :len(s.tokens)] = s.tokens
                        lens[r] = len(s.tokens)
                        tables[r, :len(s.blocks)] = s.blocks
                    self._kpool, self._vpool, logits = fn(
                        self._params, self._dev(ids), self._dev(lens),
                        self._dev(tables), self._kpool, self._vpool)
                    counter_inc("serve_prefills")
                    self._land_prefill(chunk, logits.float().cpu().numpy())

    def _land_prefill(self, chunk: List[_Seq], rows: np.ndarray):
        """Sample each row's first generated token and move the sequence
        into the running set."""
        for r, s in enumerate(chunk):
            self._append_token(s, self._sample_host(rows[r], s.req))
            if not s.req.done.is_set():
                self._running.append(s)

    def _sample_host(self, logits_row: np.ndarray, req: _Request) -> int:
        """The first generated token (prefill output) is sampled host-side."""
        if req.temperature <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / max(req.temperature, 1e-6)
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # -- decode --------------------------------------------------------------
    def _grow_blocks(self):
        """Every live sequence needs block ``pos // block_size`` mapped
        before the step; pool exhaustion preempts the youngest peer (evict →
        requeue for re-prefill) — backpressure, never failure."""
        for seq in list(self._running):
            if seq not in self._running:
                continue  # evicted by an earlier iteration
            need = seq.pos // self.config.block_size + 1 - len(seq.blocks)
            while need > 0:
                with span("page_alloc", request=seq.req.id, blocks=need):
                    got = self._pool.alloc(need)
                if got is not None:
                    seq.blocks.extend(got)
                    break
                victims = [s for s in self._running if s is not seq]
                if not victims:
                    # a lone sequence always fits (submit() bounds it)
                    raise ServeError(f"page pool exhausted by a single "
                                     f"sequence (request {seq.req.id})")
                self._evict(max(victims, key=lambda s: s.req.id))

    def _evict(self, seq: _Seq):
        with span("evict", request=seq.req.id, generated=seq.generated):
            self._pool.free(seq.blocks)
            seq.blocks = []
            self._running.remove(seq)
            self._resume.append(seq)
            counter_inc("serve_preempted")

    def _gather_width(self, bb: int) -> int:
        """Per-decode-bucket table width in blocks: the bucket's high-water
        live block count rounded up to a power of two, never shrinking. A
        width upgrade replaces the bucket's built step."""
        hw = max(len(s.blocks) for s in self._running)
        mb = self._decode_mb.get(bb, 0)
        if hw > mb:
            mb = 1
            while mb < hw:
                mb *= 2
            mb = min(mb, self._max_blocks)
            old = self._decode_mb.get(bb)
            if old is not None:
                self._fns.pop(("decode", bb, old), None)
            self._decode_mb[bb] = mb
        return mb

    def _decode(self):
        self._grow_blocks()
        if not self._running:
            return
        n = len(self._running)
        bb = next(b for b in self.config.decode_buckets if b >= n)
        mb = self._gather_width(bb)
        tables = np.full((bb, mb), TRASH_BLOCK, np.int32)
        pos = np.zeros((bb,), np.int32)
        toks = np.zeros((bb,), np.int32)
        temps = np.zeros((bb,), np.float32)
        for r, s in enumerate(self._running):
            tables[r, :len(s.blocks)] = s.blocks
            pos[r] = s.pos
            toks[r] = s.tokens[-1]
            temps[r] = s.req.temperature
        with span("decode_step", bucket=bb, rows=n, step=self._step_i):
            fn = self._get_fn("decode", bb, mb)
            t0 = time.monotonic()
            self._kpool, self._vpool, nxt = fn(
                self._params, self._kpool, self._vpool, self._dev(tables),
                self._dev(pos), self._dev(toks), self._dev(temps), self._gen)
            nxt = nxt.cpu().numpy()
            self._decode_s += time.monotonic() - t0
        self._step_i += 1
        self._occ_live += n
        self._occ_slots += bb
        counter_inc("serve_decode_steps")
        for r, s in enumerate(list(self._running)):
            self._append_token(s, int(nxt[r]))

    def _append_token(self, seq: _Seq, tok: int):
        """Record one generated token; retire the sequence when it hits eos,
        its budget, or a cancel flag."""
        req = seq.req
        seq.tokens.append(tok)
        counter_inc("serve_tokens")
        if req.stream_q is not None:
            req.stream_q.put(tok)
        if req.cancelled:
            self._retire(seq, error=RequestCancelled(
                f"request {req.id} cancelled"))
        elif (req.eos_token_id is not None and tok == req.eos_token_id) \
                or seq.generated >= req.max_new_tokens:
            self._retire(seq)

    def _retire(self, seq: _Seq, error: Optional[BaseException] = None):
        self._pool.free(seq.blocks)
        seq.blocks = []
        if seq in self._running:
            self._running.remove(seq)
        _finish(seq.req, tokens=seq.tokens, error=error)

    # -- cancellation / teardown ---------------------------------------------
    def _cancel(self, req: _Request):
        with self._cv:
            req.cancelled = True
            self._cv.notify()

    def _drain_cancels(self):
        for seq in [s for s in self._running if s.req.cancelled]:
            self._retire(seq, error=RequestCancelled(
                f"request {seq.req.id} cancelled"))
        for seq in [s for s in self._resume if s.req.cancelled]:
            self._resume.remove(seq)
            _finish(seq.req, error=RequestCancelled(
                f"request {seq.req.id} cancelled"))
        with self._cv:
            cancelled = [r for r in self._waiting if r.cancelled]
            for req in cancelled:
                self._waiting.remove(req)
        for req in cancelled:
            _finish(req, error=RequestCancelled(f"request {req.id} cancelled"))

    def _shutdown(self):
        err = self._broken or ServeError("serving engine closed")
        with self._cv:
            waiting = list(self._waiting)
            self._waiting.clear()
        for req in waiting:
            _finish(req, error=ServeError(str(err)))
        # _admitting covers sequences a crash caught mid-prefill; _finish
        # dedupes any that already made it to _running
        for seq in self._running + self._resume + self._admitting:
            if seq.blocks:
                try:
                    self._pool.free(seq.blocks)
                except RuntimeError:  # a corrupt pool must not stop the sweep
                    pass
                seq.blocks = []
            _finish(seq.req, error=ServeError(str(err)))
        self._running, self._resume, self._admitting = [], [], []

    # -- step-function cache -------------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self._device)

    def _get_fn(self, kind: str, *bucket):
        """One built step function per (kind, bucket shape); the count of
        entries is the ``compiles`` stat (<= buckets used)."""
        key = (kind,) + bucket
        fn = self._fns.get(key)
        if fn is None:
            bs = self.config.block_size
            if kind == "prefill":
                bw, t_bucket = bucket
                fn = G.build_paged_prefill(self._arch, bw, t_bucket, bs,
                                           self._max_blocks)
            else:
                bb, mb = bucket
                build = (G.build_paged_decode_kernel
                         if flags.flag("FLAGS_serve_paged_kernel", False)
                         else G.build_paged_decode)
                fn = build(self._arch, bb, bs, mb)
            self._fns[key] = fn
            counter_inc("serve_compiles")
        return fn

    # -- debug hook ----------------------------------------------------------
    def _debug_step_logits(self, prompts):
        """Logits of ONE decode step over ``prompts``, built once with the
        serving kernels (the paged-attention read, and the int8 head when the
        engine attached one) and once with their plain versions, each on its
        own copy of the same pool state. The prompts are prefilled into
        freshly granted blocks that are freed afterwards. The engine must be
        idle; this runs on the calling thread. Returns
        ``(kernel_logits, plain_logits)`` as float32 numpy arrays."""
        bs, bw = self.config.block_size, self.config.prefill_batch
        grants = [self._pool.alloc(len(p) // bs + 1) for p in prompts]
        try:
            if any(g is None for g in grants):
                raise ServeError("_debug_step_logits: pool too small")
            B = len(prompts)
            mb = 1
            while mb < max(len(g) for g in grants):
                mb *= 2
            tables = np.full((B, mb), TRASH_BLOCK, np.int32)
            pos = np.array([len(p) for p in prompts], np.int32)
            toks = np.zeros((B,), np.int32)
            with torch.inference_mode():
                for r, (p, g) in enumerate(zip(prompts, grants)):
                    tables[r, :len(g)] = g
                    t_bucket = self._bucket_for(len(p))
                    ids = np.zeros((bw, t_bucket), np.int32)
                    ids[0, :len(p)] = p
                    lens = np.ones((bw,), np.int32)
                    lens[0] = len(p)
                    ptab = np.full((bw, self._max_blocks), TRASH_BLOCK, np.int32)
                    ptab[0, :len(g)] = g
                    fn = G.build_paged_prefill(self._arch, bw, t_bucket, bs,
                                               self._max_blocks)
                    _, _, logits = fn(self._params, self._dev(ids),
                                      self._dev(lens), self._dev(ptab),
                                      self._kpool, self._vpool)
                    toks[r] = int(logits[0].float().argmax())
                out = []
                for build, params in ((G.build_paged_decode_kernel, self._params),
                                      (G.build_paged_decode, self._plain_params)):
                    logits = build(self._arch, B, bs, mb).logits(
                        params, self._kpool.clone(), self._vpool.clone(),
                        self._dev(tables), self._dev(pos), self._dev(toks))
                    out.append(logits.float().cpu().numpy())
            return out[0], out[1]
        finally:
            self._pool.free([b for g in grants if g is not None for b in g])


def _engine_loop(wr, device):
    """Scheduler thread body. Grad mode and the current CUDA device are
    thread-local, so both are set here; the engine is held only through a
    weakref and re-dereferenced every iteration."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with torch.inference_mode():
        while True:
            eng = wr()
            if eng is None:
                return
            try:
                stopped = eng._run_once()
            except Exception as e:
                # fail loudly into every pending handle rather than leave
                # clients blocked on events that will never fire
                eng._broken = e
                counter_inc("serve_engine_errors")
                eng._shutdown()
                return
            if stopped:
                eng._shutdown()
                return
            del eng
