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
  through the int8 matmul kernel;
* ``prefix_cache=True`` keeps prompts' full KV blocks in a refcounted index
  (``_PrefixCache``): admission shares the longest cached prefix and
  prefills only the tail; ``spec_k=k`` drafts k tokens a row (the n-gram
  prompt lookup, or a small same-family ``drafter`` model over a window)
  and verifies them in one step, greedy output unchanged;
  ``prefill_chunk=n`` prefills a prompt whose uncached tail exceeds n
  tokens one n-token chunk per scheduler step, between decode steps. With
  all three off the engine takes the plain path;
* deadlines, priorities and load shedding: ``submit(deadline_s=,
  priority=)``; the scheduler sheds expired and doomed requests with
  ``DeadlineExceeded`` at every step boundary, eviction is
  priority-then-youngest, and ``max_queue`` with ``shed`` turns a full queue
  into a fast ``Overloaded`` with a ``retry_after_s`` hint. Unconfigured,
  each costs a flag probe;
* liveness and drain: the scheduler thread heartbeats every iteration
  (``health()``/``ready()`` read it, a ``ServingSupervisor`` watches it),
  and ``close(drain=True)`` stops admission and completes the queued and
  running work first;
* device-memory pressure (``fault/memory.py``): an out-of-memory error
  inside a step parks free KV blocks (``PagePool.park``, admission headroom
  shrinks) and the next iteration retries; a streak that parking cannot
  break falls through to the crash path. ``request_pool_shrink`` asks for
  the same from any thread;
* durability: ``snapshot()`` captures the whole serving state at a step
  boundary (pool bookkeeping, the KV pools, block tables, the prefix chain,
  per-block checksums), ``adopt()`` installs it in a fresh engine (the
  sequences resume mid-decode with no token re-prefilled; a capture that
  fails validation falls back whole to re-prefill), and ``handoff()``
  quiesces the engine and exports the snapshot with the queue and the
  in-flight handles;
* observability (``serving/observe.py``): ``trace=True`` (or
  ``FLAGS_serve_trace``) gives each request a trace id and a timeline (queue
  wait, prefills, decode steps, evictions, copy-on-write copies) and feeds
  the TTFT, inter-token, end-to-end and queue-wait histograms;
  ``metrics_port`` (or ``FLAGS_serve_metrics_port``) serves ``/metrics``,
  ``/healthz``, ``/readyz`` and ``/debug/requests``. Unarmed, each hook site
  is one ``is not None`` probe. Every engine registers a flight-recorder
  context provider (its in-flight table rides every post-mortem), and the
  scheduler's crash path writes a ``serving_loop_error`` dump.

Chaos points ``serve.crash``/``serve.wedge``/``serve.slow_step``/
``serve.pool_corrupt``/``hbm.oom``/``hbm.pressure`` (``fault/inject.py``)
fire at the scheduler step boundary while armed; ``serve.snapshot_corrupt``
tears a capture inside ``snapshot``.

The engine runs on ``cuda`` unless ``device="cpu"`` is passed; without CUDA
and without that request it raises. The scheduler thread enters
``torch.inference_mode()`` and sets the CUDA device itself (both are
thread-local in PyTorch).
"""
from __future__ import annotations

import collections
import contextlib
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
from ..fault import inject as _inject
from ..fault import memory as _fmem
from ..framework import flags
from ..models import generation as G
from ..profiler import counter_inc, flight, span
from ..profiler.spans import update_attrs
from .int8 import attach_int8_head, dequantize_tree, quantize_params
from .pool import TRASH_BLOCK, PagePool, SnapshotError

__all__ = ["Engine", "EngineConfig", "RequestHandle", "Readiness",
           "ServeError", "RequestCancelled", "DeadlineExceeded",
           "Overloaded", "SnapshotError"]

SNAPSHOT_VERSION = 1  # engine-level snapshot format (the pool has its own)

_engine_ids = itertools.count(1)


class ServeError(RuntimeError):
    pass


class RequestCancelled(ServeError):
    pass


class DeadlineExceeded(ServeError):
    """The request's ``deadline_s`` passed (or provably cannot be met) before
    completion: shed by the scheduler at admission or a step boundary."""

    def __init__(self, msg: str, request_id: Optional[int] = None):
        super().__init__(msg)
        self.request_id = request_id


class Overloaded(ServeError):
    """Fast-fail load shed: the queue reached ``max_queue`` with ``shed``
    on. ``retry_after_s`` is the backoff hint (the estimated time for one
    queue slot to drain)."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class Readiness(dict):
    """``ready()``'s answer: a JSON-able dict whose truth value is the ready
    bit, so ``if eng.ready():`` keeps its boolean meaning."""

    def __bool__(self) -> bool:
        return bool(self.get("ready"))


class EngineConfig:
    """Serving knobs. ``None`` fields resolve from the ``FLAGS_serve_*``
    registry at engine construction; ``device`` None means ``cuda``."""

    def __init__(self, block_size=None, num_blocks=None, max_batch=None,
                 max_seq_len=None, prefill_batch=None, int8=None,
                 decode_buckets=None, seed=0, device=None, prefix_cache=None,
                 spec_k=None, drafter=None, draft_window=None,
                 prefill_chunk=None, max_queue=None, shed=None, trace=None,
                 metrics_port=None, tp=None, tp_int8=None):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.prefill_batch = prefill_batch
        self.int8 = int8
        self.decode_buckets = decode_buckets
        self.seed = seed
        self.device = device
        # prefix-cache KV sharing and speculative decoding: ``drafter`` is
        # "ngram" or a small same-family model (the target's vocabulary)
        self.prefix_cache = prefix_cache
        self.spec_k = spec_k
        self.drafter = drafter
        self.draft_window = draft_window
        # chunked prefill grain in tokens (0 = monolithic prefill)
        self.prefill_chunk = prefill_chunk
        # the queue depth at which a submit is shed (0 = unbounded), enforced
        # only with ``shed``
        self.max_queue = max_queue
        self.shed = shed
        # request tracing + SLO histograms, and the telemetry endpoint's
        # port (0 = no endpoint thread)
        self.trace = trace
        self.metrics_port = metrics_port
        # the tensor-parallel degree (0 and 1: one device), and the int8
        # wire of its gathers; ``device`` may then be a sequence of tp
        # devices, one a shard
        self.tp = tp
        self.tp_int8 = tp_int8

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
        # 0 is the meaningful default (unbounded), so only None falls back
        self.max_queue = pick(self.max_queue, "FLAGS_serve_max_queue")
        if self.shed is None:
            self.shed = bool(flags.flag("FLAGS_serve_shed", False))
        if self.prefix_cache is None:
            self.prefix_cache = bool(flags.flag("FLAGS_serve_prefix_cache",
                                                False))
        self.spec_k = pick(self.spec_k, "FLAGS_serve_spec_k")
        if self.drafter is None:
            self.drafter = flags.flag("FLAGS_serve_drafter", "ngram")
        self.draft_window = pick(self.draft_window, "FLAGS_serve_draft_window")
        self.prefill_chunk = pick(self.prefill_chunk,
                                  "FLAGS_serve_prefill_chunk")
        self.tp = pick(self.tp, "FLAGS_serve_tp")
        if self.tp_int8 is None:
            self.tp_int8 = bool(flags.flag("FLAGS_serve_tp_int8", False))
        if self.tp < 0:
            raise ValueError("serving: tp must be >= 0 (0/1 = one device)")
        if self.tp >= 2 and self.spec_k > 0:
            raise ValueError(
                "serving: speculative decoding is not supported under "
                "tensor-parallel serving (set spec_k=0 or tp<=1)")
        if self.prefill_chunk < 0:
            raise ValueError("serving: prefill_chunk must be >= 0 "
                             "(0 = monolithic prefill)")
        if self.prefill_chunk and self.block_size \
                and self.prefill_chunk % self.block_size:
            raise ValueError(
                "serving: prefill_chunk must be a multiple of block_size "
                "(chunk boundaries write K/V through the paged scatter)")
        if self.spec_k < 0:
            raise ValueError("serving: spec_k must be >= 0")
        if self.spec_k and self.draft_window < 2:
            raise ValueError("serving: draft_window must be >= 2")
        if self.block_size < 1 or self.num_blocks < 2 or self.max_batch < 1 \
                or self.prefill_batch < 1 or self.max_seq_len < 1:
            raise ValueError(
                "serving: block_size/max_batch/prefill_batch/max_seq_len "
                ">= 1 and num_blocks >= 2 required")
        if self.max_queue < 0:
            raise ValueError("serving: max_queue must be >= 0 (0 = unbounded)")
        if self.trace is None:
            self.trace = bool(flags.flag("FLAGS_serve_trace", False))
        self.metrics_port = pick(self.metrics_port, "FLAGS_serve_metrics_port")
        if self.metrics_port < 0:
            raise ValueError("serving: metrics_port must be >= 0 (0 = off)")
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
                 "cancelled", "t_submit", "t_done", "priority", "deadline",
                 # observability: the trace id rides the request object, so
                 # it survives snapshot, harvest and handoff unchanged
                 "trace", "t_submit_ns", "t_first_tok", "t_last_tok")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id, temperature,
                 stream, priority=0, deadline=None):
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
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None
        self.priority = int(priority)  # higher = more important
        self.deadline = deadline  # absolute monotonic time, or None
        self.trace: Optional[str] = None  # set by observe.on_submit
        self.t_submit_ns = 0  # span-clock submit stamp
        self.t_first_tok = 0.0  # first-token time (TTFT)
        self.t_last_tok = 0.0  # last-token time (gaps)


def _finish(req: _Request, tokens=None, error=None, count=True) -> bool:
    """Terminal state for a request (first writer wins: crash sweeps,
    supervisor relays and the scheduler may race). The supervisor finishes
    orphaned requests with it too; ``count=False`` skips the lifecycle
    counters when a relay completes the original of a requeued request
    whose continuation the new engine already counted."""
    if req.done.is_set():
        return False
    req.tokens = list(tokens) if tokens is not None else None
    req.error = error
    req.t_done = time.monotonic()
    if count:
        counter_inc("serve_cancelled" if isinstance(error, RequestCancelled)
                    else "serve_failed" if error is not None
                    else "serve_retired")
    if req.stream_q is not None:
        req.stream_q.put(None)
    req.done.set()
    return True


def _ngram_propose(tokens, k: int, max_n: int = 3) -> List[int]:
    """Prompt-lookup drafting (the drafter that needs no model): find the
    most recent EARLIER occurrence of the longest suffix n-gram
    (n = max_n..1) and propose the up-to-k tokens that followed it; [] when
    nothing recurs (the verify step then emits one token for the row)."""
    L = len(tokens)
    for n in range(min(max_n, L - 1), 0, -1):
        pat = tokens[L - n:]
        for i in range(L - n - 1, -1, -1):
            if tokens[i:i + n] == pat:
                fol = tokens[i + n:i + n + k]
                if fol:
                    return fol
    return []


class _PrefixCache:
    """Index of shared prompt-prefix KV blocks (scheduler thread only, like
    the pool it feeds). Chained block-granularity keys: block j's key is
    ``(parent block id, tuple of chunk-j tokens)``, so the parent link pins
    everything before the chunk and two prefixes can never alias (dict
    hashing is the fast path, equality is exact). The index holds its OWN
    reference on every cached block (``PagePool.share``), so the KV outlives
    the sequence that wrote it; :meth:`evict` drops LRU LEAF entries whose
    block nobody else maps (refcount 1), never a block a table still
    holds."""

    __slots__ = ("_pool", "_bs", "_entries", "_by_bid", "_tick")

    def __init__(self, pool: PagePool, block_size: int):
        self._pool = pool
        self._bs = block_size
        # key -> [block id, last-use tick, cached-child count]
        self._entries: Dict[tuple, list] = {}
        self._by_bid: Dict[int, tuple] = {}  # block id -> its key
        self._tick = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def blocks(self) -> int:
        """Pool blocks the index holds."""
        return len(self._entries)

    def match(self, tokens, limit: int) -> List[int]:
        """Block ids of the longest cached chain over the full block-size
        chunks of ``tokens``, at most ``limit``; refcounts are NOT bumped
        (the caller shares them once admission is sure)."""
        self._tick += 1
        bids: List[int] = []
        parent = -1
        for j in range(limit):
            ent = self._entries.get(
                (parent, tuple(tokens[j * self._bs:(j + 1) * self._bs])))
            if ent is None:
                break
            ent[1] = self._tick
            bids.append(ent[0])
            parent = ent[0]
        return bids

    def insert(self, tokens, blocks, start: int, full: int) -> int:
        """Index ``blocks[start:full]`` of a freshly prefilled sequence
        (chunk j's parent is ``blocks[j-1]``, cached or fresh). Stops at the
        first key already present: that content is cached under ANOTHER
        block id, and chaining ours beside it would orphan its children.
        Takes one index reference per inserted block."""
        inserted = 0
        for j in range(start, full):
            parent = -1 if j == 0 else blocks[j - 1]
            key = (parent, tuple(tokens[j * self._bs:(j + 1) * self._bs]))
            if key in self._entries:
                break
            self._pool.share([blocks[j]])
            self._tick += 1
            self._entries[key] = [blocks[j], self._tick, 0]
            self._by_bid[blocks[j]] = key
            pk = self._by_bid.get(parent)
            if pk is not None:
                self._entries[pk][2] += 1
            inserted += 1
        return inserted

    def evict(self, need: int) -> int:
        """Free up to ``need`` blocks by dropping LRU leaves only the index
        maps; dropping a leaf may expose its parent next. Returns the blocks
        returned to the free list (0 when everything left is pinned)."""
        freed = 0
        while freed < need:
            leaves = [(ent[1], key) for key, ent in self._entries.items()
                      if ent[2] == 0 and self._pool.refcount(ent[0]) == 1]
            if not leaves:
                break
            freed += self._drop(min(leaves)[1])
        if freed:
            counter_inc("serve_prefix_evicted", freed)
        return freed

    def _drop(self, key) -> int:
        bid = self._entries.pop(key)[0]
        del self._by_bid[bid]
        pk = self._by_bid.get(key[0])
        if pk is not None:
            self._entries[pk][2] -= 1
        self._pool.free([bid])
        return 1

    def release_all(self) -> None:
        """Drop every index reference (engine shutdown)."""
        bids = [ent[0] for ent in self._entries.values()]
        self._entries.clear()
        self._by_bid.clear()
        if bids:
            self._pool.free(bids)


class _Seq:
    """Scheduler-side state of one admitted sequence. ``tokens`` holds
    prompt + generated ids; the newest id's KV is NOT yet in cache — its
    write position is ``pos = len(tokens) - 1``. ``cached_blocks`` counts
    the leading blocks admission matched in the prefix cache (shared and
    filled: prefill runs only the tail); ``chunk_pos`` is the chunked
    prefill's cursor (tokens below it have K/V in cache; 0 off that
    path)."""

    __slots__ = ("req", "tokens", "blocks", "prompt_len", "cached_blocks",
                 "chunk_pos")

    def __init__(self, req: _Request, tokens: List[int]):
        self.req = req
        self.tokens = tokens
        self.blocks: List[int] = []
        self.prompt_len = len(req.prompt)
        self.cached_blocks = 0
        self.chunk_pos = 0

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

    @property
    def latency_s(self) -> Optional[float]:
        t = self._req.t_done
        return None if t is None else t - self._req.t_submit

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
        # tensor-parallel serving: tp >= 2 shards heads, FFN columns, the LM
        # head and the KV pool over tp devices; 0 and 1 leave every code
        # path below as the one-device engine's
        tp = int(cfg.tp if cfg.tp is not None
                 else flags.flag("FLAGS_serve_tp", 0))
        self._tp = tp if tp >= 2 else 0
        if self._tp:
            self._tp_devices = _tp_placement(cfg.device, self._tp)
            device = self._tp_devices[0]
        else:
            device = resolve_device(cfg.device)
        arch_key, arch, params, max_pos = decode_state(model, device)
        self.config = cfg.resolve(max_pos)
        self._device = device
        self._arch = arch
        self._arch_key = arch_key
        self._dtype = params["wte"].dtype
        if self._tp:
            # one packed copy: the replicated leaves are the model's own,
            # each shard's column slices a contiguous tree on its device;
            # an int8 tree is sliced on its int8 bytes and each shard
            # dequantizes its own leaves (FLAGS_serve_int8_kernel, a
            # one-device head fusion, is not used under tp, as in the
            # reference)
            src = quantize_params(params) if cfg.int8 else params
            self._params, self._tp_vocab = G.tp_pack_params(
                arch_key, src, self._tp, self._tp_devices)
            self._plain_params = None
        elif cfg.int8:
            tagged = quantize_params(params)
            self._plain_params = dequantize_tree(tagged, self._dtype)
            self._params = (attach_int8_head(self._plain_params, tagged)
                            if flags.flag("FLAGS_serve_int8_kernel", False)
                            else self._plain_params)
        else:
            self._params = self._plain_params = params
        self._n_layers = len(params["layers"])
        self._spec_k = cfg.spec_k
        # the speculative verify writes reach pos + spec_k: widen the block
        # tables so a real write never lands past them
        self._max_blocks = -(-(cfg.max_seq_len + self._spec_k)
                             // cfg.block_size)
        # zeros, never empty: padding rows read trash block 0 under a -inf
        # mask on the plain path, and 0 * NaN would poison it
        shape = (self._n_layers, cfg.num_blocks, cfg.block_size,
                 arch["kv_heads"], arch["head_dim"])
        if self._tp:
            # one contiguous pool a shard, its KV heads of EVERY block: the
            # replicated block tables index every shard alike
            shape = shape[:3] + (shape[3] // self._tp,) + shape[4:]
            self._kpool = [torch.zeros(shape, dtype=self._dtype, device=d)
                           for d in self._tp_devices]
            self._vpool = [torch.zeros(shape, dtype=self._dtype, device=d)
                           for d in self._tp_devices]
        else:
            self._kpool = torch.zeros(shape, dtype=self._dtype,
                                      device=self._device)
            self._vpool = torch.zeros(shape, dtype=self._dtype,
                                      device=self._device)
        self._pool = PagePool(cfg.num_blocks)
        self._prefill_buckets = self._make_prefill_buckets()
        self._prefix = (_PrefixCache(self._pool, cfg.block_size)
                        if cfg.prefix_cache else None)
        # None when spec is off, True for the n-gram proposer, or (arch,
        # params, window) of a small model drafter on the engine's device
        self._drafter = None
        if self._spec_k:
            self._drafter = self._make_drafter(cfg.drafter)
        # 0 = monolithic prefill; else the chunk grain, and the sequences
        # whose prompt is being prefilled one chunk per scheduler step
        self._chunk = cfg.prefill_chunk
        self._prefilling: List[_Seq] = []

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
        # the shed ETA's per-step floor while the decode EMA is cold: the
        # cost model's time of a step's tensor-parallel gathers at the
        # widest batch (0 on one device)
        self._step_floor_s = 0.0
        if self._tp:
            from ..cost_model import CostModel

            fp32_b, int8_b = G.tp_collective_bytes(
                arch_key, src, cfg.max_batch, self._tp)
            wire = int8_b if cfg.tp_int8 else fp32_b
            self._step_floor_s = CostModel(self._device.type).kernel_estimate(
                "tp_collective", (int(wire), self._tp), {}) / 1e3
        del params
        # resilience gauges (scheduler-thread writes, racy reads by design):
        # the warm decode-step time EMA (deadline feasibility), the finished
        # request latency EMA (Retry-After hints), and the heartbeat that
        # health() and the supervisor read
        self._ema_step_s = 0.0
        self._ema_req_s = 0.0
        self._beat = time.monotonic()
        # True while a step function's first call runs (it may build a
        # kernel): the supervisor's staleness limit widens 10x meanwhile
        self._compiling = False
        # memory pressure: the cross-thread shrink request applied at the
        # next step boundary (-1 = a quarter of the free list), the streak
        # of out-of-memory steps, and the clean-step countdown before parked
        # blocks start coming back
        self._shrink_req = 0  # guarded_by: _cv
        self._oom_streak = 0
        self._unpark_countdown = 0
        self._t_start = time.monotonic()
        # observability: when armed, `_obs` is the serving.observe module and
        # the scheduler tags spans, feeds the histograms and scores the step
        # estimate; unarmed, the module is never imported and every hook site
        # is one `is not None` probe
        self._obs = None
        self._endpoint = None
        if cfg.trace:
            from . import observe as _observe

            _observe.trace_book()  # create it and register the span observer
            self._obs = _observe

        # cross-thread state
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._waiting: "collections.deque[_Request]" = collections.deque()  # guarded_by: _cv
        self._stop = False  # guarded_by: _cv
        self._draining = False  # guarded_by: _cv
        # handoff() sets the request and the scheduler quiesces at its next
        # step boundary: it exits WITHOUT failing handles (the exported
        # snapshot owns them). _last_recovery is the latest adopt() outcome
        # for health().
        self._handoff_req = False  # guarded_by: _cv
        self._quiesced = threading.Event()
        self._last_recovery: Optional[dict] = None
        self._broken: Optional[BaseException] = None
        self._ids = itertools.count(1)
        # once-true latches (set under _cv, read lock-free by the scheduler):
        # the deadline sweep and the priority order run only once a request
        # with a deadline or a priority was submitted
        self._deadline_seen = False
        self._has_prio = False
        # set by ServingSupervisor: a supervised crash leaves the scheduler
        # state for the supervisor to harvest instead of failing every handle
        self._supervised = False
        # the distributed watchdog module when a ServingSupervisor runs this
        # engine: its scheduler publishes serve.step unit records
        self._watchdog = None
        self._failed = threading.Event()
        self._provider = f"paddle_tpu_torch_serving_{next(_engine_ids)}"
        # the flight registry holds the engine only through a weakref: an
        # abandoned engine stays collectable, and the provider then reports
        # itself gone
        wr = weakref.ref(self)
        flight.add_context_provider(
            self._provider,
            lambda _wr=wr: (e._flight_context() if (e := _wr()) is not None
                            else {"closed": True}))
        # the pressure-relief rung of fault/memory.free_pressure, weakly
        # bound (a collected engine drops out of the registry by itself)
        _fmem.register_pressure_handler(
            self._provider, lambda eng: eng.request_pool_shrink(), owner=self)
        # the thread holds the engine only through a weakref, so an
        # abandoned engine stays collectable (__del__ closes it)
        self._thread = threading.Thread(
            target=_engine_loop, args=(wr, self._device),
            daemon=True, name=self._provider)
        self._thread.start()
        # the endpoint last: its handlers probe health() on a whole engine;
        # it holds the engine through a weakref, and a failed bind is a
        # counter, never a serving failure
        if cfg.metrics_port:
            from . import observe as _observe

            self._endpoint = _observe.start_endpoint(self, cfg.metrics_port)

    # ------------------------------------------------------------------ API
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, temperature: float = 0.0,
               stream: bool = False, deadline_s: Optional[float] = None,
               priority: int = 0, _shed_exempt: bool = False,
               _trace: Optional[str] = None) -> RequestHandle:
        """Enqueue one request (any thread). ``temperature == 0`` is greedy.
        ``stream=True`` additionally feeds the handle's iterator per token.
        ``deadline_s`` (seconds from now) attaches a completion deadline: the
        scheduler fails the request with :class:`DeadlineExceeded` once it
        expires or provably cannot finish in time. ``priority`` (higher =
        more important, default 0) orders admission and inverts eviction.
        With ``max_queue`` and ``shed``, a full queue fails this call with
        :class:`Overloaded` instead of queueing, except for ``_shed_exempt``
        submissions (the supervisor's requeue of work already accepted),
        which also carry the original's trace id in ``_trace``."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("serving: empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("serving: max_new_tokens must be >= 1")
        if deadline_s is not None and float(deadline_s) <= 0.0:
            raise ValueError("serving: deadline_s must be positive")
        total = len(prompt) + int(max_new_tokens)
        if total > self.config.max_seq_len:
            raise ValueError(
                f"serving: prompt + max_new_tokens = {total} exceeds "
                f"max_seq_len {self.config.max_seq_len}")
        # the speculative verify maps up to spec_k slots past the last token
        if -(-(total + self._spec_k) // self.config.block_size) \
                > self._pool.num_blocks - 1:
            raise ValueError(
                "serving: request needs more KV blocks than the whole pool; "
                "raise FLAGS_serve_num_blocks")
        cfg = self.config
        with self._cv:
            if self._stop or self._broken is not None:
                raise ServeError("serving engine is closed") from self._broken
            if self._draining:
                raise ServeError("serving engine is draining "
                                 "(close(drain=True)); submit to its "
                                 "replacement")
            if cfg.shed and not _shed_exempt and cfg.max_queue > 0 \
                    and len(self._waiting) >= cfg.max_queue:
                counter_inc("serve_shed")
                hint = round(max(0.05, len(self._waiting)
                                 * (self._ema_req_s or 0.1) / cfg.max_batch),
                             3)
                raise Overloaded(
                    f"serving queue full ({len(self._waiting)} >= "
                    f"max_queue={cfg.max_queue}); retry after ~{hint}s",
                    retry_after_s=hint)
            req = _Request(next(self._ids), prompt, max_new_tokens,
                           eos_token_id, temperature, stream,
                           priority=priority,
                           deadline=(time.monotonic() + float(deadline_s))
                           if deadline_s is not None else None)
            if req.deadline is not None:
                self._deadline_seen = True
            if req.priority != 0:
                self._has_prio = True
            if self._obs is not None:
                # the timeline exists before the scheduler can see the
                # request; a requeue re-attaches the original's trace id
                self._obs.on_submit(req, trace=_trace)
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
            "pages_parked": self._pool.parked_blocks,
            "pages_cached": (self._prefix.blocks
                             if self._prefix is not None else 0),
            "compiles": len(self._fns),
            "decode_steps": steps,
            "decode_step_ms_mean": (1e3 * self._decode_s / steps
                                    if steps else 0.0),
        }

    def debug_requests(self) -> List[dict]:
        """The in-flight request table (``/debug/requests``): phase, age,
        priority, prompt length, tokens generated, blocks held and trace id
        (any thread; a racy snapshot, as :meth:`stats`)."""
        now = time.monotonic()
        with self._lock:
            waiting = list(self._waiting)
        rows = [{"id": req.id, "phase": "queued",
                 "age_s": round(now - req.t_submit, 3),
                 "priority": req.priority, "prompt_len": len(req.prompt),
                 "generated": 0, "blocks": 0, "trace": req.trace}
                for req in waiting]
        for phase, seqs in (("prefilling", self._admitting),
                            ("chunk_prefill", self._prefilling),
                            ("running", self._running),
                            ("preempted", self._resume)):
            for s in list(seqs):
                rows.append({"id": s.req.id, "phase": phase,
                             "age_s": round(now - s.req.t_submit, 3),
                             "priority": s.req.priority,
                             "prompt_len": s.prompt_len,
                             "generated": s.generated,
                             "blocks": len(s.blocks),
                             "trace": s.req.trace})
        return rows

    def health(self) -> dict:
        """Liveness probe (any thread): the scheduler thread's aliveness,
        heartbeat age and failure state; ``ok`` is the one bit to alarm on.
        A heartbeat older than ``FLAGS_serve_watchdog_s`` (10x while a step
        function's first call runs) clears ``ok``."""
        alive = self._thread.is_alive()
        with self._lock:
            depth = len(self._waiting)
            draining = self._draining
            stopped = self._stop
        beat_age = time.monotonic() - self._beat
        thr = max(1.0, float(flags.flag("FLAGS_serve_watchdog_s", 10.0)
                             or 10.0))
        stale = beat_age > thr * (10.0 if self._compiling else 1.0)
        # the latest adopt() outcome, its monotonic stamp turned into an age
        lr = (dict(self._last_recovery) if self._last_recovery
              else {"mode": "none"})
        t_rec = lr.pop("t", None)
        if t_rec is not None:
            lr["age_s"] = round(time.monotonic() - t_rec, 3)
        return {
            "ok": alive and self._broken is None and not stopped
            and not stale,
            "thread_alive": alive,
            "beat_age_s": round(beat_age, 3),
            "stale": stale,
            "broken": repr(self._broken) if self._broken is not None
            else None,
            "draining": draining,
            "queue_depth": depth,
            "running": len(self._running),
            "pages_free": self._pool.free_blocks,
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "last_recovery": lr,
        }

    def ready(self) -> Readiness:
        """Readiness probe: accepting submissions now (healthy, not
        draining, and under the shed policy the queue below its cap). A
        rolling restart moves traffic away when this goes False, then calls
        ``close(drain=True)``."""
        h = self.health()
        ready, reason = True, None
        if not h["ok"]:
            ready, reason = False, "unhealthy"
        elif h["draining"]:
            ready, reason = False, "draining"
        else:
            cfg = self.config
            if cfg.shed and cfg.max_queue > 0 \
                    and h["queue_depth"] >= cfg.max_queue:
                ready, reason = False, "queue_full"
        return Readiness(ready=ready, reason=reason,
                         queue_depth=h["queue_depth"],
                         uptime_s=h["uptime_s"],
                         last_recovery=h["last_recovery"])

    def close(self, timeout: float = 30.0, drain: bool = False) -> None:
        """Stop the scheduler thread. Plain ``close()`` fails outstanding
        requests with ``ServeError``; ``close(drain=True)`` first stops
        admission (``submit`` raises, ``ready()`` goes False) and lets the
        queued and running work complete within ``timeout``. A join that
        times out (a wedged scheduler thread) marks the engine broken and
        fails every outstanding handle. Idempotent."""
        deadline = time.monotonic() + max(0.0, float(timeout))
        on_sched_thread = threading.current_thread() is self._thread
        if drain:
            with self._cv:
                self._draining = True
                self._cv.notify()
            if not on_sched_thread:
                self._thread.join(max(0.0, deadline - time.monotonic()))
        with self._cv:
            self._stop = True
            self._cv.notify()
        # before the join: close() can run ON the scheduler thread (__del__)
        flight.remove_context_provider(self._provider)
        if self._endpoint is not None:
            self._endpoint.close()
            self._endpoint = None
        _fmem.unregister_pressure_handler(self._provider)
        if self._watchdog is not None:
            try:  # a stale unit record must not outlive its engine
                self._watchdog.remove_unit(self._provider)
            except Exception:
                pass
        if not on_sched_thread:
            # a drain may have used the whole budget on real work: the
            # post-stop join gets a floor (a healthy thread exits within a
            # step of _stop), so a slow drain is not taken for a wedge
            self._thread.join(max(2.0 if drain else 0.1,
                                  deadline - time.monotonic()))
            if self._thread.is_alive():
                counter_inc("serve_wedged_close")
                self._broken = self._broken or ServeError(
                    f"serving engine scheduler thread wedged: close() join "
                    f"timed out after {timeout}s")
        # a wedged join, a supervised crash nobody harvested, or __del__ on
        # the scheduler thread leave handles pending: fail them (handle
        # state only, the pool untouched); a no-op after a clean shutdown
        self._fail_outstanding(self._broken
                               or ServeError("serving engine closed"))

    def _fail_outstanding(self, err: BaseException) -> None:
        """Fail every pending handle without touching the page pool (any
        thread; idempotent per request through ``_finish``)."""
        with self._cv:
            waiting = list(self._waiting)
            self._waiting.clear()
        seqs = list(self._running) + list(self._resume) \
            + list(self._admitting) + list(self._prefilling)
        for req in waiting + [s.req for s in seqs]:
            self._finish_request(req, error=ServeError(str(err)))

    # -- durability: snapshot / adopt / handoff -------------------------------
    def _device_scope(self):
        """Grad mode and the current CUDA device are thread-local: work on
        the pools from a caller's thread runs under inference mode on the
        engine's device."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._device.type == "cuda":
            stack.enter_context(torch.cuda.device(self._device))
        return stack

    def _compat_key(self) -> tuple:
        """The geometry an adopted snapshot must match exactly: the KV pools
        and block tables mean something only against the same paged-cache
        shape, and the same KV layout: the tensor-parallel degree and
        ``"kv-shard/tp"`` (each shard's pool holds KV/tp heads of every
        block), or 0 and ``"replicated"`` on one device. A snapshot taken
        at another degree is refused, never re-sharded."""
        cfg = self.config
        return (self._n_layers, int(cfg.num_blocks), int(cfg.block_size),
                int(self._arch["kv_heads"]), int(self._arch["head_dim"]),
                str(self._dtype), int(self._tp),
                "kv-shard/tp" if self._tp else "replicated")

    def _pool_shards(self, pool) -> list:
        """A KV pool as its list of shards: the tp shards, or the one
        pool."""
        return list(pool) if self._tp else [pool]

    def snapshot(self) -> dict:
        """O(blocks) capture of the live serving state: the pool bookkeeping
        (with its CRC), the KV pools, every in-flight sequence's tokens and
        block table, the prefix-cache chain, and per-block checksums of the
        owned blocks' KV.

        The scheduler must be quiesced (``handoff``) or dead (a supervised
        crash): a live one would tear the capture, so this refuses it. The
        capture SHARES the engine's pool tensors, which the engine writes in
        place: it is a true capture only while this engine never steps
        again, which holds after a handoff (stopped) and after a crash (the
        thread is dead). Copying them instead would cost 6.4 GB at GPT-3
        1.3B and 17.2 GB at Llama-7B. The device is synchronized before the
        checksums, so launches still queued are in them."""
        if self._thread.is_alive() and not self._quiesced.is_set() \
                and not self._failed.is_set():
            raise ServeError(
                "snapshot requires a quiesced or dead scheduler thread "
                "(use handoff(), or capture after a supervised crash)")
        with span("serve_snapshot", step=self._step_i,
                  running=len(self._running)) as sp:
            pool_snap = self._pool.snapshot()
            seqs, seen = [], set()
            for phase, group in (("running", self._running),
                                 ("resume", self._resume),
                                 ("admitting", self._admitting),
                                 ("prefilling", self._prefilling)):
                for s in group:
                    if s.req.id in seen:
                        continue  # landed mid-prefill: _running's view wins
                    seen.add(s.req.id)
                    seqs.append({"phase": phase, "req": s.req,
                                 "tokens": list(s.tokens),
                                 "blocks": list(s.blocks),
                                 "prompt_len": s.prompt_len,
                                 "cached_blocks": s.cached_blocks})
            prefix = None
            if self._prefix is not None:
                prefix = {"entries": {k: list(v) for k, v
                                      in self._prefix._entries.items()},
                          "tick": self._prefix._tick}
            owned = sorted(self._pool._ref)
            with self._device_scope():
                for dev in {p.device for p in self._pool_shards(self._kpool)}:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                sums = G.kv_block_checksums(self._kpool, self._vpool, owned)
            snap = {"version": SNAPSHOT_VERSION, "compat": self._compat_key(),
                    "pool": pool_snap, "kpool": self._kpool,
                    "vpool": self._vpool, "seqs": seqs, "prefix": prefix,
                    "step_i": self._step_i,
                    "fingerprint": {"bids": owned, "sums": sums}}
            if _inject.should_fire("serve.snapshot_corrupt"):
                # chaos: tear the pool capture mid-write; the CRC no longer
                # matches and adopt()'s validation must reject it whole
                if pool_snap["free"]:
                    pool_snap["free"].pop()
                else:
                    pool_snap["ref"] = dict(pool_snap["ref"],
                                            **{TRASH_BLOCK: 1})
            sp.set(seqs=len(seqs), owned_blocks=len(owned))
            counter_inc("serve_snapshots")
            return snap

    def adopt(self, snap: dict, only=None, fallback: str = "reprefill"):
        """Adopt a :meth:`snapshot` into THIS fresh, traffic-free engine.

        Validation first, mutation after: the geometry key, the pool restore
        (conservation and CRC), every sequence's block-table coverage, the
        prefix chain, the exact refcount-to-mapping agreement and the KV
        checksums must all hold before anything is installed. Then the
        snapshot's pool tensors replace this engine's own (which are freed)
        and the survivors' ORIGINAL requests go straight into the running
        set: they resume mid-decode with no token re-prefilled, and their
        handles and streams keep working. A capture that fails validation
        raises :class:`SnapshotError` with ``fallback="raise"``; with the
        default ``"reprefill"`` every in-flight record is re-admitted whole
        through the preemption path instead (re-prefilled from its tokens).

        ``only`` (a set of request ids, or None for all) filters the records
        adopted. Returns an info dict: ``mode`` (reattach|reprefill),
        ``installed`` (the request ids now owned here), block and token
        counts, and ``duration_s``."""
        t0 = time.monotonic()
        with span("serve_adopt", seqs=len(snap.get("seqs", ()))) as sp:
            try:
                pool = self._validate_snapshot(snap)
                info = self._attach(snap, pool, only)
            except SnapshotError as e:
                counter_inc("serve_snapshot_rejected")
                if fallback != "reprefill":
                    raise
                info = self._adopt_reprefill(snap, only)
                info["reject_reason"] = str(e)
            info["duration_s"] = round(time.monotonic() - t0, 6)
            sp.set(mode=info["mode"])
        # a stamped copy: health() turns "t" into an age
        self._last_recovery = dict(info, t=time.monotonic())
        counter_inc("serve_adoptions")
        return info

    def _validate_snapshot(self, snap: dict) -> PagePool:
        """Everything that must hold before adoption; raises SnapshotError
        and changes no engine state."""
        try:
            version = snap.get("version")
            compat = tuple(snap.get("compat", ()))
            seqs = snap["seqs"]
            prefix = snap.get("prefix")
            kpool, vpool = snap["kpool"], snap["vpool"]
            fp = snap["fingerprint"]
        except Exception as e:
            raise SnapshotError(f"malformed engine snapshot: {e!r}") from e
        if version != SNAPSHOT_VERSION:
            raise SnapshotError(
                f"engine snapshot version {version!r} != {SNAPSHOT_VERSION}")
        if compat != self._compat_key():
            raise SnapshotError(
                f"snapshot geometry {compat} does not match this engine's "
                f"{self._compat_key()} — cross-config adoption refused")

        def layout(pool):  # a tensor, or the tp shards' list
            shards = pool if isinstance(pool, (list, tuple)) else [pool]
            return [(p.shape, p.dtype, p.device) for p in shards]

        if any(layout(p) != layout(self._kpool) for p in (kpool, vpool)):
            raise SnapshotError("KV pool shape/dtype/device mismatch")
        pool = PagePool.restore(snap["pool"])
        bs = self.config.block_size
        refs: Dict[int, int] = {}
        for rec in seqs:
            blocks, tokens = rec["blocks"], rec["tokens"]
            rid = rec["req"].id
            if not tokens or len(tokens) < rec["prompt_len"]:
                raise SnapshotError(f"seq {rid}: empty/short token record")
            for b in blocks:
                if b == TRASH_BLOCK or pool.refcount(b) < 1:
                    raise SnapshotError(f"seq {rid} maps unowned block {b}")
                refs[b] = refs.get(b, 0) + 1
            if rec["phase"] == "running":
                # written KV covers positions [0, pos): so must the table
                if len(blocks) * bs < len(tokens) - 1:
                    raise SnapshotError(
                        f"seq {rid}: block table covers {len(blocks) * bs} "
                        f"positions < written {len(tokens) - 1}")
                if len(blocks) > self._max_blocks:
                    raise SnapshotError(f"seq {rid}: table too wide")
        if prefix is not None:
            by_bid: Dict[int, tuple] = {}
            kids: Dict[int, int] = {}
            for key, ent in prefix["entries"].items():
                bid = ent[0]
                if bid in by_bid:
                    raise SnapshotError(f"prefix index maps block {bid} twice")
                if pool.refcount(bid) < 1:
                    raise SnapshotError(
                        f"prefix index holds unowned block {bid}")
                by_bid[bid] = key
                refs[bid] = refs.get(bid, 0) + 1
            for key, ent in prefix["entries"].items():
                parent = key[0]
                if parent != -1:
                    if parent not in by_bid:
                        raise SnapshotError(
                            f"prefix chain parent {parent} not in index")
                    kids[parent] = kids.get(parent, 0) + 1
                hops = 0
                while parent != -1:
                    parent = by_bid[parent][0]
                    hops += 1
                    if hops > len(by_bid):
                        raise SnapshotError("prefix chain cycle")
            for key, ent in prefix["entries"].items():
                if ent[2] != kids.get(ent[0], 0):
                    raise SnapshotError(
                        f"prefix child-count diverged on block {ent[0]}")
        # every owned block must be referenced exactly refcount times by the
        # sequences and the index: a torn mid-mutation state lands here
        for b in sorted(pool._ref):
            if pool.refcount(b) != refs.get(b, 0):
                raise SnapshotError(
                    f"block {b}: pool refcount {pool.refcount(b)} != "
                    f"{refs.get(b, 0)} mapped references")
        # the bytes the survivors will read must be the bytes that were
        # written: never a wrong-KV serve
        if list(fp["bids"]) != sorted(pool._ref):
            raise SnapshotError("fingerprint block set diverged from pool")
        with self._device_scope():
            sums = G.kv_block_checksums(kpool, vpool, fp["bids"])
        if not np.array_equal(sums, fp["sums"]):
            raise SnapshotError("KV content fingerprint mismatch")
        return pool

    def _attach(self, snap: dict, pool: PagePool, only) -> dict:
        """Install a validated snapshot (re-attach): everything is built off
        the lock against the restored pool, then installed under _cv with
        one notify; the idle scheduler picks the survivors up next
        iteration."""
        running, resume, installed = [], [], []
        blocks_attached = tokens_saved = 0
        max_id = 0
        any_deadline = any_prio = False
        for rec in snap["seqs"]:
            req = rec["req"]
            max_id = max(max_id, req.id)
            if (only is not None and req.id not in only) \
                    or req.done.is_set():
                if rec["blocks"]:
                    pool.free(rec["blocks"])
                continue
            s = _Seq(req, list(rec["tokens"]))
            s.prompt_len = rec["prompt_len"]
            if rec["phase"] == "running":
                s.blocks = list(rec["blocks"])
                s.cached_blocks = rec["cached_blocks"]
                running.append(s)
                blocks_attached += len(s.blocks)
                tokens_saved += len(s.tokens)
            else:
                # resume/admitting rows re-prefill from their tokens through
                # the preemption path, as the old engine would have
                if rec["blocks"]:
                    pool.free(rec["blocks"])
                resume.append(s)
            installed.append(req.id)
            any_deadline |= req.deadline is not None
            any_prio |= req.priority != 0
        queue = []
        for req in snap.get("queue", ()):
            max_id = max(max_id, req.id)
            if (only is not None and req.id not in only) \
                    or req.done.is_set():
                continue
            queue.append(req)
            installed.append(req.id)
            any_deadline |= req.deadline is not None
            any_prio |= req.priority != 0
        # the prefix chain rebinds to the restored pool when this engine has
        # an index; otherwise its references are released
        new_prefix = (None if self._prefix is None
                      else _PrefixCache(pool, self.config.block_size))
        if snap.get("prefix") is not None:
            ps = snap["prefix"]
            if new_prefix is not None:
                new_prefix._entries = {k: list(v)
                                       for k, v in ps["entries"].items()}
                new_prefix._by_bid = {ent[0]: k for k, ent
                                      in new_prefix._entries.items()}
                new_prefix._tick = int(ps["tick"])
            else:
                bids = [ent[0] for ent in ps["entries"].values()]
                if bids:
                    pool.free(bids)
        with self._cv:
            if self._stop or self._draining or self._broken is not None:
                raise ServeError("adopt: engine is stopped/draining/broken")
            if self._step_i or self._running or self._resume \
                    or self._admitting or self._waiting:
                raise ServeError("adopt requires a fresh engine (no traffic)")
            self._pool = pool
            # this engine's own pools go (the snapshot's replace them)
            self._kpool = snap["kpool"]
            self._vpool = snap["vpool"]
            self._prefix = new_prefix
            self._running.extend(running)
            self._resume.extend(resume)
            self._waiting.extend(queue)
            if any_deadline:
                self._deadline_seen = True
            if any_prio:
                self._has_prio = True
            if max_id:
                # adopted ids stay unique against later submissions
                self._ids = itertools.count(max_id + 1)
            self._cv.notify()
        counter_inc("serve_reattached", len(running))
        counter_inc("serve_reattached_blocks", blocks_attached)
        counter_inc("serve_reprefill_tokens_saved", tokens_saved)
        return {"mode": "reattach", "installed": sorted(installed),
                "reattached": len(running), "resumed": len(resume),
                "queued": len(queue), "blocks_reattached": blocks_attached,
                "reprefill_tokens_saved": tokens_saved,
                "reprefill_tokens": 0}

    def _adopt_reprefill(self, snap: dict, only) -> dict:
        """The whole-state fallback for a rejected snapshot: every in-flight
        record becomes a resume entry (re-prefilled from its tokens into the
        ORIGINAL request), and the queue re-queues. Nothing of the
        snapshot's pool or KV is trusted or touched."""
        resume, queue, installed = [], [], []
        tokens_reprefilled = 0
        max_id = 0
        any_deadline = any_prio = False
        for rec in snap.get("seqs", ()):
            req = rec["req"]
            max_id = max(max_id, req.id)
            if (only is not None and req.id not in only) \
                    or req.done.is_set():
                continue
            s = _Seq(req, list(rec["tokens"]))
            s.prompt_len = rec["prompt_len"]
            resume.append(s)
            installed.append(req.id)
            tokens_reprefilled += len(s.tokens)
            any_deadline |= req.deadline is not None
            any_prio |= req.priority != 0
        for req in snap.get("queue", ()):
            max_id = max(max_id, req.id)
            if (only is not None and req.id not in only) \
                    or req.done.is_set():
                continue
            queue.append(req)
            installed.append(req.id)
            any_deadline |= req.deadline is not None
            any_prio |= req.priority != 0
        with self._cv:
            if self._stop or self._draining or self._broken is not None:
                raise ServeError("adopt: engine is stopped/draining/broken")
            self._resume.extend(resume)
            self._waiting.extend(queue)
            if any_deadline:
                self._deadline_seen = True
            if any_prio:
                self._has_prio = True
            if max_id:
                self._ids = itertools.count(max_id + 1)
            self._cv.notify()
        counter_inc("serve_reprefill_tokens", tokens_reprefilled)
        return {"mode": "reprefill", "installed": sorted(installed),
                "reattached": 0, "resumed": len(resume),
                "queued": len(queue), "blocks_reattached": 0,
                "reprefill_tokens_saved": 0,
                "reprefill_tokens": tokens_reprefilled}

    def handoff(self, timeout: float = 30.0) -> dict:
        """Planned handoff: quiesce the scheduler at its next step boundary,
        then export the snapshot with the queue and the in-flight handles.

        After this returns THIS engine is stopped for good (``submit``
        raises, ``close()`` releases only plumbing: the handles live in the
        returned snapshot), and a successor adopts it:
        ``new.adopt(old.handoff())``. If the engine crashes before the
        quiesce lands, this raises ``ServeError`` and the crash path owns the
        handles (failed, or recovered by a supervisor)."""
        if threading.current_thread() is self._thread:
            raise ServeError("handoff() cannot run on the scheduler thread")
        with self._cv:
            if self._stop or self._draining or self._broken is not None:
                raise ServeError("handoff: engine is stopped/draining/broken")
            if self._handoff_req:
                raise ServeError("handoff already in progress")
            self._handoff_req = True
            self._cv.notify()
        deadline = time.monotonic() + max(0.0, float(timeout))
        while not self._quiesced.wait(timeout=0.05):
            if self._broken is not None or self._failed.is_set() \
                    or not self._thread.is_alive():
                if self._quiesced.is_set():
                    # the loop quiesced and exited between the wait's
                    # timeout and this check: not a failure
                    break
                raise ServeError(
                    "engine failed before handoff quiesce") from self._broken
            if time.monotonic() > deadline:
                raise ServeError(f"handoff quiesce timed out after {timeout}s")
        # the loop exits right after signalling: join, so the state is frozen
        self._thread.join(max(1.0, deadline - time.monotonic()))
        with span("serve_handoff", step=self._step_i):
            snap = self.snapshot()
            with self._cv:
                snap["queue"] = list(self._waiting)
                self._waiting.clear()
            # the snapshot owns every handle now: clear the scheduler lists
            # so close() cannot fail adopted streams
            self._running, self._resume, self._admitting = [], [], []
            self._prefilling = []
        counter_inc("serve_handoffs")
        return snap

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
    def _run_once(self):
        """One scheduler iteration (bounded idle wait). Truthy = stopped; the
        ``"handoff"`` sentinel also tells the loop to exit WITHOUT
        ``_shutdown`` (the handoff snapshot owns the handles)."""
        self._beat = time.monotonic()  # heartbeat: health(), the supervisor
        with self._cv:
            if self._handoff_req and not self._stop:
                # a step boundary: the capture is consistent by construction;
                # _stop flips under the same lock, so submit() raises and a
                # supervisor sees a closed engine, never a crash
                self._stop = True
                self._quiesced.set()
                return "handoff"
            idle = not (self._waiting or self._running or self._resume
                        or self._prefilling)
            if self._draining and idle:
                self._stop = True  # drain complete
            if not self._stop and idle:
                self._cv.wait(timeout=0.5)
            if self._stop:
                return True
            has_work = bool(self._waiting or self._running or self._resume
                            or self._prefilling)
        if has_work:
            self._step()
        if self._watchdog is not None:
            # a supervised engine's step lands in the watchdog's progress
            # table (and so in every crash dump's cross-rank view) as a unit
            # record of this rank, rate-limited inside publish
            self._watchdog.publish(step=self._step_i, phase="serve.step",
                                   unit=self._provider)
        return False

    def _step(self):
        self._apply_pool_shrink()
        try:
            if _inject._armed and not self._chaos_step():
                return  # a bounded wedge woke on a stopped engine
            self._step_impl()
        except Exception as e:
            if not _fmem.is_oom(e):
                raise
            # out of device memory inside a step: park free blocks (headroom
            # shrinks, admission backs off) and let the next iteration retry;
            # a streak parking cannot break falls through to the crash path
            self._on_oom(e)

    def _step_impl(self):
        with span("schedule", step=self._step_i, running=len(self._running)):
            self._drain_cancels()
            if self._deadline_seen:
                self._shed_sweep()
            # tracked so a crash mid-prefill fails their handles too
            self._admitting = self._admit()
            if self._admitting and self._chunk:
                self._admitting = self._chunk_divert(self._admitting)
            if self._admitting:
                self._prefill(self._admitting)
            self._admitting = []
            if self._prefilling:
                self._chunk_step()
            if self._running:
                if self._spec_k:
                    self._decode_spec()
                else:
                    self._decode()
            if self._obs is not None and flags.flag(
                    "FLAGS_hbm_admission", "off") != "off":
                # the admission's predicted peak against the live census
                # after the step; priced only while admission is armed
                self._hbm_drift()
            self._oom_streak = 0
            self._maybe_unpark()

    def _hbm_drift(self):
        from ..profiler import memory_census

        pred = _fmem.last_prediction().get("hbm_predicted_peak_bytes")
        if pred:
            live = int(memory_census(self._device).get("live_bytes", 0))
            if live:
                self._obs.drift("hbm_admission", pred, live)

    # clean scheduler steps before parked blocks start coming back (half at
    # a time, so a recurrence re-parks quickly); a class attribute so tests
    # can shorten the window
    _UNPARK_AFTER = 64

    def _maybe_unpark(self):
        """Pressure decay: after a clean-step window, return half the parked
        blocks to the free list, so a transient out-of-memory does not
        shrink the pool for good."""
        if not self._pool.parked_blocks:
            return
        if self._unpark_countdown > 0:
            self._unpark_countdown -= 1
            return
        self._pool.unpark(max(self._pool.parked_blocks // 2, 1))
        self._unpark_countdown = self._UNPARK_AFTER

    def _apply_pool_shrink(self):
        """Apply a cross-thread shrink request (the scheduler is the pool's
        only owner; the request word is read and cleared under _cv)."""
        with self._cv:
            req = self._shrink_req
            self._shrink_req = 0
        if not req:
            return
        n = req if req > 0 else max(self._pool.free_blocks // 4, 1)
        parked = self._pool.park(n)
        if parked:
            counter_inc("serve_pool_shrunk", parked)
            self._unpark_countdown = self._UNPARK_AFTER

    def request_pool_shrink(self, blocks: Optional[int] = None) -> dict:
        """(any thread) Ask the scheduler to park KV blocks at its next step
        boundary: admission headroom shrinks, nothing fails. ``None`` parks
        a quarter of the free list. ``fault.memory.free_pressure`` calls
        this."""
        with self._cv:
            self._shrink_req = int(blocks) if blocks else -1
            self._cv.notify()
        return {"requested_blocks": blocks or "free/4",
                "pages_free": self._pool.free_blocks,
                "pages_parked": self._pool.parked_blocks}

    def _on_oom(self, exc: BaseException) -> None:
        self._oom_streak += 1
        if self._oom_streak > 8:
            raise exc  # parking does not help: contain, do not loop
        _fmem.note_oom("serve.step", exc)
        # sequences caught mid-prefill hold blocks whose KV was never (or
        # only partly) written: free them and re-prefill through the
        # preemption path, as an evicted peer would
        for seq in self._admitting + self._prefilling:
            try:
                if seq.blocks:
                    self._pool.free(seq.blocks)
            except RuntimeError:  # the pool may be what broke
                pass
            seq.blocks = []
            seq.chunk_pos = 0
            if not seq.req.done.is_set() and seq not in self._resume:
                self._resume.append(seq)
        self._admitting, self._prefilling = [], []
        if self._prefix is not None and len(self._prefix):
            # cached prefixes are the most expendable resident state
            self._prefix.evict(max(len(self._prefix) // 2, 1))
        parked = self._pool.park(max(self._pool.free_blocks // 4, 1))
        if parked:
            counter_inc("serve_pool_shrunk", parked)
        self._unpark_countdown = self._UNPARK_AFTER
        if self._device.type == "cuda":
            # the pools are preallocated, so parking frees no device memory;
            # the failed step's cached activations go back to the device
            # here (XLA releases a failed program's buffers the same way)
            torch.cuda.empty_cache()

    def _chaos_step(self) -> bool:
        """The ``serve.*`` and ``hbm.*`` chaos points, consulted once a step
        while injection is armed. ``serve.crash`` raises out of the loop,
        ``serve.wedge`` hangs the scheduler thread (forever unless ``ms=``
        bounds it), ``serve.slow_step`` delays the step, and
        ``serve.pool_corrupt`` breaks pool conservation. Returns False when a
        bounded wedge wakes on an engine that was stopped or abandoned
        meanwhile: the step must then touch neither the pool nor the
        device."""
        step = self._step_i
        if _inject.should_fire("serve.slow_step", step=step):
            time.sleep(_inject.point_cfg("serve.slow_step").get("ms", 100)
                       / 1000.0)
        if _inject.should_fire("serve.pool_corrupt", step=step):
            self._pool.damage()
        if _inject.should_fire("serve.wedge", step=step):
            ms = _inject.point_cfg("serve.wedge").get("ms")
            if ms:
                time.sleep(ms / 1000.0)
            else:
                _inject._hang("serve.wedge")
            if self._stop or self._broken is not None:
                return False
        if _inject.should_fire("serve.crash", step=step):
            raise ServeError(f"injected serve.crash at engine step {step}")
        if _inject.should_fire("hbm.pressure", step=step):
            blocks = _inject.point_cfg("hbm.pressure").get("blocks")
            if blocks:
                self.request_pool_shrink(blocks)
        # a synthesized out-of-memory at the step's dispatch site: raises
        # into _step's handler (park + backpressure, no crash)
        _inject.maybe_hbm_oom("serve.step", step=step)
        return True

    def _shed_sweep(self):
        """Deadline enforcement at the step boundary (only once a request
        with a deadline was submitted). Expired requests fail wherever they
        sit; a queued request that cannot meet its deadline even if admitted
        now (prefill plus its whole token budget at the decode-step EMA) is
        shed before its prefill is paid."""
        now = time.monotonic()
        ema = max(self._ema_step_s, self._step_floor_s)
        shed = []
        with self._cv:
            for req in [r for r in self._waiting if r.deadline is not None]:
                eta = (1 + req.max_new_tokens) * ema
                if now >= req.deadline:
                    self._waiting.remove(req)
                    shed.append((req, f"expired in queue "
                                 f"({now - req.deadline:.3f}s late)"))
                elif now + eta > req.deadline:
                    self._waiting.remove(req)
                    shed.append((req, f"doomed at admission: needs "
                                 f"~{eta:.3f}s but the deadline is in "
                                 f"{req.deadline - now:.3f}s"))
        for req, why in shed:
            counter_inc("serve_deadline_shed")
            if self._obs is not None:
                self._obs.on_shed(
                    req, "expired" if now >= req.deadline else "doomed")
            self._finish_request(req, error=DeadlineExceeded(
                f"request {req.id} {why}", request_id=req.id))
        for seq in [s for s in self._running if s.req.deadline is not None
                    and now >= s.req.deadline]:
            counter_inc("serve_deadline_expired")
            self._retire(seq, error=DeadlineExceeded(
                f"request {seq.req.id} deadline expired mid-decode "
                f"({seq.generated}/{seq.req.max_new_tokens} generated)",
                request_id=seq.req.id))
        for seq in [s for s in self._resume if s.req.deadline is not None
                    and now >= s.req.deadline]:
            self._resume.remove(seq)
            counter_inc("serve_deadline_expired")
            self._finish_request(seq.req, error=DeadlineExceeded(
                f"request {seq.req.id} deadline expired while preempted "
                f"({seq.generated}/{seq.req.max_new_tokens} generated)",
                request_id=seq.req.id))
        for seq in [s for s in self._prefilling if s.req.deadline is not None
                    and now >= s.req.deadline]:
            self._prefilling.remove(seq)
            if seq.blocks:
                self._pool.free(seq.blocks)
                seq.blocks = []
            counter_inc("serve_deadline_expired")
            self._finish_request(seq.req, error=DeadlineExceeded(
                f"request {seq.req.id} deadline expired mid-chunked-prefill "
                f"({seq.chunk_pos}/{len(seq.tokens)} tokens cached)",
                request_id=seq.req.id))

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

    def _alloc_with_reclaim(self, need: int, extra_running: int):
        """Block grant under the headroom rule; unpinned prefix-cache
        entries are free headroom in disguise, so LRU entries are evicted
        before admission declares backpressure."""
        if self._headroom_ok(need, extra_running):
            got = self._pool.alloc(need)
            if got is not None:
                return got
        if self._prefix is not None and len(self._prefix):
            want = (need + len(self._running) + extra_running
                    - self._pool.free_blocks)
            if self._prefix.evict(max(want, 1)) \
                    and self._headroom_ok(need, extra_running):
                return self._pool.alloc(need)
        return None

    def _match_prefix(self, tokens) -> List[int]:
        """Longest cached prefix of an admission candidate; the matched
        blocks are shared here (callers free them if admission then fails).
        Capped one token short of the whole sequence: prefill must always
        produce the first-token logits."""
        bids = self._prefix.match(tokens,
                                  (len(tokens) - 1) // self.config.block_size)
        if bids:
            self._pool.share(bids)
            counter_inc("serve_prefix_hits")
            counter_inc("serve_prefix_blocks_shared", len(bids))
        else:
            counter_inc("serve_prefix_misses")
        return bids

    def _grant(self, tokens, extra_running: int):
        """(matched cached blocks, fresh blocks) covering ``tokens``, or
        None with nothing held."""
        matched = (self._match_prefix(tokens) if self._prefix is not None
                   else [])
        need = -(-len(tokens) // self.config.block_size) - len(matched)
        blocks = self._alloc_with_reclaim(need, extra_running)
        if blocks is None:
            if matched:
                self._pool.free(matched)
            return None
        return matched, blocks

    def _admit(self) -> List[_Seq]:
        """Preempted sequences first, then the queue: by priority (higher
        first) once a prioritized request was submitted, FIFO within a
        class; stops at the first request the pool's headroom cannot take,
        so nothing behind it bypasses it. Each admitted sequence owns its
        cached prefix blocks (shared) and fresh blocks for the rest."""
        admitted: List[_Seq] = []
        max_batch = self.config.max_batch
        with span("admit") as sp:
            still_resume = []
            for seq in self._resume:
                got = (self._grant(seq.tokens, len(admitted) + 1)
                       if len(self._running) + len(admitted) < max_batch
                       else None)
                if got is None:
                    still_resume.append(seq)
                    continue
                seq.blocks = got[0] + got[1]
                seq.cached_blocks = len(got[0])
                admitted.append(seq)
                if self._obs is not None and got[0]:
                    self._obs.on_prefix_match(
                        seq.req, len(got[0]) * self.config.block_size,
                        len(got[0]))
            self._resume = still_resume
            with self._cv:
                if self._has_prio and len(self._waiting) > 1:
                    cand = sorted(self._waiting,
                                  key=lambda r: (-r.priority, r.id))
                else:
                    cand = list(self._waiting)
            for req in cand:
                if len(self._running) + len(admitted) >= max_batch:
                    break
                with self._cv:
                    if req.cancelled:
                        try:
                            self._waiting.remove(req)
                        except ValueError:
                            continue  # already drained elsewhere
                        self._finish_request(req, error=RequestCancelled(
                            f"request {req.id} cancelled"))
                        continue
                    got = self._grant(req.prompt, len(admitted) + 1)
                    if got is None:
                        counter_inc("serve_backpressure")
                        break
                    try:
                        self._waiting.remove(req)
                    except ValueError:  # raced away mid-pass — undo the grant
                        self._pool.free(got[0] + got[1])
                        continue
                seq = _Seq(req, list(req.prompt))
                seq.blocks = got[0] + got[1]
                seq.cached_blocks = len(got[0])
                admitted.append(seq)
                if self._obs is not None:
                    self._obs.on_admit(req)
                    if got[0]:
                        self._obs.on_prefix_match(
                            req, len(got[0]) * self.config.block_size,
                            len(got[0]))
            if admitted:
                counter_inc("serve_admitted", len(admitted))
            sp.set(admitted=len(admitted), resume_waiting=len(self._resume))
        return admitted

    # -- prefill -------------------------------------------------------------
    def _prefill_call(self, kind: str, feeds):
        """One prefill call at the fixed prefill width over ``feeds``, one
        ``(tokens, start, blocks)`` a row: ``"prefill"`` runs the dense pass
        over whole prompts (start 0), ``"prefill_tail"`` feeds the tokens at
        absolute positions ``start + [0..len)`` against the blocks already
        in the row's table. Returns the logits at each row's last fed token,
        on the device."""
        bw = self.config.prefill_batch
        t_bucket = self._bucket_for(max(len(t) for t, _, _ in feeds))
        ids = np.zeros((bw, t_bucket), np.int32)
        starts = np.zeros((bw,), np.int32)
        lens = np.ones((bw,), np.int32)
        tables = np.full((bw, self._max_blocks), TRASH_BLOCK, np.int32)
        for r, (toks, start, blocks) in enumerate(feeds):
            ids[r, :len(toks)] = toks
            starts[r] = start
            lens[r] = len(toks)
            tables[r, :len(blocks)] = blocks
        # heartbeat before a possibly long first call (a kernel build): the
        # supervisor's staleness clock starts here
        self._beat = time.monotonic()
        self._compiling = (kind, bw, t_bucket) not in self._fns
        fn = self._get_fn(kind, bw, t_bucket)
        args = (ids, lens, tables) if kind == "prefill" \
            else (ids, starts, lens, tables)
        self._kpool, self._vpool, logits = fn(
            self._params, *map(self._dev, args), self._kpool, self._vpool)
        self._compiling = False
        return logits

    def _prefill(self, seqs: List[_Seq]):
        """Prefill by length bucket at the fixed prefill width: rows that
        matched the prefix cache run the tail program (bucketed by tail
        length, reading the shared prefix from the pool), misses the dense
        whole-prompt program."""
        bw, bs = self.config.prefill_batch, self.config.block_size
        groups: Dict[tuple, List[_Seq]] = {}
        for s in seqs:
            n = len(s.tokens) - s.cached_blocks * bs
            groups.setdefault((s.cached_blocks > 0, self._bucket_for(n)),
                              []).append(s)
        for tail, t_bucket in sorted(groups):
            group = groups[(tail, t_bucket)]
            for i in range(0, len(group), bw):
                chunk = group[i:i + bw]
                with span("prefill", bucket_t=t_bucket, bucket_b=bw,
                          rows=len(chunk), shared=tail) as sp:
                    if self._obs is not None:
                        sp.set(traces=tuple(s.req.trace for s in chunk))
                    feeds = [(s.tokens[s.cached_blocks * bs:],
                              s.cached_blocks * bs, s.blocks) for s in chunk]
                    logits = self._prefill_call(
                        "prefill_tail" if tail else "prefill", feeds)
                    counter_inc("serve_prefills")
                    if tail:
                        counter_inc("serve_tail_prefills")
                    rows = logits.float().cpu().numpy()
                    self._beat = time.monotonic()
                    self._land_prefill(chunk, rows)

    def _land_prefill(self, chunk: List[_Seq], rows: np.ndarray):
        """Index the prompt's full blocks in the prefix cache (while the
        sequence still owns them: the index takes its own reference, so a
        first-token retirement keeps the KV), then sample each row's first
        generated token and move the sequence into the running set."""
        for r, s in enumerate(chunk):
            if self._prefix is not None:
                full = s.prompt_len // self.config.block_size
                if full > s.cached_blocks:
                    self._prefix.insert(s.tokens, s.blocks, s.cached_blocks,
                                        full)
            self._append_token(s, self._sample_host(rows[r], s.req))
            if not s.req.done.is_set():
                self._running.append(s)
        if self._obs is not None:
            # ONE host clock read for the landed group: a prefill emits each
            # row's first token (TTFT)
            self._obs.on_tokens([s.req for s in chunk], time.monotonic())

    # -- chunked prefill ------------------------------------------------------
    def _chunk_divert(self, seqs: List[_Seq]) -> List[_Seq]:
        """Move admitted sequences whose uncached tail exceeds one chunk to
        the chunked queue; the rest keep the monolithic path. A diverted
        sequence already owns ALL its prompt blocks: only the K/V writes
        are spread over steps."""
        keep: List[_Seq] = []
        bs = self.config.block_size
        for s in seqs:
            if len(s.tokens) - s.cached_blocks * bs > self._chunk:
                s.chunk_pos = s.cached_blocks * bs
                self._prefilling.append(s)
            else:
                keep.append(s)
        return keep

    def _chunk_step(self):
        """Advance chunked prefill by ONE tail-prefill call (at most
        prefill_batch rows, one chunk each), then the scheduler goes on to
        the decode step, so a long prompt never stalls the live streams for
        a whole prefill. Chunk boundaries are block-aligned (the chunk is a
        multiple of the block size, a cached prefix is whole blocks); the
        earlier chunks' K/V is read back through the table. Intermediate
        logits are dropped; the last chunk lands the sequence as a
        monolithic prefill would."""
        bw = self.config.prefill_batch
        batch = self._prefilling[:bw]
        feeds = [min(self._chunk, len(s.tokens) - s.chunk_pos) for s in batch]
        with span("prefill", bucket_b=bw, rows=len(batch),
                  chunked=True) as sp:
            if self._obs is not None:
                sp.set(traces=tuple(s.req.trace for s in batch))
            logits = self._prefill_call("prefill_tail", [
                (s.tokens[s.chunk_pos:s.chunk_pos + n], s.chunk_pos, s.blocks)
                for s, n in zip(batch, feeds)])
            counter_inc("serve_prefill_chunks")
            self._beat = time.monotonic()
            for s, n in zip(batch, feeds):
                s.chunk_pos += n
            done = [r for r, s in enumerate(batch)
                    if s.chunk_pos >= len(s.tokens)]
            if done:
                finished = [batch[r] for r in done]
                self._prefilling = [s for s in self._prefilling
                                    if s not in finished]
                counter_inc("serve_prefills", len(finished))
                self._land_prefill(finished,
                                   logits[done].float().cpu().numpy())

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
        """Every live sequence needs block ``(pos + spec_k) // block_size``
        mapped before the step (the verify writes spec_k slots past pos);
        pool exhaustion first reclaims unpinned prefix-cache entries, then
        preempts a peer (evict → requeue for re-prefill) — backpressure,
        never failure. The victim is priority-then-youngest: the lowest
        priority first, the youngest among equals; a grower never evicts a
        higher-priority peer, it preempts itself instead."""
        for seq in list(self._running):
            if seq not in self._running:
                continue  # evicted by an earlier iteration
            need = ((seq.pos + self._spec_k) // self.config.block_size + 1
                    - len(seq.blocks))
            while need > 0:
                with span("page_alloc", request=seq.req.id, blocks=need):
                    got = self._pool.alloc(need)
                    if got is None and self._prefix is not None \
                            and len(self._prefix):
                        self._prefix.evict(need - self._pool.free_blocks)
                        got = self._pool.alloc(need)
                if got is not None:
                    seq.blocks.extend(got)
                    break
                victims = [s for s in self._running if s is not seq]
                if not victims:
                    # a lone sequence always fits (submit() bounds it)
                    raise ServeError(f"page pool exhausted by a single "
                                     f"sequence (request {seq.req.id})")
                victim = min(victims,
                             key=lambda s: (s.req.priority, -s.req.id))
                if victim.req.priority > seq.req.priority:
                    self._evict(seq)
                    break
                self._evict(victim)

    def _evict(self, seq: _Seq):
        with span("evict", request=seq.req.id, generated=seq.generated) as sp:
            if self._obs is not None:
                sp.set(traces=(seq.req.trace,))
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
                self._fns.pop(("spec", bb, old), None)
            self._decode_mb[bb] = mb
        return mb

    def _cow_guard(self, seq: _Seq):
        """Copy-on-write: a write-range block still shared with the prefix
        index or a peer is copied into a private block before the step
        writes it (the copy is queued on the device ahead of the step's
        scatters). Admission keeps shared blocks strictly below every write
        column (matching stops at full prompt blocks, writes start at the
        prompt's end), so this is defense in depth."""
        bs = self.config.block_size
        lo, hi = seq.pos // bs, (seq.pos + self._spec_k) // bs
        for col in range(lo, min(hi + 1, len(seq.blocks))):
            bid = seq.blocks[col]
            if self._pool.refcount(bid) <= 1:
                continue
            repl = self._alloc_with_reclaim(1, 0)
            if repl is None:
                raise ServeError(f"page pool exhausted during copy-on-write "
                                 f"(request {seq.req.id})")
            new = repl[0]
            for pool in self._pool_shards(self._kpool) \
                    + self._pool_shards(self._vpool):
                pool[:, new].copy_(pool[:, bid])
            seq.blocks[col] = new
            self._pool.free([bid])
            counter_inc("serve_cow_copies")
            if self._obs is not None:
                self._obs.on_cow(seq.req.trace, 1)

    def _decode_batch(self):
        """Map every live sequence's write blocks (copy-on-write guarded in
        a prefix-cache engine) and lay out the decode batch: (live rows,
        bucket, tables (bucket, gather width), write positions,
        temperatures), padding rows at the trash block and pos 0; None when
        no sequence is left."""
        self._grow_blocks()
        if not self._running:
            return None
        if self._prefix is not None:
            for s in self._running:
                self._cow_guard(s)
        n = len(self._running)
        bb = next(b for b in self.config.decode_buckets if b >= n)
        tables = np.full((bb, self._gather_width(bb)), TRASH_BLOCK, np.int32)
        pos = np.zeros((bb,), np.int32)
        temps = np.zeros((bb,), np.float32)
        for r, s in enumerate(self._running):
            tables[r, :len(s.blocks)] = s.blocks
            pos[r] = s.pos
            temps[r] = s.req.temperature
        return n, bb, tables, pos, temps

    def _decode(self):
        batch = self._decode_batch()
        if batch is None:
            return
        n, bb, tables, pos, temps = batch
        toks = np.zeros((bb,), np.int32)
        for r, s in enumerate(self._running):
            toks[r] = s.tokens[-1]
        # a width upgrade pops the old entry: compare by key
        warm = ("decode", bb, tables.shape[1]) in self._fns
        with span("decode_step", bucket=bb, rows=n, step=self._step_i) as sp:
            if self._obs is not None:
                sp.set(traces=tuple(s.req.trace for s in self._running))
            self._beat = time.monotonic()  # the staleness clock covers this
            fn = self._get_fn("decode", bb, tables.shape[1])
            self._compiling = not warm
            t0 = time.monotonic()
            self._kpool, self._vpool, nxt = fn(
                self._params, self._kpool, self._vpool, self._dev(tables),
                self._dev(pos), self._dev(toks), self._dev(temps), self._gen)
            nxt = nxt.cpu().numpy()
            dt = time.monotonic() - t0
            self._decode_s += dt
        self._beat = time.monotonic()  # beat before dropping the grace
        self._compiling = False
        self._note_step_time(warm, dt, sp)
        self._step_i += 1
        self._occ_live += n
        self._occ_slots += bb
        counter_inc("serve_decode_steps")
        rows_live = list(self._running)
        for r, s in enumerate(rows_live):
            self._append_token(s, int(nxt[r]))
        if self._obs is not None:
            # one host clock read at step retire, for every row that
            # emitted a token (TTFT / inter-token gap)
            self._obs.on_tokens([s.req for s in rows_live], time.monotonic())

    # -- speculative decode ---------------------------------------------------
    def _make_drafter(self, d):
        """The drafter of a speculative engine: True for the n-gram
        proposer, or (arch, params on the engine's device, window) of a
        ``GPTForPretraining`` / ``LlamaForCausalLM`` drafter."""
        if d is None or d == "ngram":
            return True
        if isinstance(d, str):
            raise ValueError(f"serving: unknown drafter {d!r}")
        if hasattr(d, "gpt"):
            state = G.gpt_decode_state
        elif hasattr(d, "lm_head") and hasattr(d, "model"):
            state = G.llama_decode_state
        else:
            raise TypeError(f"serving: unsupported drafter {type(d).__name__}")
        _, darch, dparams, dmax = state(d, self._device)
        return darch, dparams, max(2, min(self.config.draft_window,
                                          int(dmax) - self._spec_k))

    def _propose(self, bb: int) -> np.ndarray:
        """Draft proposals (bb, spec_k) for the greedy rows, -1 padded (a -1
        never equals a verify argmax, so an unproposed slot accepts nothing
        and the row emits one token)."""
        k = self._spec_k
        drafts = np.full((bb, k), -1, np.int32)
        greedy_rows = [(r, s) for r, s in enumerate(self._running)
                       if s.req.temperature <= 0.0]
        if not greedy_rows:
            return drafts
        if self._drafter is True:  # host-side n-gram prompt lookup
            for r, s in greedy_rows:
                got = _ngram_propose(s.tokens, k)
                drafts[r, :len(got)] = got
            return drafts
        _, dparams, W = self._drafter
        ids = np.zeros((bb, W), np.int32)
        lens = np.ones((bb,), np.int32)
        for r, s in greedy_rows:
            tl = min(len(s.tokens), W)
            ids[r, :tl] = s.tokens[-tl:]
            lens[r] = tl
        with span("draft", bucket=bb, rows=len(greedy_rows)):
            out = self._get_fn("draft", bb)(
                dparams, self._dev(ids), self._dev(lens)).cpu().numpy()
        for r, _ in greedy_rows:
            drafts[r] = out[r]
        return drafts

    def _decode_spec(self):
        """One speculative scheduler step: draft k tokens a row, verify them
        and the pending next-input token in ONE step, accept the longest
        agreeing prefix. Greedy rows emit 1..k+1 tokens a step, the tokens
        plain decode would give; sampling rows take the j = 0 sampled token
        and accept no drafts."""
        k = self._spec_k
        batch = self._decode_batch()
        if batch is None:
            return
        n, bb, tables, pos, temps = batch
        drafts = self._propose(bb)
        toks = np.zeros((bb, k + 1), np.int32)
        for r, s in enumerate(self._running):
            toks[r, 0] = s.tokens[-1]
            toks[r, 1:] = drafts[r]
        warm = ("spec", bb, tables.shape[1]) in self._fns
        rows_live = list(self._running)
        with span("decode_step", bucket=bb, rows=n, step=self._step_i,
                  spec_k=k) as sp:
            if self._obs is not None:
                sp.set(traces=tuple(s.req.trace for s in rows_live))
            self._beat = time.monotonic()
            fn = self._get_fn("spec", bb, tables.shape[1])
            self._compiling = not warm
            t0 = time.monotonic()
            self._kpool, self._vpool, greedy, sampled = fn(
                self._params, self._kpool, self._vpool, self._dev(tables),
                self._dev(pos), self._dev(toks), self._dev(temps), self._gen)
            greedy, sampled = greedy.cpu().numpy(), sampled.cpu().numpy()
            dt = time.monotonic() - t0
            self._decode_s += dt
            self._beat = time.monotonic()
            self._compiling = False
            self._note_step_time(warm, dt, sp)
            proposed = accepted = 0
            for r, s in enumerate(rows_live):
                if temps[r] > 0.0:
                    self._append_token(s, int(sampled[r]))
                    continue
                nprop = int(np.sum(drafts[r] >= 0))
                m = 0
                while m < nprop and drafts[r, m] == greedy[r, m]:
                    m += 1
                proposed += nprop
                accepted += m
                # the m accepted drafts come back as the target's own argmax
                # continuations, then the token after the last of them
                for j in range(m + 1):
                    if s.req.done.is_set():
                        break
                    self._append_token(s, int(greedy[r, j]))
            sp.set(drafted=proposed, accepted=accepted)
        if self._obs is not None:
            # every live row emits at least its j = 0 token a verify step:
            # one gap sample a row a step
            self._obs.on_tokens([s.req for s in rows_live], time.monotonic())
        self._step_i += 1
        self._occ_live += n
        self._occ_slots += bb
        counter_inc("serve_decode_steps")
        counter_inc("serve_draft_proposed", proposed)
        counter_inc("serve_draft_accepted", accepted)

    def _note_step_time(self, warm: bool, dt: float, sp):
        """The decode-step time EMA behind deadline feasibility and the
        Retry-After hint; a step function's first call (which may build a
        kernel) is left out, or every early deadline would look doomed. A
        traced engine first scores the estimate the shed sweep would have
        used for this step against its measured time (``step_eta`` drift,
        the step span's ``cost_drift`` attr)."""
        if warm:
            if self._obs is not None and self._ema_step_s:
                rel = self._obs.drift(
                    "step_eta", max(self._ema_step_s, self._step_floor_s), dt)
                update_attrs(sp, cost_drift=round(rel, 6))
            self._ema_step_s = (dt if not self._ema_step_s
                                else 0.8 * self._ema_step_s + 0.2 * dt)

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
        self._finish_request(seq.req, tokens=seq.tokens, error=error)

    def _finish_request(self, req: _Request, tokens=None, error=None):
        if not _finish(req, tokens=tokens, error=error):
            return
        if self._obs is not None:
            self._obs.on_done(req, error)
        if error is None:
            # the finished-request latency EMA behind the Overloaded hint
            lat = req.t_done - req.t_submit
            self._ema_req_s = (lat if not self._ema_req_s
                               else 0.8 * self._ema_req_s + 0.2 * lat)

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
            self._finish_request(seq.req, error=RequestCancelled(
                f"request {seq.req.id} cancelled"))
        # a cancel mid-chunked-prefill frees its (fully granted) prompt
        # blocks at once; the chunks already written are abandoned
        for seq in [s for s in self._prefilling if s.req.cancelled]:
            self._prefilling.remove(seq)
            self._pool.free(seq.blocks)
            seq.blocks = []
            self._finish_request(seq.req, error=RequestCancelled(
                f"request {seq.req.id} cancelled"))
        with self._cv:
            cancelled = [r for r in self._waiting if r.cancelled]
            for req in cancelled:
                self._waiting.remove(req)
        for req in cancelled:
            self._finish_request(req, error=RequestCancelled(
                f"request {req.id} cancelled"))

    def _shutdown(self):
        err = self._broken or ServeError("serving engine closed")
        if self._prefix is not None:
            try:
                self._prefix.release_all()
            except RuntimeError:  # a corrupt pool must not stop the sweep
                pass
        with self._cv:
            waiting = list(self._waiting)
            self._waiting.clear()
        for req in waiting:
            self._finish_request(req, error=ServeError(str(err)))
        # _admitting covers sequences a crash caught mid-prefill; _finish
        # dedupes any that already made it to _running
        for seq in (self._running + self._resume + self._admitting
                    + self._prefilling):
            if seq.blocks:
                try:
                    self._pool.free(seq.blocks)
                except RuntimeError:  # a corrupt pool must not stop the sweep
                    pass
                seq.blocks = []
            self._finish_request(seq.req, error=ServeError(str(err)))
        self._running, self._resume, self._admitting = [], [], []
        self._prefilling = []

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
            if self._tp:
                fn = self._tp_fn(kind, bucket)
            elif kind == "prefill":
                bw, t_bucket = bucket
                fn = G.build_paged_prefill(self._arch, bw, t_bucket, bs,
                                           self._max_blocks)
            elif kind == "prefill_tail":
                bw, t_bucket = bucket
                fn = G.build_paged_tail_prefill(self._arch, bw, t_bucket, bs,
                                                self._max_blocks)
            elif kind == "spec":
                # the verify keeps the gather path, as the reference does
                bb, mb = bucket
                fn = G.build_paged_spec_decode(self._arch, bb, self._spec_k,
                                               bs, mb)
            elif kind == "draft":
                # over the drafter's own weights, never the target's
                (bb,) = bucket
                darch, _, W = self._drafter
                fn = G.build_window_draft(darch, bb, W, self._spec_k)
            else:
                bb, mb = bucket
                build = (G.build_paged_decode_kernel
                         if flags.flag("FLAGS_serve_paged_kernel", False)
                         else G.build_paged_decode)
                fn = build(self._arch, bb, bs, mb)
            self._fns[key] = fn
            counter_inc("serve_compiles")
        return fn

    def _tp_fn(self, kind: str, bucket):
        """The tensor-parallel step of ``kind`` over the packed tree and the
        shards' pools, with the one-device step's call signature; the
        speculative kinds have none (``EngineConfig`` refuses spec_k under
        tp)."""
        bs = self.config.block_size
        kw = dict(devices=self._tp_devices, vocab=self._tp_vocab,
                  dtype=self._dtype, int8_wire=bool(self.config.tp_int8))
        if kind == "prefill":
            bw, t_bucket = bucket
            return G.build_tp_paged_prefill(self._arch_key, bw, t_bucket, bs,
                                            self._max_blocks, **kw)
        if kind == "prefill_tail":
            bw, t_bucket = bucket
            return G.build_tp_paged_tail_prefill(
                self._arch_key, bw, t_bucket, bs, self._max_blocks, **kw)
        if kind == "decode":
            return self._tp_decode(*bucket, bool(
                flags.flag("FLAGS_serve_paged_kernel", False)))
        raise RuntimeError(f"serving: step kind {kind!r} has no "
                           "tensor-parallel build")

    # -- flight-recorder context ----------------------------------------------
    def _flight_context(self) -> dict:
        """What every post-mortem carries of this engine (any thread; racy
        reads by design): queue and chunk backlog, pool gauges and the
        running table."""
        with self._lock:
            depth = len(self._waiting)
        return {
            "queue_depth": depth,
            "step": self._step_i,
            "spec_k": self._spec_k,
            "tp": self._tp,  # the tensor-parallel degree (0: one device)
            "prefill_chunk": self._chunk,
            "chunk_queue_depth": len(self._prefilling),
            "pending_chunks": sum(
                -(-(len(s.tokens) - s.chunk_pos) // max(self._chunk, 1))
                for s in list(self._prefilling)),
            "prefix_cached_blocks": (self._prefix.blocks
                                     if self._prefix is not None else 0),
            "pages": {"used": self._pool.used_blocks,
                      "free": self._pool.free_blocks,
                      "parked": self._pool.parked_blocks},
            "running": [
                {"id": s.req.id, "prompt_len": s.prompt_len,
                 "generated": s.generated, "pos": s.pos,
                 "blocks": len(s.blocks)}
                for s in list(self._running)
            ],
        }

    # -- debug hook ----------------------------------------------------------
    def _debug_step_logits(self, prompts):
        """Logits of ONE decode step over ``prompts``, built once with the
        serving kernels (the paged-attention read, and the int8 head when the
        engine attached one) and once with their plain versions, each on its
        own copy of the same pool state. The prompts are prefilled into
        freshly granted blocks that are freed afterwards. The engine must be
        idle; this runs on the calling thread. Returns
        ``(kernel_logits, plain_logits)`` as float32 numpy arrays."""
        bs, B = self.config.block_size, len(prompts)
        grants = self._debug_grants([len(p) // bs + 1 for p in prompts],
                                    "_debug_step_logits")
        try:
            with torch.inference_mode():
                tables, pos, toks = self._debug_prefill_rows(prompts, grants)
                mb = tables.shape[1]
                if self._tp:  # the shards' kernel, then their plain path
                    steps = [(self._tp_decode(B, mb, kernel), self._params)
                             for kernel in (True, False)]
                else:
                    steps = [(build(self._arch, B, bs, mb), params)
                             for build, params in (
                                 (G.build_paged_decode_kernel, self._params),
                                 (G.build_paged_decode, self._plain_params))]
                out = []
                for step, params in steps:
                    logits = step.logits(
                        params, self._clone_pool(self._kpool),
                        self._clone_pool(self._vpool), tables,
                        self._dev(pos), self._dev(toks))
                    out.append(logits.float().cpu().numpy())
            return out[0], out[1]
        finally:
            self._pool.free([b for g in grants for b in g])

    def _clone_pool(self, pool):
        if self._tp:
            return [p.clone() for p in pool]
        return pool.clone()

    def _tp_decode(self, B, mb, kernel):
        return G.build_tp_paged_decode(
            self._arch_key, B, self.config.block_size, mb, self._tp_devices,
            self._tp_vocab, self._dtype, use_kernel=kernel,
            int8_wire=bool(self.config.tp_int8))

    def _debug_grants(self, sizes, who):
        """Fresh blocks of the given counts for a debug hook (freed by the
        caller); raises when the pool cannot give them all."""
        grants = []
        for n in sizes:
            g = self._pool.alloc(n)
            if g is None:
                self._pool.free([b for g in grants for b in g])
                raise ServeError(f"{who}: pool too small")
            grants.append(g)
        return grants

    def _debug_prefill_rows(self, prompts, grants):
        """Each prompt prefilled into its granted blocks: the rows' block
        table (B, a power of two of blocks) on the device, their next write
        positions and their first generated (greedy) tokens."""
        mb = 1
        while mb < max(len(g) for g in grants):
            mb *= 2
        tables = np.full((len(prompts), mb), TRASH_BLOCK, np.int32)
        toks = np.zeros((len(prompts),), np.int32)
        for r, (p, g) in enumerate(zip(prompts, grants)):
            tables[r, :len(g)] = g
            toks[r] = int(self._prefill_call("prefill", [(p, 0, g)])[0]
                          .float().argmax())
        return (self._dev(tables), np.array([len(p) for p in prompts],
                                            np.int32), toks)

    def _debug_prefill_paths(self, prompts, head=None, chunk=None):
        """Logits at each prompt's last token by three prefill paths: the
        monolithic prefill; a tail prefill over a cached head of ``head``
        blocks (half the prompt's full blocks by default; the prefix
        index's chain for the prompt where the engine has one and it
        matches, else the monolithic pass's blocks); and a chunked prefill
        from position 0 in ``chunk``-token chunks (the engine's
        ``prefill_chunk``, else two blocks), whose last chunk gives the
        logits. Each path writes its own fresh blocks, freed after each
        prompt. The engine must be idle; this runs on the calling thread.
        Returns ``(monolithic, tail, chunked)``, float32 (n, V)."""
        bs = self.config.block_size
        chunk = chunk or self._chunk or 2 * bs
        out = ([], [], [])
        with torch.inference_mode():
            for p in prompts:
                grants = self._debug_grants([-(-len(p) // bs)] * 3,
                                            "_debug_prefill_paths")
                mono, tail, chunked = grants
                try:
                    out[0].append(self._prefill_call(
                        "prefill", [(p, 0, mono)])[0])
                    n = (len(p) - 1) // bs // 2 if head is None \
                        else min(head, (len(p) - 1) // bs)
                    cached = (self._prefix.match(p, n) if self._prefix
                              is not None else []) or mono[:n]
                    start = len(cached) * bs
                    out[1].append(self._prefill_call("prefill_tail", [
                        (p[start:], start, cached + tail[len(cached):])])[0])
                    for start in range(0, len(p), chunk):
                        last = self._prefill_call("prefill_tail", [
                            (p[start:start + chunk], start, chunked)])[0]
                    out[2].append(last)
                finally:
                    self._pool.free([b for g in grants for b in g])
        return tuple(torch.stack(o).float().cpu().numpy() for o in out)

    def _debug_spec_logits(self, prompts, k):
        """Speculative-verify logits against sequential decode. Each prompt
        is prefilled into fresh blocks; then k+1 plain (gather) decode steps
        feed one token a row at a time — the first generated token, then
        each step's own argmax — and one verify step feeds the same k+1
        tokens a row at ``pos + [0..k]``. Both overwrite each fed slot
        before any feed reads it, so they run on one pool state. Blocks are
        freed afterwards. The engine must be idle; this runs on the calling
        thread. Returns ``(verify, sequential)``, float32 (B, k+1, V)."""
        bs, B = self.config.block_size, len(prompts)
        grants = self._debug_grants([-(-(len(p) + k + 1) // bs)
                                     for p in prompts], "_debug_spec_logits")
        try:
            with torch.inference_mode():
                tables, pos, first = self._debug_prefill_rows(prompts, grants)
                mb = tables.shape[1]
                toks = np.zeros((B, k + 1), np.int32)
                toks[:, 0] = first
                step = G.build_paged_decode(self._arch, B, bs, mb).logits
                seq = []
                for j in range(k + 1):
                    seq.append(step(self._params, self._kpool, self._vpool,
                                    tables, self._dev(pos + j),
                                    self._dev(toks[:, j])).float())
                    if j < k:
                        toks[:, j + 1] = seq[-1].argmax(-1).cpu().numpy()
                ver = G.build_paged_spec_decode(
                    self._arch, B, k, bs, mb).logits(
                        self._params, self._kpool, self._vpool, tables,
                        self._dev(pos), self._dev(toks))
            return (ver.float().cpu().numpy(),
                    torch.stack(seq, 1).cpu().numpy())
        finally:
            self._pool.free([b for g in grants for b in g])


def _tp_placement(device, tp: int) -> List[torch.device]:
    """The devices of a tensor-parallel engine's tp shards, the first of
    which also holds the replicated weights and runs the replicated work:
    the sequence ``device`` names (one device a shard; a device may repeat,
    as two shards on one card do), every shard on the CPU under
    ``"cpu"``, else the first tp CUDA devices (from the index ``device``
    names), which must exist."""
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
        if len(devs) != tp:
            raise ValueError(f"serving: {len(devs)} devices given for "
                             f"tp={tp} shards")
        return devs
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * tp
    n = torch.cuda.device_count()
    if dev.index + tp > n:
        raise ValueError(f"serving: tp={tp} exceeds the {n - dev.index} "
                         "visible devices")
    return [torch.device("cuda", dev.index + i) for i in range(tp)]


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
                # clients blocked on events that will never fire, and let
                # nothing (not even a failing post-mortem) stand between the
                # crash and that sweep; an exhaustion that defeated the
                # parking ladder lands here too
                if _fmem.is_oom(e):
                    _fmem.note_oom("serve.loop", e)
                eng._broken = e
                try:
                    counter_inc("serve_engine_errors")
                    flight.dump("serving_loop_error",
                                extra={"exception": repr(e)})
                finally:
                    if eng._supervised:
                        # leave the queued and in-flight state for the
                        # supervisor to harvest (requeue or re-attach on the
                        # restarted engine); the event wakes its monitor
                        eng._failed.set()
                    else:
                        eng._shutdown()
                return
            if stopped:
                # a handoff exits without failing handles (the snapshot owns
                # them), and so does an engine that someone else stopped and
                # marked broken (a wedged close, a supervisor's quarantine):
                # they already resolved its handles, and a late-waking
                # thread must not touch its pool
                if stopped != "handoff" and eng._broken is None:
                    eng._shutdown()
                return
            del eng
