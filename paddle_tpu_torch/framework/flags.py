"""Global flag registry (the ``FLAGS_serve_*`` entries the serving engine and
its supervisor read, ``FLAGS_profile_memory``, the kernel registry's
``FLAGS_kernel_*``, the nan/inf scan's ``FLAGS_check_nan_inf*``, the
stability sentinel's ``FLAGS_stability_*``, the HBM admission's
``FLAGS_hbm_*``, data parallelism's bucket, quantization and ZeRO
switches, the watchdog's ``FLAGS_collective_timeout_s``, the
checkpoint's ``FLAGS_ckpt_verify_on_load``, the host embedding's
``FLAGS_host_emb_*`` and the runtime ownership checks'
``FLAGS_thread_checks``).

Same names, defaults and ``FLAGS_*`` environment pickup as the reference's
``paddle_tpu/framework/flags.py``; ``set_flags`` rejects unknown names with a
did-you-mean hint instead of creating dead flags.
"""
from __future__ import annotations

import difflib
import os
from typing import Dict

_FLAGS: Dict[str, object] = {
    # Distributed supervision: the deadline of every guarded collective,
    # barrier and host sync (distributed/watchdog.py; 0 disables it: no
    # thread, no sync), and whether a checkpoint load recomputes its
    # leaves' CRCs against the manifest (distributed/checkpoint.py).
    "FLAGS_collective_timeout_s": 0.0,
    "FLAGS_ckpt_verify_on_load": True,
    # Runtime ownership assertions (analysis/thread_checks.py): the
    # watchdog's tables and the prefetcher's resume anchor are wrapped in
    # proxies whose every mutation checks its lock or its owner thread, so
    # a race fails at the mutation site. Off: the wrappers are identities.
    "FLAGS_thread_checks": False,
    # The nan/inf scan (core/dispatch.py): while FLAGS_check_nan_inf is set,
    # every floating output of every op is checked and the first non-finite
    # one raises FloatingPointError. FLAGS_check_nan_inf_per_op is accepted;
    # the port already checks op by op, so it changes nothing.
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_per_op": False,
    # Per-step memory census (the caching allocator's counters feeding the
    # profiler's live_bytes/peak gauges and the train_step span's attrs)
    # without a running Profiler; Profiler(profile_memory=True) turns it on
    # per session.
    "FLAGS_profile_memory": False,
    # Serving engine defaults: KV block size in tokens, total preallocated
    # blocks in the pool (block 0 is the reserved trash block), the decode
    # batch-width ceiling (bucketed in powers of two up to this), the fixed
    # prefill batch width, the per-sequence length cap (clamped to the
    # model's max_position_embeddings), and the weight-only int8 path.
    # EngineConfig fields override per engine.
    "FLAGS_serve_block_size": 16,
    "FLAGS_serve_num_blocks": 512,
    "FLAGS_serve_max_batch": 64,
    "FLAGS_serve_prefill_batch": 4,
    "FLAGS_serve_max_seq_len": 2048,
    "FLAGS_serve_int8": False,
    # Serving kernels: FLAGS_serve_paged_kernel routes decode attention
    # through the paged-attention kernel (reads K/V straight from the pool
    # blocks); FLAGS_serve_int8_kernel keeps the int8 LM-head weight
    # quantized end to end through the fused int8 matmul kernel.
    "FLAGS_serve_paged_kernel": False,
    "FLAGS_serve_int8_kernel": False,
    # Throughput features, all off by default (an engine with every one off
    # takes the plain path): FLAGS_serve_prefix_cache keeps prompts' full KV
    # blocks in a refcounted prefix index, so admission shares the longest
    # cached prefix and prefills only the tail; FLAGS_serve_spec_k > 0 arms
    # speculative decoding (a drafter proposes k tokens a row, one step
    # verifies them all, greedy output unchanged); FLAGS_serve_drafter is
    # the proposer ("ngram", host-side prompt lookup; a small same-family
    # model goes to Engine(drafter=...)); FLAGS_serve_draft_window bounds a
    # model drafter's window in tokens; FLAGS_serve_prefill_chunk > 0 (a
    # multiple of the block size) prefills long prompts one chunk per
    # scheduler step between decode steps.
    "FLAGS_serve_prefix_cache": False,
    "FLAGS_serve_spec_k": 0,
    "FLAGS_serve_drafter": "ngram",
    "FLAGS_serve_draft_window": 64,
    "FLAGS_serve_prefill_chunk": 0,
    # Tensor-parallel serving. FLAGS_serve_tp shards attention heads, FFN
    # columns, the LM head and the KV pool over tp shards (0/1 = one
    # device, the exact prior code path). Every tensor-parallel boundary is
    # a concat of column-partitioned outputs (never a sum of partials), an
    # exact gather; greedy decode equals the one-device engine's only where
    # each shard's product rounds as the full product's columns. On the
    # H100 cuBLAS's bf16 q/k/v projections of Llama-7B do not (ROADMAP §C).
    # FLAGS_serve_tp_int8 sends those payloads as blockwise int8 with f32
    # scales (lossy: greedy tokens may differ; off by default). Both are off
    # by default and their code paths are never reached unconfigured.
    "FLAGS_serve_tp": 0,
    "FLAGS_serve_tp_int8": False,
    # Resilience:FLAGS_serve_max_queue is the queue depth at which the shed
    # policy engages (0 = never), enforced only with FLAGS_serve_shed, when a
    # submit past the cap fast-fails with Overloaded (a retry_after_s hint)
    # instead of queueing without bound; FLAGS_serve_watchdog_s is the
    # ServingSupervisor's liveness deadline (a crashed or wedged scheduler
    # thread is detected within it); FLAGS_serve_snapshot makes the
    # supervisor's crash recovery capture the dead engine's serving state and
    # re-attach it in the replacement (zero re-prefilled tokens), falling
    # back to re-prefill when the capture fails validation.
    "FLAGS_serve_max_queue": 0,
    "FLAGS_serve_shed": False,
    "FLAGS_serve_watchdog_s": 10.0,
    "FLAGS_serve_snapshot": False,
    # Serving SLO observability (serving/observe.py): FLAGS_serve_trace arms
    # request tracing (a trace id per request, a per-request timeline of its
    # queue wait, prefills, decode steps, evictions and relays, kept in a
    # bounded ring of FLAGS_serve_trace_ring completed timelines) and the
    # TTFT / inter-token / end-to-end / queue-wait histograms per priority
    # class. Off (default): the engine never touches the observe module.
    # FLAGS_serve_metrics_port > 0 starts the stdlib http.server telemetry
    # thread (/metrics, /healthz, /readyz, /debug/requests); 0 = no thread.
    "FLAGS_serve_trace": False,
    "FLAGS_serve_trace_ring": 256,
    "FLAGS_serve_metrics_port": 0,
    # Kernel autotuning (ops/kernels/). FLAGS_kernel_autotune: "off" makes
    # resolve_config a dict probe returning each kernel's pinned defaults
    # (the launches of the call sites before the registry existed);
    # "ondemand" reads persisted winners from the tuning DB but never
    # searches; "search" runs a measured-timing search on a DB miss and
    # persists the verified winner. FLAGS_kernel_tune_dir overrides the DB
    # location (default ~/.cache/paddle_tpu_torch/tune). Per-kernel search
    # budget and timing samples: FLAGS_kernel_tune_budget_s (monotonic
    # deadline), FLAGS_kernel_tune_samples (median-of-k, first call
    # excluded).
    "FLAGS_kernel_autotune": "off",
    "FLAGS_kernel_tune_dir": "",
    "FLAGS_kernel_tune_budget_s": 20.0,
    "FLAGS_kernel_tune_samples": 5,
    # Training stability sentinel (fault/sentinel.py): robust (median/MAD)
    # anomaly detection over per-step signals (loss, global grad norm,
    # update/param ratio, non-finite rate) with a skip -> rollback -> halt
    # ladder and batch quarantine. window/warmup/zmax parameterize the
    # statistics; max_skips/max_rollbacks/cooldown shape the ladder;
    # anchor_interval + ckpt_dir configure the rollback anchor (an
    # AutoCheckpoint in that directory); quarantine_dir (when set)
    # persists the quarantine log as JSONL. FLAGS_stability_enable is the
    # reference's hapi.Model.fit switch (hapi comes with ROADMAP A12).
    "FLAGS_stability_enable": False,
    "FLAGS_stability_window": 64,
    "FLAGS_stability_warmup": 8,
    "FLAGS_stability_zmax": 8.0,
    "FLAGS_stability_max_skips": 2,
    "FLAGS_stability_max_rollbacks": 2,
    "FLAGS_stability_cooldown": 16,
    "FLAGS_stability_anchor_interval": 25,
    "FLAGS_stability_ckpt_dir": "",
    "FLAGS_stability_quarantine_dir": "",
    # HBM admission (fault/memory.py). FLAGS_hbm_admission gates the
    # preflight check on the step programs (jit.CompiledTrainStep and
    # distributed.engine.HybridParallelEngine): "off" (default; the whole
    # disabled path is one flag probe a step), "warn" (measure each step
    # signature's footprint on its first two calls, predict later calls, warn
    # once a site when over budget, run anyway), "enforce" (raise a
    # structured HbmBudgetExceeded BEFORE the step touches the device).
    # FLAGS_hbm_budget_bytes overrides the device budget (0 = the card's
    # capacity minus FLAGS_hbm_reserve_bytes; on the CPU, which reports no
    # capacity, 0 means no budget: admission predicts, never rejects).
    "FLAGS_hbm_admission": "off",
    "FLAGS_hbm_budget_bytes": 0,
    "FLAGS_hbm_reserve_bytes": 256 * 1024 * 1024,
    # Data parallelism (distributed/parallel.py, distributed/engine.py).
    # FLAGS_shard_weight_update is the reference's ZeRO-1 sharded weight
    # update for pure-DP meshes (dp > 1, no accumulation, an elementwise
    # rule); on by default as there. FLAGS_quantized_allreduce compresses
    # each gradient bucket's all-reduce (or the sharded update's
    # reduce-scatter) blockwise to int8 (FLAGS_quantized_allreduce_block
    # elements a scale; lossy, off by default), and
    # FLAGS_quantized_allreduce_error_feedback carries the sharded update's
    # compression residual into the next step. FLAGS_dp_bucket_bytes caps a
    # gradient bucket (the reference DataParallel's comm_buffer_size=25MB).
    "FLAGS_shard_weight_update": True,
    "FLAGS_quantized_allreduce": False,
    "FLAGS_quantized_allreduce_block": 128,
    "FLAGS_quantized_allreduce_error_feedback": False,
    "FLAGS_dp_bucket_bytes": 25 * 1024 * 1024,
    # Host-embedding parameter server (incubate/host_embedding.py).
    # FLAGS_host_emb_native routes the table's batched unique/gather, the
    # duplicate-id grad merge and the sparse update through the native
    # library (core/csrc/embed.cc; multi-threaded, bit-exact with the numpy
    # path); a library that cannot be built raises. 0 selects the numpy path
    # explicitly. FLAGS_host_emb_threads caps the kernel thread count (0 =
    # every core). FLAGS_host_emb_cache_rows sizes the device hot-row cache
    # (rows; 0 = off); admission needs FLAGS_host_emb_cache_min_count
    # sightings, and when the device budget resolves the cache is clamped
    # to FLAGS_host_emb_cache_frac of it (a pressure handler halves it).
    # FLAGS_host_emb_async_push makes apply_gradients enqueue the sparse
    # update to the PS worker thread (FIFO against later pulls). Sharded
    # table transport: FLAGS_host_emb_chunk_bytes per store message,
    # FLAGS_host_emb_transport_threads parallel store clients (0 = serial),
    # FLAGS_host_emb_push_fp16 sends push grads as float16 (lossy, off).
    "FLAGS_host_emb_native": True,
    "FLAGS_host_emb_threads": 16,
    "FLAGS_host_emb_cache_rows": 0,
    "FLAGS_host_emb_cache_min_count": 3,
    "FLAGS_host_emb_cache_frac": 0.25,
    "FLAGS_host_emb_async_push": False,
    "FLAGS_host_emb_chunk_bytes": 4 * 1024 * 1024,
    "FLAGS_host_emb_transport_threads": 4,
    "FLAGS_host_emb_push_fp16": False,
}

for _k, _cur in list(_FLAGS.items()):
    if _k in os.environ:
        _v = os.environ[_k]
        if isinstance(_cur, bool):
            _FLAGS[_k] = _v.lower() in ("1", "true", "yes")
        elif isinstance(_cur, int):
            _FLAGS[_k] = int(_v)
        elif isinstance(_cur, float):
            _FLAGS[_k] = float(_v)
        else:
            _FLAGS[_k] = _v


def set_flags(flags: dict) -> None:
    for k, v in flags.items():
        if k not in _FLAGS:
            hint = difflib.get_close_matches(k, _FLAGS, n=1)
            raise KeyError(
                f"unknown flag {k!r}"
                + (f"; did you mean {hint[0]!r}?" if hint else ""))
        _FLAGS[k] = v
    if "FLAGS_check_nan_inf" in flags:
        from ..core import dispatch

        dispatch._sync_scan()


def get_flags(flags) -> dict:
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def flag(name, default=None):
    return _FLAGS.get(name, default)
