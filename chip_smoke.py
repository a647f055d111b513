"""GPU smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one card.

    python3 chip_smoke.py            # the whole run; needs one CUDA card
    python3 chip_smoke.py --profile  # + device breakdowns of a decode step
                                     #   (the verify step of drive f), of
                                     #   a GPT, a Llama-7B and an ERNIE
                                     #   train step, through the port's
                                     #   profiler
    python3 chip_smoke.py --launch-worker DIR  # 16d's worker, the process
                                     #   launch starts (not run by hand)
    python3 chip_smoke.py --phase17  # the build and phase 17 alone: its
                                     #   tp_native line, no result line
    python3 chip_smoke.py --phase18  # the build and phase 18 alone: its
                                     #   op_surface line, no result line
    python3 chip_smoke.py --phase19  # the build and phase 19 alone: its
                                     #   nn line, no result line
    python3 chip_smoke.py --phase20  # the build and phase 20 alone: its
                                     #   hapi_vision line, no result line
    python3 chip_smoke.py --phase21  # the build and phase 21 alone: its
                                     #   export line, no result line
    python3 chip_smoke.py --phase22  # the build and phase 22 alone: its
                                     #   quant_incubate line, no result
                                     #   line
    python3 chip_smoke.py --phase23  # the build and phase 23 alone: its
                                     #   text_data line, no result line

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. build: every CUDA kernel source in ``paddle_tpu_torch/ops/kernels/csrc``
   with nvcc for sm_90a (one nvcc per source, started together); prints
   ptxas's registers and spill-store bytes of every kernel instantiation;
   ``cuobjdump -sass`` must find no int-to-float conversion (I2F, I2FP) in
   the bf16 int8 kernel (both its block widths, 384 and 192 weight rows);
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
   (decode buckets, prefill width, and each bucket's speculative verify of
   bucket x (SPEC_K + 1) rows, up to 160), at GPT's head (K = 2048, N = 50304)
   and at Llama's (K = 4096, N = 32000), then two passes (48 rows), a
   ragged N and a ragged K, each in both weight layouts (bf16 also by
   relative norm against the f32 plain version), and one-hot and two-hot
   rows whose output must be the reference's dequant bit for bit, at every
   (K, N) (so at K = 4096 too); the
   flash-attention forward (O, LSE) and backward (dQ, dK, dV) at small
   shapes (ragged causal tails, non-causal T != T_kv, causal T < T_kv, a
   D=40 head, T=130 at D=128, every head width instantiation), in bf16 at
   the training shape, at the long-sequence shape (T=8192, D=64) and at
   Llama-7B's training shape (B=1, T=2048, H=32, D=128); at
   every shape dQ and dK/dV are each launched twice on the same inputs, and
   the two must agree bit for bit; in bf16 O, dQ, dK and dV are also held by
   relative norm to the bf16 plain versions, which round P and dS to bf16
   where the reference's kernels do. Every config of the kernel registry's
   axes runs too: at every paged check shape each explicit cluster size
   (``split`` 1, 2, 4, 8 where every block keeps >= 64 positions) against
   the plain version with the same tolerances, the rule's size bit for bit
   the default launch; at every int8 check shape ``block_n = 192`` against
   the plain version (counted bit-equal to 384's output or not), and the
   one-hot and two-hot rows at both widths;
3. engine: GPT-3 1.3B at full width (24 layers, bf16, random weights from a
   seed) through ``serving.Engine`` over 32 greedy requests, (a) with the
   paged-attention kernel and (b) int8 weights with both kernels; (e) the
   prefix cache and chunked prefill (chunks of 256) with the paged kernel:
   one request, then 32 at once whose prompts share a 512-token prefix,
   each of which must hit the cache for its 32 blocks; (f) speculative
   decoding (4 n-gram drafts a row) with int8 weights and the int8 head,
   then once with a 2-layer GPT at 1.3B's width as a model drafter; (g)
   serving-state durability and resilience on the paged kernel, each
   sub-drive's 32 requests queued before the first admission: g0 the
   uninterrupted run twice (the two must agree token for token), g1 a
   handoff after 16 decode steps (``new.adopt(old.handoff())`` must
   re-attach with no token re-prefilled and give g0's tokens; the ms of
   ``handoff()``, ``adopt()`` and the KV checksums are printed), g2 a
   ``ServingSupervisor`` (snapshot on) over a crash at decode step 24 (one
   restart, a re-attach, g0's tokens), g3 a handoff whose capture is torn
   (``serve.snapshot_corrupt``: adopt falls back to re-prefill, every
   request completes), g4 a synthesized out-of-memory at step 8 (blocks
   parked, nothing fails), g5 ``max_queue=8, shed=True`` (32 at once: some
   ``Overloaded`` with a positive ``retry_after_s``, the accepted ones
   complete), a 1 ms deadline (``DeadlineExceeded``) and
   ``close(drain=True)`` with work in flight (``ready()`` False with reason
   "draining" meanwhile, every request completes); then Llama-7B at full
   width and depth (32 layers, 32 heads, KV = 32, FFN 11008, vocab 32000,
   untied head, bf16, random weights from a seed) as (a) and (b), (c) and
   (d), and (h) as g0 and g1. g2 must also leave two parseable flight
   dumps (the scheduler's ``serving_loop_error``, the supervisor's
   ``serving_supervisor_crash``) that carry the engine's 32 running rows,
   the supervisor's context and, last, the crash step's decode step; g4
   takes ``fault.memory.post_mortem`` with the engine alive, which must carry
   the allocator's census. (i), after (g): (a)'s engine with ``trace=True``
   and the telemetry endpoint on a free local port serves (a)'s wave queued
   before the first admission, and must give the tokens of the same engine
   with tracing off, 32 closed timelines (``queue``, ``prefill``, decode
   steps), TTFT, end-to-end and queue-wait histograms of 32 and an
   inter-token one of 32 x 63, valid Prometheus text on ``/metrics`` with
   the same counts, the live trace ids on ``/debug/requests``, ``/healthz``
   200, and ``/readyz`` 200 then 503 after ``close(drain=True)``; it prints
   p50/p99 TTFT and inter-token gap; then the port's profiler with a device
   timeline over 8 of the engine's decode steps must name the paged kernel
   24 times a step, as many as its wrapper counts, and the observability
   tax is measured (trace-off and trace-on engines, 6 alternating pairs of
   32 x 16-token waves, median ratio; reported, not held to a bound), then
   a trace-off engine serves with every ``serving.observe`` hook made to
   raise. Launch counts are zeroed just before each
   drive (each sub-drive of (g) and (h)) and read just after it; every output must have exactly prompt +
   64 tokens and the pool must drain (to the prefix index's own blocks in
   (e), and to none after its ``close()``). One decode step built with the
   kernels is held against the same step built with the plain versions on
   the same pool state; the tail-prefill (over the cached prefix) and last
   chunk's logits against the monolithic prefill's (e), and the verify
   step's logits at each fed position j against j + 1 sequential decode
   steps (f), all within ``LOGITS_REL_TOL``; (c)'s engine holds the same
   three builders at Llama's shapes (RoPE on a position grid, GQA). Each
   model and its engines are freed before the next;
5. train: GPT-3 1.3B at full width and depth (bf16, seed 0, dropout 0,
   flash attention, fused LM-head loss, AdamW lr 1e-4) through
   ``jit.compile_train_step`` on one fixed b2 x s2048 batch: 2 warm-up and
   8 timed steps, under the port's profiler with the memory census, whose
   ``train_step`` spans must each carry ``live_bytes`` and ``delta_bytes``
   and whose ``peak_live_bytes`` must be within 1% of
   ``torch.cuda.max_memory_allocated()``; the flash counters, zeroed just
   before the timed steps, must each read 24 x 8; losses finite and
   falling; a device timeline of one more step must name ``fwd_wgmma``,
   ``dq_wgmma`` and ``dkv_wgmma`` 24 times each. A 4-layer full-width
   model's gradients through the kernels are held against the same
   backward with attention on the plain version. Runs before phase 4, so
   the timing rows carry its launch counts;
7. Paddle-API train: the same model written against the port's Paddle API
   alone (``import paddle_tpu_torch as paddle``): built f32 from seed 0 as
   an ``nn.Layer``, then ``bfloat16()``, ids through ``paddle.to_tensor``,
   and the eager loop ``model.loss`` → ``loss.backward()`` → ``opt.step()``
   → ``opt.clear_grad()`` → ``sched.step()``. (7a) with ``AdamW(1e-4)``
   alone, its first 3 losses must equal phase 5's first 3 compiled-step
   losses within ``API_LOSS_REL_TOL``; (7b) with AdamW, a
   ``LinearWarmup(CosineAnnealingDecay)`` schedule, ``ClipGradByGlobalNorm
   (1.0)`` and a decay gate on ``p.name``, 2 warm-up and 8 timed steps: the
   flash counters, zeroed before the timed steps, must read 24 x 8 each,
   the lrs equal the schedule's closed form, the clipped global norm of the
   first 3 steps be <= 1.0 x (1 + 1e-2) where the unclipped one (f32, from
   a copy taken before ``step()``) exceeds 1, the gate be 0 exactly on the
   parameters outside the decay list, the losses finite and falling, and a
   device timeline of one more step name ``fwd_wgmma``, ``dq_wgmma`` and
   ``dkv_wgmma`` 24 times each; it prints the step ms, tokens/s, MFU and
   peak memory beside phase 5's; (7c) the state captured after step 5
   (``model.state_dict()`` and ``opt.state_dict()``, copied to the CPU)
   goes into a fresh model, optimizer and schedule through
   ``set_state_dict``, and steps 6-8 must give the uninterrupted losses
   within ``API_LOSS_REL_TOL``. It prints a ``{"paddle_api_train": ...}``
   line; the flash rows of the ``kernels`` line carry its launches as
   ``launches_paddle_api``. Runs after phase 5, whose model is freed first;
8. Llama-7B train: ``llama_7b()`` at full width and depth (32 layers, hidden
   4096, 32 heads, FFN 11008, vocab 32000, untied head; bf16, seed 0, no
   dropout) through ``jit.compile_train_step`` with ``AdamW(1e-4)`` on one
   fixed b1 x s2048 batch: 2 warm-up and 8 timed steps under the memory
   census (``peak_live_bytes`` within 1% of
   ``torch.cuda.max_memory_allocated()``), the flash counters, zeroed just
   before the timed steps, must each read 32 x 8, losses finite and
   falling, and a device timeline of one more step must name
   ``fwd_wgmma``, ``dq_wgmma`` and ``dkv_wgmma`` 32 times each; first a
   2-layer full-width model's gradients through the kernels are held
   against the same backward on the plain attention within
   ``FLASH_GRAD_REL_TOL``. Step ms, tokens/s, MFU and peak memory are
   printed; the flash rows of the ``kernels`` line carry the launches as
   ``launches_llama_train``;
9. ERNIE-3.0 base: ``ernie_3_base()`` (vocab 40000, hidden 768, 12 layers,
   12 heads, FFN 3072, dropout 0.1) in f32 through the eager Paddle loop
   with ``Lamb(lamb_weight_decay=0.01)``, the LayerNorms' weights and
   biases excluded through ``exclude_from_weight_decay_fn``, on synthetic
   MLM data (b8 x s512, 15% of the positions masked and labelled, the rest
   -100) and NSP labels: 2 warm-up and 8 timed steps, losses finite and
   falling. Then each of ``Adamax``, ``RMSProp`` (centered, momentum 0.9),
   ``Adagrad``, ``Adadelta``, ``Lamb`` and ``LarsMomentum`` takes 3 f32
   steps and one bf16 step on a 2-layer full-width ERNIE (dropout 0) on the
   card and on the CPU from the same weights, each step on the card's
   gradients of the same batch (b2 x s128, a slice of the training batch);
   parameters and accumulators must agree: f32 within
   ``OPT_F32_TOL`` x (1 + |cpu|), bf16 within one bf16 ulp of each tensor's
   largest value, in the same dtypes;
10. dense generation: GPT-3 1.3B (phase 3's model and seed) on 4 prompts of
   128 tokens through ``model.generate``, greedy, ``num_beams=4`` and
   sampled (``top_k=50, top_p=0.9`` on a seeded generator), 32 new tokens
   each; Llama-7B greedy on 2 prompts. Every output must be its prompt and
   32 in-vocabulary ids; the dense prefill's last-position logits are held
   to the engine's monolithic prefill's within ``LOGITS_REL_TOL``; each
   row's first generated token must equal the engine's greedy one (unless
   the engine's top two logits are within ``GEN_TIE_GAP``, printed); an eos
   run must stop early (``last_decode_steps()`` below 32, the tail eos). It
   prints each call's tokens/s and ms a step, the share of greedy tokens
   equal to the engine's, and the beam's and greedy's f32 sum log-probs;
11. the nan/inf scan: with ``FLAGS_check_nan_inf`` set, a 2-layer full-width
   GPT-3 1.3B forward with one weight NaN must raise ``FloatingPointError``
   naming the ATen op, write a ``naninf`` flight dump and count one
   ``naninf_trips``; cleared, the same forward runs and no dispatch mode is
   left; the forward's ms with the flag off and on are printed;
12. the training runtime (runs after phase 9): (12a) GPT-3 1.3B at full
   width and depth with float32 parameters under ``amp.auto_cast(level=
   "O1", dtype="bfloat16")`` by phase 7's loop (AdamW, warm-up/cosine,
   global-norm clip, decay gate), its batches (synthetic token rows from
   seed 0) from ``io.DataLoader(seed=0, num_workers=2)`` (forked workers)
   through ``io.DevicePrefetcher(buffer_size=2)``, each step judged by
   ``fault.StabilitySentinel.observe`` (warm-up 4): 2 warm-up and 8 timed
   steps, the flash counters, zeroed just before them, must read 24 x 8
   each, the flash kernels must get bf16 q/k/v and the fused CE float32
   inputs, the sentinel must stay silent; a device timeline of 2 steps
   must name each flash kernel 24 times a step and show host-to-device
   copies on a stream of their own overlapping compute; the flash kernels
   are held against their plain versions on layer 0's own O1 q/k/v; then
   one ``grad.spike`` (x 10000) through ``maybe_spike`` must give a
   ``skip`` verdict on ``grad_norm``, leave the parameters bit-equal and
   quarantine the batch's loader position and samples. It prints the step
   ms, tokens/s, MFU, peak memory, the host's prefetcher waits and the
   sentinel's observe ms beside phase 7's bf16-parameter step. (12b)
   ERNIE-3.0 base, phase 9's model and batch (through a seeded loader)
   with float32 parameters under ``auto_cast(level="O1",
   dtype="float16")`` with ``GradScaler(init_loss_scaling=2**15)``: the
   scale after each step, the steps skipped for inf, the step ms, tokens/s
   and peak beside phase 9's f32 step, and the losses beside phase 9's;
   ``GradScaler``'s unscale on the card must equal a float32 CPU division
   bit for bit; then the same run preempted after step 5
   (``PreemptionGuard.preempt()``, ``check`` drains and calls a local
   checkpoint's ``save_now``, which ``paddle.save``s the model, optimizer,
   scaler and loader state and the port's generator state) is rebuilt
   from ``paddle.load`` into a model of other weights, and steps 6-8 must
   give the uninterrupted losses within ``RT_LOSS_REL_TOL``; the file's
   bytes and the save and load ms are printed. One
   ``{"runtime_train": ...}`` line; the flash rows of the ``kernels`` line
   carry 12a's launches as ``launches_amp``;
13. the engine (runs after phase 11; 13c at the end of phase 8, on its
   model and optimizer): ``distributed.init_parallel_env()`` joins an NCCL
   group of one rank, and GPT-3 1.3B (phase 5's model, batch and AdamW) in
   ``DataParallel`` trains through ``distributed.HybridParallelEngine``.
   (13a) ``all_reduce`` (AVG), ``all_gather``, ``all_gather_into_tensor``
   and ``broadcast`` over the NCCL group must give their input back; from
   one start, 3 engine steps against 3 ``compile_train_step``
   steps (losses and parameters bit-equal is the expectation; the reading
   is printed either way) and against 3 steps at ``grad_accumulate=2``
   (losses within ``ENGINE_ACC_REL_TOL``); then 2 warm-up and 8 timed
   steps: step ms, tokens/s, MFU, peak, the buckets a step (at world 1 the
   sync is the reference's single-participant identity: ``dp_buckets``
   must read one a bucket and ``dp_all_reduces`` none) and the flash
   counters (24 x 8 each); a device timeline of one step counts its NCCL
   kernels. (13b) from a fresh engine and a fresh AdamW under
   ``FLAGS_hbm_admission=enforce``: the first two steps are measured (each
   attribution's ``peak_bytes`` printed beside ``max_memory_allocated``;
   the first builds the gradients and moments, the second is the steady
   step), the third is admitted and its predicted and realized peaks are
   printed as a drift, a budget 1 MiB above that realized peak must admit
   the fourth, a budget 1 MiB under the prediction (set after the state
   snapshot) must raise ``HbmBudgetExceeded`` exactly 1 MiB over it with
   no launch (flash counters and a CUDA event pair) and the parameters,
   gradients, AdamW state and RNG bit-equal, the same call with the budget
   restored must equal an unadmitted run bit for bit, and ``warn`` must
   warn once over 2 steps. (13c) Llama-7B at b4 x s2048 through the engine
   must meet a real ``torch.OutOfMemoryError`` whose retry fails and whose
   degrade rung fits; the attempts, the bytes ``free_pressure`` released,
   the rung and the next 3 steps' ms and peak are printed, and those steps
   must stay on ``engine.accum`` with no second out-of-memory; they run
   under ``enforce`` at the card's budget, and the third must be admitted
   (its predicted and realized peaks printed). (13d) ``hbm.oom:op=engine.step,from=1`` must give
   losses and parameters bit-equal to the ``grad_accumulate=2`` run of
   13a, and ``hbm.oom:from=1`` ``HbmExhausted`` with ``free_pressure``,
   ``degrade_x2`` and ``degrade_x4`` in its attempts and a flight dump that
   carries ``budget_bytes`` and the attributions. (13e) one traced serving
   drive (4 requests, 8 tokens) under ``warn`` must record an
   ``hbm_admission`` drift. The process group is destroyed at the end.
   One ``{"engine_train": ...}`` line; the flash rows of the ``kernels``
   line carry 13a's launches as ``launches_engine``;
14. fleet (runs at the end of phase 13, on its NCCL group of one rank and
   its GPT-3 1.3B, batch and start): (14a) ``fleet.init`` with every
   degree 1, ``fleet.distributed_model``, ``fleet.distributed_optimizer``
   (AdamW) and ``HybridParallelEngine(mesh=hcg.mesh)``: 3 steps from one
   start must give 13a's engine's losses and parameters bit for bit, and
   so must ``group_sharded_parallel(level="os_g")`` over the one-rank
   sharding group; then 2 warm-up and 8 timed steps (step ms, tokens/s,
   MFU, peak and the flash counters, 24 x 8 each) printed beside 13a's.
   (14b) the bf16 state split by ``models.split_state_dict`` into mp = 2
   and mp = 4 rank shards on the card and merged back bit-equal, each
   rank's qkv shard (first and last layer) holding exactly its heads' q, k
   and v columns, and the ranks' bytes summing to the logical bytes plus
   the replicated ones once more a rank. (14c) ``ulysses_attention`` over
   the one-rank sp group at ``ULYSSES_SHAPE`` (B=1, T=8192, H=16, D=64,
   causal, bf16), forward and backward, bit-equal to
   ``flash_attention_array``'s own call, within the flash tolerances of
   the f32 plain form, and launching each flash kernel once;
   ``ring_attention`` over it at ``RING_SHAPE`` (GPT's training shape)
   against the flash forward within ``RING_REL_TOL`` by relative norm,
   with both timed by CUDA events, and its own backward's dQ, dK and dV
   against the f32 plain form within the flash gradient tolerances, the
   forward and backward of ring and flash timed. One
   ``{"fleet_train": ...}`` line; the
   flash rows of the ``kernels`` line carry 14a's launches as
   ``launches_fleet`` and 14c's as ``launches_ulysses``;
15. fleet, part 2 (runs after phase 14, on its NCCL group of one rank):
   (15b) ``group_sharded_parallel(level="p_g_os")`` (ZeRO-3) over the
   one-rank sharding group on phase 14's model, batch and start through
   the engine (``dp_axes=()``): 3 steps bit-equal to 13a's engine. (15a)
   GPT-3 1.3B at full width and depth as a one-stage ``PipelineLayer``
   (the embedding and the tied head one ``SharedLayerDesc`` key, the head
   through its ``forward_func``; 24 decoder layers; the final LayerNorm;
   the f32 cross-entropy as ``loss_fn``) on b4 x s2048 in 4 micro-batches:
   ``PipelineTrainStep`` by 1F1B and by F-then-B and the engine at
   ``grad_accumulate=4``, 3 AdamW steps each from one start (parameters
   bit-equal to the engine's, else within ``PIPE_REL_TOL``), each one's
   peak (1F1B's below F-then-B's); then 2 warm-up and 8 timed 1F1B steps
   (step ms, tokens/s, MFU, flash launches 24 x 4 x 8 each). (15c)
   ``MoELayer(2048, 8192, 8 experts, top 2)`` in bf16 on 8192 tokens,
   forward and backward: the one-rank ep group bit-equal to the local
   path, the layer against the f32 plain per-expert loop on the card's
   own routing by relative norm (``MOE_REL_TOL``; the gate's gradient and
   the auxiliary loss ``MOE_GATE_REL_TOL``), the choices dropped at
   capacity, forward and backward ms by CUDA events. (15d)
   ``DGCMomentumOptimizer`` (sparsity 0.999) on GPT-3 1.3B for 3 eager
   steps: ``last_comm_fraction``, the optimizer step's ms beside plain
   Momentum's, and one layer's last update bit-equal to the CPU rule on
   the card's gradient; then ``LocalSGDOptimizer(k_steps=2)`` over SGD for
   4 steps bit-equal to plain SGD (the sync at world 1 is the identity).
   One ``{"fleet_part2": ...}`` line with the card's name and power
   limit; the flash rows of the ``kernels`` line carry 15a's timed
   launches as ``launches_pipeline``;
16. auto-parallel and the coordinated checkpoint (runs after phase 15, on
   its NCCL group of one rank): (16a) GPT-3 1.3B (24 layers, bf16, the f32
   CE of the tied head as the loss, AdamW) through
   ``distributed.auto_parallel.Engine``: ``auto_parallelize`` on 13a's
   batch derives ``replicated`` only (mp 1) and prints its measured report
   (FLOPs from ``FlopCounterMode`` plus the flash kernels' tally, the bytes
   the aten ops move, the collectives, the peak, the score); 3 steps
   through ``fit`` from 13a's start must give 13a's engine's losses and
   parameters bit for bit; then 2 warm-up and 8 timed steps (step ms,
   tokens/s, MFU against 989 TFLOP/s, flash launches 24 x 8 each), and
   ``shard_tensor``/``reshard`` of a card tensor at world 1 must give its
   bits back. (16b) ``CoordinatedCheckpoint(async_save=True)`` over the
   ``TCPStore`` adapter on 16a's ``engine_state_dict`` (bf16 weights and
   both AdamW moments): the save after step k is waited on after steps k+1
   and k+2 ran; a fresh engine restored by ``resume`` runs the same two
   steps bit for bit; the bytes, the host-blocked ms, the write's and the
   restore's seconds are printed; one byte flipped in a leaf file must make
   ``load_state_dict`` raise ``CheckpointError`` naming its key. (16c)
   ``StabilitySentinel.from_flags`` with ``FLAGS_stability_ckpt_dir`` (its
   ``AutoCheckpoint`` anchor, every 2 steps) and ``for_engine`` on GPT at
   full width and ``ANCHOR_LAYERS`` layers (the depth cut only for the
   anchors' disk and time): a ``loss.spike`` on batch 6 (through a float
   loss weight the batch carries) must roll back to anchor 4, and the
   replayed step 5 must equal the first step 5, loss and parameters, bit
   for bit. (16d) ``launch(this script --launch-worker, nproc_per_node=1,
   elastic=True)`` with ``PADDLE_FAULT_INJECT=preempt.sigterm:step=3``:
   the worker (NCCL, GPT at full width and ``ANCHOR_LAYERS`` layers,
   ``AutoCheckpoint`` and ``PreemptionGuard``) drains with a
   ``preempt_drain`` progress record and exits 75, the launcher relaunches
   it, it resumes step 3, and its losses must equal an uninterrupted run's
   (in this process) bit for bit; the seconds from the drain to the
   resumed step are printed. Everything is written under a temporary
   directory the phase removes. One ``{"auto_parallel_ckpt": ...}`` line
   with the card's name and power limit and the phase's wall seconds; the
   flash rows of the ``kernels`` line carry 16a's timed launches as
   ``launches_auto``;
17. tensor-parallel serving and the native host runtime (runs after
   phase 16 on phase 3's models, built again; 17e inside phase 12): (17a)
   GPT-3 1.3B through
   ``serving.Engine(tp=2, device=("cuda:0", "cuda:0"))`` (both shards on
   the one card) with the paged kernel over drive (a)'s 32 requests, then
   drive (e)'s prefix-plus-chunk mix, each wave queued before its first
   step and each beside a one-device engine's run of the same waves: tok/s,
   mean decode-step ms, the share of greedy tokens equal to tp = 1's, the
   max abs difference of the first step's and of one decode step's
   logits; the paged kernel must launch once a layer a shard a decode step
   (at KV = 8 heads, with the unsharded shape's cluster size), and the tp
   engine's decode step through the kernels is held against its plain path
   within ``LOGITS_REL_TOL``; every sharded product of layer 0, the head
   and the paged kernel over the shards' heads are compared bit for bit
   with the one-device ops on the card, and a token mismatch with every op
   bit-equal fails; the kernel at the shard shape against its plain
   version (``TOL``, ``PAGED_O_REL_TOL``), timed beside its bound; one
   decode step's gather bytes against ``tp_collective_bytes``. (17b)
   Llama-7B at full width and ``TP_LLAMA_LAYERS`` = 4 layers (cut from 32
   to hold the whole script near 1000 s) the same on the first 8 of drive
   (c)'s prompts, with the peak memory. (17c) the int8 wire (``tp_int8``) on (a)'s requests: every
   stream complete, the token agreement, a decode step's wire bytes equal
   to ``tp_collective_bytes``' int8 figure. (17d) drive (i)'s
   observability tax while a host ``Profiler`` records, so every span goes
   to the native span ring (``core/csrc/trace.cc``), which must hold the
   decode steps. (17e) phase 12a's loop for 4 more steps fed by a
   thread-worker ``DataLoader`` over ``NativeQueue`` (``core/csrc/
   queue.cc``), whose epoch of batches must equal the serial loader's
   order; the host ms waiting are printed. The card's memory (allocated,
   reserved, in use) is read before and after each model's part and at
   the end. One ``{"tp_native": ...}``
   line; the paged row of the ``kernels`` line carries the tp drives'
   launches as ``launches_tp`` and the shard shape's times as
   ``tp_shard_shape``;
18. the op surface (runs after phase 17, on GPT-3 1.3B built again at full
   width and depth, bf16, seed 0): (18a) every op of
   ``ops.registry.all_ops()`` that ``ops/sweep.py`` feeds (the spec
   table's sampler, its case list), on the card in f32 against the same
   function on the CPU (rtol 1e-4, atol 1e-5; 1e-3 for the special
   functions; integers and bools exactly; complex by absolute error), its
   backward the same way, and in bf16 with finite outputs where the f32
   ones are: 0 mismatches; the factorizations whose factors are not
   unique are held in 18c; (18b) ``cost_model.get_static_op_time`` for
   every one-input op at (4096, 2048) in bf16 and f32, forward and
   forward + backward, each beside its bytes bound at 3.35 TB/s (the
   table's size, median and ten farthest ops; an op that takes more
   inputs, or raises at that shape, is listed by name); (18c) layer 0's
   attention output weight W (2048²) and A = WᵀW/2048 + I through
   ``qr``, ``svd``, ``pinv``, ``matrix_rank``, ``norm``, ``cond``,
   ``eigh``, ``cholesky``, ``cholesky_solve``, ``solve``, ``inv``,
   ``det``, ``slogdet``, ``lu``, ``lstsq`` and ``triangular_solve``, each
   by its identity (relative residual <= 1e-4) and against the CPU in
   f64 (10 x cond x float32's epsilon; det 10 x n x epsilon); (18d) 8
   clips of 30 s at 16 kHz through ``signal.stft`` (n_fft 400, hop 160,
   Hann) and ``istft`` back, ``rfft``/``irfft`` and ``fft2``/``ifft2``:
   round trips and the CPU within 1e-5 relative; (18e) the model's
   b2 x s2048 logits (f32) through ``Categorical`` (entropy, log_prob,
   samples from a CUDA generator by their frequencies and mean
   log-probability), its hidden states under ragged lengths through
   ``logsumexp``, ``sequence_softmax`` and ``sequence_pool``, the argmax
   against the shifted tokens through ``precision_recall``, ``mean_iou``
   and ``auc``, two greedy 64-token continuations through
   ``edit_distance`` (each against the port's CPU run on the same
   tensors, 1e-4), and a greedy 8-step ``while_loop`` against a plain
   loop; (18f) layer 0's FFN up-projection (2048 x 8192) pruned to its
   top 5%, as COO and CSR: ``sparse.matmul`` with 4096 activation rows,
   ``masked_matmul`` under a causal 2048² mask, ``add``, ``multiply``,
   ``softmax`` and the unary ops against their dense forms (1e-5). One
   ``{"op_surface": ...}`` line with the card, each part's counts, errors
   and seconds;
19. the ``nn`` layer library (runs after phase 18; ``--phase19`` alone),
   f32: (19a) the Transformer base (6 + 6 layers, d 512, 8 heads, FFN
   2048, dropout 0.1, post-norm) with one 37000-token embedding shared by
   source, target and output projection, sinusoidal positions; step 1 on
   4 pairs with dropout off against the CPU (loss 1e-5, every gradient
   together 1e-4 by relative norm), 10 Adam (0.9, 0.98, 1e-9) steps under
   NoamDecay(512, 4000) on b32 x s128 synthetic pairs, a label-smoothed
   (0.1) soft-label cross entropy (the loss must be finite and fall), then
   greedy incremental decoding of 32 tokens for 8 sources through
   ``gen_cache`` against full recomputation at every step (tokens equal,
   logits 1e-4); (19b) ResNet-50's stem and conv2_x (7x7/2 conv, BN,
   ReLU, 3x3/2 max pool, three bottlenecks 64-64-256, average pool, a
   1000-way head) at b32 x 224²: NHWC from the same weights against NCHW,
   one Momentum(0.1, 0.9, wd 1e-4) step whose first BN moves by Paddle's
   momentum rule, eval, the same step on 4 images against the CPU
   (outputs, gradients, every BN buffer, 1e-4), ms a step; (19c) the
   medium PTB LSTM (vocab 10000, 2 x 650, 35 steps, batch 20, dropout 0.5
   outside the LSTM), ``nn.GRU`` at that width and one
   ``BiRNN(LSTMCell, LSTMCell)``: two truncated-BPTT batches, SGD(1.0),
   global-norm clip 5, states carried and detached, with dropout off
   against the CPU (losses, gradients, final states, 1e-4), ms a step;
   (19d) on 19b's stage activations GroupNorm(32), InstanceNorm2D,
   LocalResponseNorm, Conv2DTranspose 2x, ``interpolate`` in every 2-D
   mode down and up, Pixel(Un)Shuffle, ``grid_sample`` on an
   ``affine_grid``, Unfold/Fold, ``max_pool2d(return_mask)`` then
   ``max_unpool2d``; ``ctc_loss`` and its gradient on 19c's logits;
   ``sparse_attention`` under a banded CSR pattern on 19a's memory: each
   against the CPU on the first 4 rows (1e-5). One ``{"nn": ...}`` line;
   19b's step on 4 images also runs on the CPU in float64 (C1's arbiter),
   and again on the card and the CPU on the float64 run's ReLU branches
   (``_Branches``; gradients 1e-4);
20. hapi and vision (runs after phase 19; ``--phase20`` alone), f32:
   (20a) ResNet-50 (1000 classes) trained through ``Model.fit`` at b32 x
   224² (Momentum 0.1, 0.9, L2 1e-4, ``CrossEntropyLoss``,
   ``Accuracy(topk=(1, 5))``; synthetic images through
   ``vision.transforms.Normalize`` and the ``DataLoader``), 2 warm-up + 8
   timed steps, beside the same network's hand loop from the same weights
   over the same batches: with cuDNN deterministic the losses and the
   final state must be bit-equal; ms a step, images/s, the host ms
   ``Model`` adds, peak; ``flops()`` equal to the layer shapes' count; one
   step on 4 images on the card, on the CPU, on the CPU in float64, and on
   the card and the CPU on the float64 run's ReLU branches (logits, loss,
   buffers 1e-4; the gradients on those branches 1e-3); (20b) ``evaluate``
   and ``predict`` over 256 images, ``Accuracy`` and, on a binary score,
   ``Precision``, ``Recall`` and ``Auc`` on the card equal to the CPU's
   accumulation, one host read an update; (20c) ``fit`` with the stability
   sentinel on a small dropout network: a ``loss.spike`` rolled back, the
   parameters bit-equal to a run that never saw the batch; (20d)
   YOLOv3-DarkNet53 (80 classes): one image in eval mode against the CPU
   (heads and loss 1e-4, every gradient on the CPU's leaky-ReLU branches
   1e-4, the detections' scores 1e-3 and 95% of their rows), then b8 x
   416² steps of the three scales' ``yolov3_loss`` on synthetic boxes
   (ms) and ``YOLOv3Postprocess``; (20e) ``roi_align`` (512 RoIs on a 256
   x 200 x 272 level), ``nms`` over 1000 boxes and a 3 x 3
   ``deform_conv2d`` on 64 x 128 x 128 against the CPU (1e-5, ``nms``'
   indices equal), and the 12 other families at full width (224², 299²
   for InceptionV3, 1 x 28² for LeNet): one image in eval mode against the
   CPU (logits, and gradients on the CPU's branches, 1e-4), then a step at
   batch 8. One ``{"hapi_vision": ...}`` line;
21. export and deployment (runs after phase 20; ``--phase21`` alone):
   (21a) GPT-3 1.3B bf16 at full width and depth through ``jit.save`` with
   ``InputSpec([None, 2048], "int64")``: the saved ``torch.export``
   program must hold 24 ``paddle_tpu_torch::flash_attention_fwd`` nodes
   and a symbolic batch; an ``inference`` Predictor on the card at B = 2
   (the ids shared without a copy) and at B = 1: logits against the eager
   model's (relative norm, bit equality reported), 24 flash forward
   launches a run, ms a run beside the eager forward's, save and load
   seconds, the artifact's bytes; (21b) ``static.load_program`` on that
   artifact, cross-entropy appended, 3 plain-SGD ``train_step``s at B = 1,
   T = 2048 against the eager model's 3 steps on the same weights and
   batch (bit-equal on the card, each step's loss drop within 1e-2 of
   eager's), 24 launches of each flash kernel a step; (21c) ResNet-50 f32 at
   b8 x 224² (cuDNN deterministic) through ``save_inference_model``, then
   the port's C API through ctypes (create, set input, run, get output:
   within 1e-5 of eager), 4 cloned Predictors on 4 threads, and the
   ``capi_demo`` host as a subprocess; (21d) a ``to_static`` function
   with a tensor ``while`` and ``if``: its export holds ``while_loop``
   and ``cond``, and the program, saved and loaded on the card, gives
   eager's outputs at both branches; (21e) a tiny GPT with
   ``attention_impl="flash"`` saved on the card and run by a
   ``Config.disable_gpu()`` Predictor (no launch) against the card's
   logits (1e-4). One ``{"export": ...}`` line; the flash rows of
   ``kernels`` get ``launches_export`` and ``launches_trainable``;
22. quantization and incubate (runs after phase 21; ``--phase22`` alone):
   (22a) GPT-3 1.3B bf16 at full width and depth, b2 x s2048: 5 timed
   unquantized ``compile_train_step`` steps after 3, then its 96 mp linears wrapped
   by ``ImperativeQuantAware``, 5 compiled AdamW steps (every moving
   average must stay untouched) and 2 eager steps (the moving averages
   move), every weight a forward reads on its abs-max int8 grid (a
   pre-hook, exact), 24 launches of each flash kernel a step, the losses
   finite and falling, 5 timed quantized steps (phase 5's step beside, in
   the whole script); a 2-layer copy at full
   width, card against the CPU at 3 data seeds: the loss (2e-4 relative),
   every gradient by relative norm (0.12) and the quantizers' level flips
   (weights: none); (22b) ResNet-50 f32 at
   b32 x 224²: PTQ (abs_max) over 4 batches, ``convert_to_int8_inference``
   (53 ``Int8Conv2D``, 1 ``Int8Linear``), the float and int8 artifacts
   through ``save_inference_model`` with a None batch, the int8 one
   through the Predictor and the C API against the eager int8 model (1e-6
   of the largest logit; bit equality reported), the drift from the PTQ
   model within 0.12, ``.pdiparams`` at most 0.3 of the float one's, ms a
   batch; an int8 net with ResNet-50's stem saved on the CPU, run by the
   card's Predictor at batches 3 and 40 against the CPU (1e-6); (22c) the host embedding at 5,242,880 x 1024 f32 (20 GiB) in a
   sparse memmap, 65536 rows cached on the card, ``prefetch_iter`` and the
   async push: 30 steps of 4 Zipf(1.2) micro-batches of 16 x 64 into a
   Linear head, every forward a prefetch hit, the loss falling, under 1
   GiB physical, and the touched rows bit-equal to a replay on the numpy
   path with no cache and no thread; (22d) ERNIE-3.0 base f32,
   ``DistributedFusedLamb`` against ``Lamb``, 5 steps, losses within
   1e-5, the optimizer step's ms; (22e) the fused softmaxes,
   ``graph_send_recv`` (4 pools), ``ResNetUnit`` and the three fused
   layers card against the CPU (1e-4 of the largest value), ASP 2:4 on
   ERNIE's linears after 3 decorated SGD steps, a custom op's vjp,
   LookAhead's first sync and state round trip, ModelAverage's apply and
   restore. One ``{"quant_incubate": ...}`` line; the flash rows of
   ``kernels`` get ``launches_qat``, 22a's totals over the compiled and
   over the eager steps, each exactly 24 a step;
23. text and the data modules (runs after phase 22; ``--phase23`` alone),
   on ERNIE-3.0 base (vocab 40000, hidden 768, 12 layers, f32, seed 0):
   (23a) a synthetic 40000-line WordPiece vocab (seed 0) and 64 documents
   of 200-2000 characters (seed 1; upper case, accents, CJK, punctuation,
   controls, and in 8 known ones the Unicode spaces U+3000, U+2003,
   U+00A0 and U+0085) through ``text.FasterTokenizer`` (native, on the
   port's ``tokenizer.cc``) as 64 pairs to (64, 512): the native ids must
   equal the Python twin's on the other 56 documents, differ on exactly
   those 8, and follow the C++ split rule (space only) on all 64; the
   encoder and a 768 -> 27 tag head give (64, 512, 27) emissions, decoded
   by ``text.viterbi_decode`` on the card with (29, 29) transitions (BOS
   and EOS last) and the non-pad lengths, against the same decode on the
   CPU (paths equal, scores within ``TEXT_SCORE_RTOL``); the tokenizer's
   host ms and tokens/s, the forward's and the decode's ms (CUDA events)
   and the decode's device ops a call; (23b) under ``FLAGS_thread_checks``,
   ``dataset.imdb.train()`` -> ``reader.shuffle(buf_size=512)`` (after
   ``random.seed(0)``) -> ``reader.xmap_readers`` (pad to 160, 4 threads,
   in order) -> ``batch(32, drop_last=True)``: 16 AdamW (5e-5) steps of the
   encoder with a 2-class head on its pooled output, losses finite; then 4
   steps through ``io.DataLoader(text.Imdb)`` -> ``DevicePrefetcher``,
   whose second consumer thread must raise ``OwnershipError``; (23c)
   ``utils.dlpack`` both ways on a card tensor (one buffer, writes seen
   through each view), ``device``'s counts and ``synchronize``,
   ``hub.load`` of ResNet-50 from a temporary ``hubconf.py`` bit-equal to
   the same model built directly, ``onnx.export`` of 23b's classifier
   through ``jit.load`` bit-equal to eager, ``format="onnx"`` raising;
   (23d) ``analysis.run_all()`` over the port: no finding. One
   ``{"text_data": ...}`` line; no kernel runs on this path;
6. kernel registry, under ``$FLAGS_kernel_tune_dir`` when the caller sets
   it (it must be empty; the DB is kept there) or a fresh temporary one:
   phases 3 and 5 ran with ``FLAGS_kernel_autotune=off``, so no
   ``kernel_tune*`` counter may have moved and the dir must be empty; then
   ``search`` at each of ``tune_keys`` (the paged kernel at GPT's and
   Llama's KV heads, the int8 head at GPT's and Llama's shapes, the flash
   kernels and the fused CE at the training shape; budget
   ``TUNE_BUDGET_S``, ``TUNE_SAMPLES`` samples): one search each, zero
   candidate errors and verify failures, the winner persisted, a line each
   with the winner, default and best ms, candidates tried and cost drift
   (a winner that is not the default timed again beside it by CUDA
   events);
   ``ondemand`` after ``autotune.clear_cache()`` must resolve every winner
   from the DB (one hit each, no search); drive (a)'s setting, its wave
   queued before the first admission, runs off then ``ondemand`` on the
   tuned DB (the share of equal outputs is reported, and must be 1.0 when
   every winner is the default); the wrappers' host µs a call with the
   config resolved (off) against named;
4. timing: each kernel (CUDA events) beside its plain version, the card's
   least time for the same work, and a one-call PyTorch yardstick where
   one exists; the flash kernels also with their TFLOP/s and the host time
   of one call, at the training shape and at the long-sequence shape; the
   paged kernel at the four ``PAGED_SHAPES`` (Llama's decode shape among
   them); the int8 head at M = 1, 4, 32 and 160 beside the dense bf16 head
   (``dense_bf16_ms``), GPT's in both layouts and Llama's in (K, N)
   (``llama_head``).

The last three lines of stdout are the card's name and power limit
(``nvidia-smi``), the ``{"kernels": [...]}`` JSON line (each row also with
its resolved ``config`` and the search's ``tuned`` winners) and
``{"ok": true, "device": {...}}``; the lines before them are
``{"device_timeline": {...}}``, each kernel's launches, µs a launch and
ms a step in the profiled windows (printed beside its CUDA-event time),
``{"flash_long_shape": [...]}``, the flash kernels' times at the
long-sequence shape (no launches on the main path),
``{"flash_llama_shape": [...]}``, their times at Llama-7B's training shape
with phase 8's launches, ``{"flash_pipeline_shape": [...]}``, their times
at 15a's micro-batch (B = 1) with its launches, ``{"train_models": {...}}``, phases 8 and 9,
``{"runtime_train": {...}}``, phase 12 (printed at its end),
``{"generate": {...}}``, phase 10, ``{"naninf": {...}}``, phase 11,
``{"paged_shapes": [...]}``, the paged kernel's time, bound and cluster
size at each of ``PAGED_SHAPES``, and ``{"engine_drives": [...]}``, each
engine drive's tok/s, decode steps, mean decode-step ms, launches and
logits errors, with (e)'s prefix hits, shared blocks, tail prefills and
chunk steps, (f)'s drafts proposed and accepted, and (g)'s and (h)'s
sub-drives with their adopt info, ``{"registry": {...}}``, phase 6's
searches, persistence, tuned drive, host µs and the 192-row int8 checks,
``{"engine_train": {...}}``, phase 13, ``{"fleet_train": {...}}``,
phase 14, ``{"fleet_part2": {...}}``, phase 15, and
``{"auto_parallel_ckpt": {...}}``, phase 16, ``{"tp_native": {...}}``,
phase 17, ``{"op_surface": {...}}``, phase 18, ``{"nn": {...}}``,
phase 19, ``{"hapi_vision": {...}}``, phase 20,
``{"export": {...}}``, phase 21, ``{"quant_incubate": {...}}``, phase
22, and ``{"text_data": {...}}``, phase 23 (the card, 23a's counts, ms,
tokens/s and worst score, 23b's step ms and losses, 23c's equalities
and export seconds, 23d's seconds and baseline size, and the phase's
seconds).
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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
# bf16 flash O, dQ, dK and dV against the bf16 plain versions on the same
# inputs (``flash_attention_plain`` and ``flash_attention_bwd_plain``, which
# round P and dS to bf16 where the reference's kernels do), the same norm:
# what is left is the kernels' ex2.approx and their summation order
# (measured up to 1.9e-3); a rounding point off the reference's reads more
# (dS rounded before dK's scale, D = 128: 3.1e-3 to 3.3e-3)
FLASH_BF16_PLAIN_REL_TOL = 2.5e-3
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
# drive (e), GPT-3 1.3B: the prefix cache and chunked prefill on the paged
# kernel; its prompts share one PREFIX_LEN-token prefix (a system prompt, 32
# blocks), then a tail of TAIL_LENS tokens each, from PREFIX_SEED
PREFIX_KW = {"prefix_cache": True, "prefill_chunk": 256}
PREFIX_LEN, TAIL_LENS, PREFIX_SEED = 512, (64, 512), 1
# the wave-2 prompts whose tail and chunked prefill logits (e) holds to the
# monolithic prefill's
PREFILL_CHECKS = 4
# drive (f), GPT-3 1.3B: speculative decoding, SPEC_K drafts a row by the
# n-gram drafter, int8 weights with the int8 head kernel; then once with a
# WINDOW_DRAFTER_LAYERS-layer GPT at 1.3B's width as the model drafter over
# WINDOW_REQUESTS requests
SPEC_K = 4
WINDOW_DRAFTER_LAYERS, WINDOW_REQUESTS = 2, 4
# the verify check's rows: one engine state, the verify step's logits at each
# j = 0..SPEC_K against j+1 sequential decode steps fed the same tokens
SPEC_CHECK_ROWS = 8
# drives (g), GPT-3 1.3B, and (h), Llama-7B: serving-state durability and
# resilience on the paged kernel, over the drive prompts of (a) and (c). Every
# sub-drive arms FIRST_STEP_WAITS with its own chaos point: the first step
# that has work sleeps before it admits, so all the requests are queued
# before the first admission and every sub-drive admits them alike
FIRST_STEP_WAITS = "serve.slow_step:at=1,ms=500"
# g1 and h1: the handoff after this many decode steps; g2: the crash (the
# replacement engine counts its steps from 0, so it fires once); g4: the
# synthesized out-of-memory at the serving step
HANDOFF_AFTER_STEPS = 16
CRASH_STEP = 24
CRASH_SPEC = f"serve.crash:step={CRASH_STEP},times=1"
OOM_SPEC = "hbm.oom:op=serve.step,at=8"
# g5: the shed policy, a supervisor's watchdog for g2, and g5's drain wave
SHED_KW = {"max_queue": 8, "shed": True}
SUPERVISOR_WATCHDOG_S = 2.0
DRAIN_REQUESTS = 8
# observability: drive (i) serves (a)'s wave traced, with the telemetry
# endpoint; the tax runs TAX_PAIRS alternating pairs of trace-off/trace-on
# waves of TAX_NEW tokens; each device timeline covers TIMELINE_STEPS decode
# steps (B = 32, contexts ~640) or one train step. Flight dumps land under
# FLIGHT_DIR: $PADDLE_TPU_FLIGHT_DIR when the caller sets it (and keeps the
# dumps), else a temporary directory removed at exit (main sets it)
TAX_PAIRS, TAX_NEW = 6, 16
TIMELINE_STEPS = 8
FLIGHT_DIR = None
SLO_FAMILIES = ("paddle_tpu_serve_ttft_seconds",
                "paddle_tpu_serve_inter_token_seconds",
                "paddle_tpu_serve_e2e_seconds",
                "paddle_tpu_serve_queue_seconds")
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
# LLAMA_HEAD in (K, N)): one stream, the prefill width, the full decode
# batch, and the full batch's speculative verify (32 rows of SPEC_K + 1)
INT8_TIMING_ROWS = (1, 4, 32, 160)
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
# 15a's micro-batch: GPT-3 1.3B's training shape at B = 1
FLASH_PIPE = (1, 2048, 2048, 16, 128, True)
# Llama-7B's training batch and its flash shape (B, T, T_kv, H, D, causal)
LLAMA_TRAIN_B, LLAMA_TRAIN_T = 1, 2048
LLAMA_GRAD_LAYERS = 2  # the full-width model of the kernels-vs-plain check
FLASH_LLAMA = (LLAMA_TRAIN_B, LLAMA_TRAIN_T, LLAMA_TRAIN_T, 32, 128, True)
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
# the kernel registry phase: a search at each shape of the main path in the
# kernel table (``tune_keys``), each with this budget and these timing
# samples; the wrapper's host time per call with the config resolved (off)
# against the config named, over HOST_US_CHUNKS runs of interleaved calls
TUNE_BUDGET_S, TUNE_SAMPLES = 20.0, 5
HOST_US_CHUNKS = 8
# the registry kernel each row of the kernels line launches under
REGISTRY_NAME = {"paged_attention_rows": "paged_attention",
                 "int8_matmul": "int8_matmul",
                 **dict.fromkeys(FLASH_KERNELS, "flash_attention")}


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


def within(name, dtype, out, ref, note=""):
    """(elements outside ``TOL[(name, dtype)]``, max abs error) of ``out``
    against ``ref``; fails on another shape or a non-finite output."""
    atol, rtol = TOL[(name, dtype)]
    out, ref = out.detach().float(), ref.detach().float()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{name} {dtype}{note}: shape {tuple(out.shape)} vs "
             f"{tuple(ref.shape)} or non-finite output")
    err = (out - ref).abs()
    return int((err > atol + rtol * ref.abs()).sum()), float(err.max())


def compare(name, dtype, out, ref, note=""):
    atol, rtol = TOL[(name, dtype)]
    bad, max_err = within(name, dtype, out, ref, note)
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
    with: their decode buckets, their prefill width, and each bucket's
    speculative verify, ``bucket * (SPEC_K + 1)`` rows (drive (f))."""
    rows = set()
    for _, cfg, _, _ in engine_models():
        ec = engine_config(cfg)
        rows |= set(ec.decode_buckets) | {ec.prefill_batch}
        rows |= {b * (SPEC_K + 1) for b in ec.decode_buckets}
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
    from paddle_tpu_torch.ops.kernels import paged_attention as P

    return P.rule_split(B, KV, BS, MB, torch.cuda.current_device())


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


def paged_split_configs(shape, split, dtype, args, ref, out, seen):
    """Every other cluster size of the registry's ``split`` axis that is
    valid at this shape, launched as an explicit config on the same inputs:
    each held to the plain version with the default's tolerances (and, in
    bf16, ``PAGED_O_REL_TOL``), and the one equal to the rule's size bit for
    bit equal to the default launch. ``seen``: split -> [shapes, max abs
    error], updated."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.paged_attention import _split_valid

    rep, B, MB, KV = shape
    for sp in K.get_kernel("paged_attention").space["split"][1:]:
        if not _split_valid(sp, 16, MB):
            continue
        got = K.paged_attention_rows(*args, config={"split": sp})
        torch.cuda.synchronize()
        note = f" at B={B} MB={MB} KV={KV} rep={rep} split={sp}"
        bad, err = within("paged_attention_rows", dtype, got, ref, note)
        rel = rel_err(got, ref)
        if bad or (dtype == torch.bfloat16 and not rel <= PAGED_O_REL_TOL):
            fail(f"paged_attention_rows {dtype}{note}: {bad} elements outside "
                 f"tolerance, max abs {err:.3e}, rel_norm_err {rel:.3e}")
        if sp == split and not torch.equal(got, out):
            fail(f"paged_attention_rows {dtype}{note}: the rule's cluster "
                 "size named explicitly differs from the default launch")
        s = seen.setdefault(sp, [0, 0.0])
        s[0], s[1] = s[0] + 1, max(s[1], err)
        del got


def kernel_phase():
    from paddle_tpu_torch.ops import kernels as K

    shapes = paged_check_shapes()
    split = paged_split_check(shapes)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        seen = {}
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
            paged_split_configs((rep, B, MB, KV), split[(B, MB, KV)], dtype,
                                args, ref, out, seen)
            del args, q, kp, vp, out, ref
        by_size = {k: [n, round(e, 6)] for k, (n, e) in sorted(seen.items())}
        print(f"  paged_attention_rows {str(dtype)[6:]}, every explicit "
              "cluster size of the registry's split axis where valid (>= 64 "
              f"positions a block), [shapes, max_abs_err] by size: {by_size} "
              "ok")
        if set(seen) != {1, 2, 4, 8}:
            fail(f"paged explicit splits ran {sorted(seen)}, not 1, 2, 4, 8")
        torch.cuda.empty_cache()
    errs.update(int8_phase())
    return errs


def int8_exact_rows(K):
    """The rows of ``int8_exact_check`` for a K-wide x: 32 one-hot picks k_m
    spread over K (the first and last column included), and 32 two-hot
    pairs (a_m, b_m) of distinct picks."""
    ks = np.round(np.linspace(0, K - 1, 32)).astype(np.int64)
    return ks, np.stack([ks, np.roll(ks, -11)], axis=1)


def int8_exact_check(qw, s, tw, dtype, block_n):
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
    cfg = {"block_n": block_n}
    bad1 = differ(K.int8_matmul(x1, qw, s, transpose_w=tw, config=cfg),
                  wd[ks])
    bad2 = differ(K.int8_matmul(x2, qw, s, transpose_w=tw, config=cfg), want2)
    sens = differ(folded, want2)
    n = 32 * wd.shape[1]
    ok = not bad1 and not bad2 and (sens or dtype != torch.bfloat16)
    print(f"  int8_matmul {str(dtype)[6:]} exact rows at K={Kd} "
          f"{'(N, K)' if tw else '(K, N)'} block_n={block_n}: one-hot "
          f"{n - bad1}/{n}, two-hot "
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
    through ``int8_exact_check``. The default launch resolves its config
    (384 weight rows a block); each check runs again with the registry's
    other ``block_n`` (192), held to the same tolerances and, since a
    column's sums do not depend on the block width, counted bit-equal to the
    default's or not. Returns the max abs errors at the decode batch
    (M = 32, (N, K)), and under ``"int8_widths"`` the 192-row checks: their
    count, how many were bit-equal, their max abs error."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_dequant

    widths = K.get_kernel("int8_matmul").space["block_n"]
    other = {"checks": 0, "bit_equal": 0, "max_abs_err": 0.0}
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
                    plain = K.int8_matmul_plain(x, qw, s, transpose_w=tw)
                    e = compare("int8_matmul", dtype, out, plain, note)
                    if dtype == torch.bfloat16 and not rel <= INT8_REL_TOL:
                        fail(f"int8_matmul bf16{note}: relative error {rel:.3e}")
                    if (M, Kd, N, tw) == (32, *INT8_HEAD, True):
                        errs[("int8_matmul", dtype)] = e
                    for bn in widths[1:]:
                        got = K.int8_matmul(x, qw, s, transpose_w=tw,
                                            config={"block_n": bn})
                        torch.cuda.synchronize()
                        wn = f"{note} block_n={bn}"
                        bad, err = within("int8_matmul", dtype, got, plain, wn)
                        rel = rel_err(got, x.float() @ wd)
                        if bad or (dtype == torch.bfloat16
                                   and not rel <= INT8_REL_TOL):
                            fail(f"int8_matmul {dtype}{wn}: {bad} elements "
                                 f"outside tolerance, rel_norm_err {rel:.3e}")
                        other["checks"] += 1
                        other["bit_equal"] += bool(torch.equal(got, out))
                        other["max_abs_err"] = max(other["max_abs_err"], err)
                        del got
                    del x, out, plain
                for bn in widths:
                    int8_exact_check(qw, s, tw, dtype, bn)
                del wd
            del qw
        del qw_nk
        torch.cuda.empty_cache()
    print(f"  int8_matmul block_n={widths[1:]}: {other['checks']} checks within "
          f"the plain version's tolerances (max_abs_err "
          f"{other['max_abs_err']:.3e}), {other['bit_equal']} of them bit for "
          f"bit equal to block_n={widths[0]}'s output ok")
    errs["int8_widths"] = other
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


def flash_check(B, T, Tk, H, D, causal, dtype, fused_qkv=False, qkv=None):
    """The three flash kernels against the plain version (f32, autograd for
    the gradients) on the same inputs, and in bf16 also against the bf16
    plain versions (the reference's rounding points) by relative norm; a
    second dQ and a second dK/dV launch on the same inputs must agree bit for
    bit. ``qkv``: q, k, v to use (a model's own) instead of random ones.
    Returns the max abs error per kernel (dkv: over dK and dV)."""
    from paddle_tpu_torch.ops import kernels as K

    q, k, v, do = flash_inputs(B, T, Tk, H, D, dtype, fused_qkv)
    if qkv is not None:
        q, k, v = qkv
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
    if dtype == torch.bfloat16:  # the plain versions in bf16 too
        bo, blse = K.flash_attention_plain(q, k, v, causal)
        bgrads = K.flash_attention_bwd_plain(q, k, v, do, bo, blse, causal)
    print(f"  flash B={B} T={T} T_kv={Tk} H={H} D={D} causal={causal} "
          f"{str(dtype)[6:]}{' (strided q/k/v views)' if fused_qkv else ''}"
          f"{' (layer 0 q/k/v of a model)' if qkv is not None else ''}:")
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
    if dtype == torch.bfloat16:
        rels = {n: rel_err(a, b) for n, a, b in zip(
            ("O", "dQ", "dK", "dV"), (o, dq, dk, dv), (bo, *bgrads))}
        ok = max(rels.values()) <= FLASH_BF16_PLAIN_REL_TOL
        print("  flash bf16 against the bf16 plain versions: rel_norm_err "
              + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
              + f" (tol rel {FLASH_BF16_PLAIN_REL_TOL}) "
              + ("ok" if ok else "MISMATCH"))
        if not ok:
            fail(f"flash bf16 against the bf16 plain versions: {rels}")
        del bo, blse, bgrads
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
    views, at the reference's long-sequence shape and at Llama-7B's training
    shape. Returns the max abs errors at those three shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    for shape in ((1, 192, 192, 2, 64, True), (1, 200, 200, 3, 128, True),
                  (1, 128, 328, 2, 64, False), (1, 96, 160, 1, 256, True),
                  (2, 130, 130, 2, 32, True), (1, 256, 256, 2, 40, True),
                  (1, 1000, 1000, 2, 128, True), (1, 136, 200, 2, 64, False),
                  (1, 136, 200, 2, 64, True), (1, 130, 130, 2, 128, True)):
        for dtype in (f32, bf16):
            flash_check(*shape, dtype)
    out = []
    for shape, fused in ((FLASH_TRAIN, True), (FLASH_LONG, False),
                         (FLASH_LLAMA, False)):
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
    # every cluster size of the registry's axis valid here, named explicitly
    row["ms_by_split"] = {
        sp: time_ms(lambda sp=sp: K.paged_attention_rows(
            q, kp, vp, tables, pos_t, config={"split": sp}))
        for sp in K.get_kernel("paged_attention").space["split"][1:]
        if MB * BS >= 64 * sp}
    if plain:
        row["plain_ms"] = time_ms(lambda: K.paged_attention_rows_plain(
            q, kp, vp, tables, pos_t), iters=5)
    del q, kp, vp
    torch.cuda.empty_cache()
    return row


def int8_head_times(Kd, N, layouts, block_n=None):
    """The bf16 int8 head at (K, N) = (Kd, N), stored in each of ``layouts``
    (``transpose_w``: True is (N, K), ``ms_by_m``; False is (K, N),
    ``kn_ms_by_m``), at every ``INT8_TIMING_ROWS``, beside
    ``dense_bf16_ms_by_m``: the same product on the weight dequantized to
    bf16 ahead of time and stored in ``layouts[0]``, what the head costs
    without int8, and the bytes bound of each row count (the int8 weight
    read once, x and the output once). ``block_n``: the kernel's weight rows
    a block as an explicit config (no dense row then); None resolves it."""
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_dequant

    dt, es = torch.bfloat16, 2
    cfg = None if block_n is None else {"block_n": block_n}
    qw, s = int8_weight(Kd, N, seed=1)
    out = {"shape": f"K={Kd} N={N} bf16"}
    for tw in layouts:
        w = qw if tw else qw.T.contiguous()
        times = out["ms_by_m" if tw else "kn_ms_by_m"] = {}
        for M in INT8_TIMING_ROWS:
            x = int8_x(M, Kd, dt, seed=1)
            times[M] = time_ms(lambda: K.int8_matmul(
                x, w, s, transpose_w=tw, config=cfg), iters=50)
        if tw == layouts[0] and block_n is None:
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
    # the registry's other block width, timed beside the default in this run
    times_192 = int8_head_times(Kd, N, INT8_LAYOUTS, block_n=192)
    llama_192 = int8_head_times(*LLAMA_HEAD, (False,), block_n=192)
    M = ENGINE_KW["max_batch"]  # the decode batch
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
        "block_n_192": {"ms_by_m": times_192["ms_by_m"],
                        "kn_ms_by_m": times_192["kn_ms_by_m"],
                        "llama_kn_ms_by_m": llama_192["kn_ms_by_m"]},
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
    rows += flash_timing(errs, launches, operators=True)
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


def flash_operator_host_us(q, k, v, do, o, lse, delta, causal):
    """Host µs a call of each flash kernel's raw ``ctypes`` launcher against
    its ``torch.library`` operator (dispatch, the registry's tile lookup
    for the forward, then the same launcher), interleaved call by call
    (``host_us_ab``); and of the backward as the main path runs it, the
    operator's registered autograd node under ``torch.autograd.grad``
    (delta, the dQ and dK/dV operators, the engine), against delta and the
    two launchers called directly. Returns {name: {"launcher_us",
    "operator_us"}} with the backward under "backward"."""
    from paddle_tpu_torch.ops import kernels as K

    ops = torch.ops.paddle_tpu_torch
    pairs = {
        "flash_attention_fwd": (
            lambda: K.flash_attention_fwd(q, k, v, causal),
            lambda: ops.flash_attention_fwd(q, k, v, causal, 0, 0)),
        "flash_attention_dq": (
            lambda: K.flash_attention_dq(q, k, v, do, lse, delta, causal),
            lambda: ops.flash_attention_dq(q, k, v, do, lse, delta, causal)),
        "flash_attention_dkv": (
            lambda: K.flash_attention_dkv(q, k, v, do, lse, delta, causal),
            lambda: ops.flash_attention_dkv(q, k, v, do, lse, delta,
                                            causal)),
    }
    out = {}
    for name, (raw, op) in pairs.items():
        r, o_us = host_us_ab(raw, op)
        out[name] = {"launcher_us": r, "operator_us": o_us}
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    og, _ = ops.flash_attention_fwd(qg, kg, vg, causal, 0, 0)

    def raw_bwd():
        d = flash_delta(do, o)
        K.flash_attention_dq(q, k, v, do, lse, d, causal)
        K.flash_attention_dkv(q, k, v, do, lse, d, causal)

    # ~10 launches a backward: 32 calls a chunk keep the queue short of full
    r, o_us = host_us_ab(
        raw_bwd, lambda: torch.autograd.grad(og, (qg, kg, vg), do,
                                             retain_graph=True),
        per_chunk=32)
    out["backward"] = {"launcher_us": r, "operator_us": o_us}
    del og, qg, kg, vg
    return out


def flash_timing(errs, launches, shape=FLASH_TRAIN, fused_qkv=True,
                 operators=False):
    """The three flash kernels at ``shape`` (bf16; at the training shape
    through strided q/k/v views as the model feeds them). Operations are the
    matmul FLOPs of the live (causal) score entries: 2 products forward, 3
    for dQ, 4 for dK/dV. The plain version's backward and the library's
    backward each compute dQ, dK and dV together; both backward rows carry
    that one time. With ``operators``, each row also carries the host µs
    through the kernel's ``torch.library`` operator beside its launcher's
    (``flash_operator_host_us``), the backward rows the registered
    backward's."""
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
    via_op = (flash_operator_host_us(q, k, v, do, o, lse, delta, causal)
              if operators else None)
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
            **({"host_us_operator": via_op[name],
                "host_us_backward": via_op["backward"]
                if name != "flash_attention_fwd" else None}
               if via_op else {}),
            "shape": f"B={B} T={T} H={H} D={D} causal={causal} bf16"
                     f"{', strided q/k/v views' if fused_qkv else ''}; "
                     f"library: torch scaled_dot_product_attention on "
                     f"(B, H, T, D){note}",
        })
    return rows


# -- engine phase ------------------------------------------------------------

def decode_step(eng, B=32, ctx=640):
    """The engine's own decode step at batch B and context ~ctx (its
    speculative verify, k + 1 tokens a row, on a speculative engine), to run
    on this thread with the engine idle (inside ``torch.inference_mode()``);
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
    k = eng._spec_k
    toks = np.arange(B * (k + 1), dtype=np.int32).reshape(B, k + 1)
    toks = dev(toks if k else toks[:, 0])
    temps = dev(np.zeros(B, np.float32))
    fn = eng._get_fn("spec" if k else "decode", B, mb)

    def step():
        out = fn(eng._params, eng._kpool, eng._vpool, tables, pos, toks,
                 temps, eng._gen)
        eng._kpool, eng._vpool = out[:2]
        return out[2].cpu()  # the engine reads the tokens back every step

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


def device_timeline(step, steps, label):
    """The device activity of ``steps`` calls of ``step`` under the port's
    ``profiler.Profiler(targets=[ProfilerTarget.GPU])`` (torch.profiler,
    CUPTI through Kineto): ``(start_ns, end_ns, name)``, time-ordered; fails
    on an empty timeline."""
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    with Profiler(targets=[ProfilerTarget.GPU]) as prof:
        for _ in range(steps):
            step()
    ev = [(e["start_ns"], e["end_ns"], e["name"])
          for e in prof.device_events()]
    if not ev:
        fail(f"{label}: the device timeline holds no activity")
    return ev


def timeline_kernels(ev, names, steps):
    """Launches, device ms per step and µs per launch of every kernel in
    the timeline ``ev`` whose name holds each of ``names``."""
    out = {}
    for want in names:
        durs = [b - a for a, b, n in ev if want in n]
        out[want] = {"launches": len(durs),
                     "ms_per_step": sum(durs) / 1e6 / steps,
                     "us_per_launch": (sum(durs) / 1e3 / len(durs)
                                       if durs else 0.0)}
    return out


def device_breakdown(step, steps, label, top=8, watch=()):
    """Run ``step`` ``steps`` times under the port's profiler with a device
    timeline and print the device busy share of the window, the kernels
    that take the most device time and, below them, any other kernel whose
    name holds one of ``watch``."""
    ev = device_timeline(step, steps, label)
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


def prefix_prompts(vocab_size):
    """Drive (e)'s prompts: one shared ``PREFIX_LEN``-token prefix, then a
    tail of ``TAIL_LENS`` random tokens each, from ``PREFIX_SEED``; the first
    is wave 1's, the other ``DRIVE_REQUESTS`` wave 2's."""
    rng = np.random.RandomState(PREFIX_SEED)
    prefix = rng.randint(0, vocab_size, size=PREFIX_LEN).tolist()
    lens = rng.randint(TAIL_LENS[0], TAIL_LENS[1] + 1, size=DRIVE_REQUESTS + 1)
    return [prefix + rng.randint(0, vocab_size, size=n).tolist() for n in lens]


def build_engine_model(name, cfg):
    """One of ``engine_models()`` in bf16 on the card, random weights from
    seed 0, in eval mode."""
    from paddle_tpu_torch.models import GPTForPretraining, LlamaForCausalLM

    cls = {"gpt3_1p3b": GPTForPretraining, "llama_7b": LlamaForCausalLM}[name]
    return cls(cfg, dtype=torch.bfloat16, seed=0).eval()


def well_formed(tag, prompts, outs, vocab_size):
    """Every output must be its prompt and ``DRIVE_NEW`` in-vocabulary
    tokens, or ``fail``."""
    for p, o in zip(prompts, outs):
        if len(o) != len(p) + DRIVE_NEW or o[:len(p)] != p \
                or not all(0 <= t < vocab_size for t in o):
            fail(f"engine ({tag}): output of {len(o)} tokens for a "
                 f"{len(p)}-token prompt")


def serve(eng, prompts, vocab_size, tag):
    """Greedy ``DRIVE_NEW`` tokens for each prompt, submitted at once; every
    output must be its prompt and ``DRIVE_NEW`` in-vocabulary tokens.
    Returns the outputs and the seconds until the card had finished."""
    t0 = time.monotonic()
    handles = [eng.submit(p, max_new_tokens=DRIVE_NEW) for p in prompts]
    outs = [h.result(timeout=900) for h in handles]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    well_formed(tag, prompts, outs, vocab_size)
    return outs, wall


def drain(eng, tag, cached=False):
    """The engine's stats once its pool holds only what the prefix index
    holds (nothing without one), or ``fail``."""
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["pages_used"] == st["pages_cached"]:
            break
        time.sleep(0.01)
    st = eng.stats()
    if st["pages_used"] != st["pages_cached"] or (st["pages_cached"] > 0) \
            != cached:
        fail(f"engine ({tag}): {st['pages_used']} pages used, "
             f"{st['pages_cached']} cached after the drive")
    return st


def counter_delta(c0):
    from paddle_tpu_torch import profiler

    c1 = profiler.counters()
    return {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}


def logits_rel(tag, what, got, want):
    """The largest ||got - want|| / ||want|| over the rows of two float32
    (rows, V) logits arrays, and their argmax agreement; fails when a row is
    beyond ``LOGITS_REL_TOL`` or a value is not finite."""
    if not (np.isfinite(got).all() and got.shape == want.shape):
        fail(f"engine ({tag}): {what} logits {got.shape} non-finite")
    rel = float((np.linalg.norm(got - want, axis=-1)
                 / np.linalg.norm(want, axis=-1)).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"  engine ({tag}): {what} logits rel_err={rel:.3e} "
          f"argmax_agree={agree:.3f} (tol rel {LOGITS_REL_TOL})")
    if not rel <= LOGITS_REL_TOL:
        fail(f"engine ({tag}): {what} logits rel_err {rel:.3e}")
    return rel, agree


def prefill_checks(eng, prompts, tag, head=None):
    """The tail-prefill (over ``head`` cached blocks) and last chunk's logits
    of each of ``prompts`` against the monolithic prefill's
    (``Engine._debug_prefill_paths``, chunks of ``PREFIX_KW``'s size), each
    within ``LOGITS_REL_TOL``."""
    mono, tail, chunk = eng._debug_prefill_paths(
        prompts, head=head, chunk=PREFIX_KW["prefill_chunk"])
    return {"tail_rel_err": logits_rel(tag, "tail-prefill vs monolithic",
                                       tail, mono)[0],
            "chunk_rel_err": logits_rel(tag, "last chunk vs monolithic",
                                        chunk, mono)[0]}


def verify_checks(eng, prompts, tag):
    """The speculative verify's logits at each j = 0..SPEC_K against j+1
    sequential decode steps fed the same tokens, over the first
    ``SPEC_CHECK_ROWS`` of ``prompts`` (``Engine._debug_spec_logits``), each
    within ``LOGITS_REL_TOL``."""
    ver, seq = eng._debug_spec_logits(prompts[:SPEC_CHECK_ROWS], SPEC_K)
    rel, agree = zip(*(logits_rel(tag, f"verify j={j} vs {j + 1} decode "
                                  "steps", ver[:, j], seq[:, j])
                       for j in range(SPEC_K + 1)))
    return {"verify_rel_err": rel, "verify_argmax_agree": agree}


def engine_drive(model, vocab_size, tag, int8, prompts, profile=False,
                 checks=False):
    """One drive: a fresh ``serving.Engine`` over ``model`` with the paged
    kernel (and, with ``int8``, int8 weights with the int8 head kernel)
    serves ``prompts`` greedily, ``DRIVE_NEW`` tokens each. Launch counts
    are zeroed just before the drive and read just after it; every output
    must be its prompt and ``DRIVE_NEW`` in-vocabulary tokens, the pool must
    drain, and one decode step built with the kernels must hold to the same
    step built with the plain versions within ``LOGITS_REL_TOL``; with
    ``checks``, the tail, chunk and verify builders too (``prefill_checks``
    on one prompt, ``verify_checks``). Returns the drive's row (launch
    counts, tok/s, decode steps and step ms)."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": int8})
    eng = Engine(model, **ENGINE_KW, int8=int8, seed=0)
    try:
        K.reset_launch_counts()
        outs, wall = serve(eng, prompts, vocab_size, tag)
        counts = K.launch_counts()
        st = drain(eng, tag)
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
        row = {"drive": tag, "int8": int8,
               "tok_s": len(outs) * DRIVE_NEW / wall,
               "wall_s": wall, "decode_steps": st["decode_steps"],
               "decode_step_ms_mean": st["decode_step_ms_mean"],
               "launches": {k: counts[k] for k in
                            ("paged_attention_rows", "int8_matmul")},
               "logits_rel_err": rel, "argmax_agree": agree,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  engine ({tag}) int8={int8}: {len(outs) * DRIVE_NEW} tokens "
              f"in {wall:.2f}s = {row['tok_s']:.1f} tok/s, "
              f"decode steps {st['decode_steps']}, mean decode step "
              f"{st['decode_step_ms_mean']:.2f} ms, launches {counts}; "
              f"kernel-vs-plain step logits rel_err={rel:.3e} "
              f"max_abs={float(np.abs(kl - pl).max()):.3e} "
              f"argmax_agree={agree:.3f} (tol rel {LOGITS_REL_TOL}); peak "
              f"memory {row['peak_gib']:.2f} GiB")
        if rel > LOGITS_REL_TOL:
            fail(f"engine ({tag}): kernel step logits rel_err {rel:.3e}")
        if checks:
            row["builder_checks"] = {**prefill_checks(eng, prompts[:1], tag),
                                     **verify_checks(eng, prompts, tag)}
    finally:
        eng.close()
    return row


def prefix_drive(model, vocab_size):
    """Drive (e): ``ENGINE_KW`` with ``PREFIX_KW`` (the prefix cache, chunks
    of 256 tokens) and the paged kernel over ``prefix_prompts``: wave 1 is
    one request run to its end, which fills the cache; wave 2 the other
    ``DRIVE_REQUESTS`` at once, each of which must hit the cache for the
    whole shared prefix (``PREFIX_LEN / block_size`` blocks). Launch counts
    and the engine's counters are read around wave 2. Checks as
    ``engine_drive``'s, with the pool holding only the index's blocks once
    drained and none after ``close()``; chunk steps and paged launches must
    happen; the tail and chunked prefill logits of ``PREFILL_CHECKS`` wave-2
    prompts (the tail over the cached prefix) within ``LOGITS_REL_TOL`` of
    the monolithic prefill's."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    tag, prompts = "e", prefix_prompts(vocab_size)
    head = PREFIX_LEN // ENGINE_KW["block_size"]
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    eng = Engine(model, **ENGINE_KW, **PREFIX_KW, int8=False, seed=0)
    try:
        serve(eng, prompts[:1], vocab_size, tag)
        st0 = drain(eng, tag, cached=True)
        K.reset_launch_counts()
        c0 = profiler.counters()
        outs, wall = serve(eng, prompts[1:], vocab_size, tag)
        counts = K.launch_counts()
        d = counter_delta(c0)
        st = drain(eng, tag, cached=True)
        steps = st["decode_steps"] - st0["decode_steps"]
        step_ms = (st["decode_step_ms_mean"] * st["decode_steps"]
                   - st0["decode_step_ms_mean"] * st0["decode_steps"]) / steps
        row = {"drive": tag, "int8": False,
               "tok_s": len(outs) * DRIVE_NEW / wall, "wall_s": wall,
               "decode_steps": steps, "decode_step_ms_mean": step_ms,
               "launches": {k: counts[k] for k in
                            ("paged_attention_rows", "int8_matmul")},
               "prefix_hits": d["serve_prefix_hits"],
               "prefix_misses": d["serve_prefix_misses"],
               "prefix_blocks_shared": d["serve_prefix_blocks_shared"],
               "tail_prefills": d["serve_tail_prefills"],
               "prefill_chunks": d["serve_prefill_chunks"],
               "pages_cached": st["pages_cached"],
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  engine ({tag}) prefix cache + chunks of "
              f"{PREFIX_KW['prefill_chunk']}: wave 2 {len(outs) * DRIVE_NEW} "
              f"tokens in {wall:.2f}s = {row['tok_s']:.1f} tok/s, decode "
              f"steps {steps}, mean decode step {step_ms:.2f} ms, prefix hits "
              f"{row['prefix_hits']} (misses {row['prefix_misses']}), blocks "
              f"shared {row['prefix_blocks_shared']}, tail prefills "
              f"{row['tail_prefills']}, chunk steps {row['prefill_chunks']}, "
              f"launches {counts}, {st['pages_cached']} pages cached; peak "
              f"memory {row['peak_gib']:.2f} GiB")
        if row["prefix_hits"] != len(outs) or row["prefix_blocks_shared"] \
                != len(outs) * head:
            fail(f"engine ({tag}): {row['prefix_hits']} prefix hits sharing "
                 f"{row['prefix_blocks_shared']} blocks, want {len(outs)} "
                 f"of {head} blocks each")
        if not row["prefill_chunks"] or not counts["paged_attention_rows"]:
            fail(f"engine ({tag}): {row['prefill_chunks']} chunk steps, "
                 f"launches {counts}")
        row.update(prefill_checks(eng, prompts[1:1 + PREFILL_CHECKS], tag,
                                  head=head))
    finally:
        eng.close()
    if eng.stats()["pages_used"] != 0:
        fail(f"engine ({tag}): {eng.stats()['pages_used']} pages used after "
             "close()")
    eng._pool.check()
    return row


def spec_drive(model, cfg, prompts, profile=False):
    """Drive (f): ``ENGINE_KW`` with ``spec_k=SPEC_K`` and the n-gram
    drafter, int8 weights with the int8 head kernel (the verify's head runs
    ``bucket * (SPEC_K + 1)`` rows), over the drive prompts of (a). Launch
    counts and the draft counters are read around the drive; outputs well
    formed, the pool drained, int8 launches and proposals must happen; the
    verify step's logits at each j held to j+1 sequential decode steps
    (``verify_checks``). Then a ``WINDOW_DRAFTER_LAYERS``-layer
    GPT at the target's width (random weights from seed 1) drafts for
    ``WINDOW_REQUESTS`` requests through ``build_window_draft``: outputs
    well formed, the pool drained."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    tag, vocab_size = "f", cfg.vocab_size
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": True})
    eng = Engine(model, **ENGINE_KW, int8=True, spec_k=SPEC_K, seed=0)
    try:
        K.reset_launch_counts()
        c0 = profiler.counters()
        outs, wall = serve(eng, prompts, vocab_size, tag)
        counts = K.launch_counts()
        d = counter_delta(c0)
        st = drain(eng, tag)
        prop, acc = d["serve_draft_proposed"], d["serve_draft_accepted"]
        row = {"drive": tag, "int8": True, "spec_k": SPEC_K,
               "tok_s": len(outs) * DRIVE_NEW / wall, "wall_s": wall,
               "decode_steps": st["decode_steps"],
               "decode_step_ms_mean": st["decode_step_ms_mean"],
               "launches": {k: counts[k] for k in
                            ("paged_attention_rows", "int8_matmul")},
               "drafts_proposed": prop, "drafts_accepted": acc,
               "acceptance": acc / prop if prop else None,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        print(f"  engine ({tag}) int8 + spec_k={SPEC_K} (n-gram): "
              f"{len(outs) * DRIVE_NEW} tokens in {wall:.2f}s = "
              f"{row['tok_s']:.1f} tok/s, decode steps {st['decode_steps']}, "
              f"mean decode step {st['decode_step_ms_mean']:.2f} ms, drafts "
              f"proposed {prop}, accepted {acc} (rate {row['acceptance']}), "
              f"launches {counts}; peak memory {row['peak_gib']:.2f} GiB")
        if not counts["int8_matmul"] or not prop:
            fail(f"engine ({tag}): launches {counts}, {prop} drafts proposed")
        if profile:
            decode_profile(eng, tag)
        row.update(verify_checks(eng, prompts, tag))
    finally:
        eng.close()
    drafter = GPTForPretraining(
        dataclasses.replace(cfg, num_layers=WINDOW_DRAFTER_LAYERS),
        dtype=torch.bfloat16, seed=1).eval()
    eng = Engine(model, **ENGINE_KW, int8=True, spec_k=SPEC_K,
                 drafter=drafter, seed=0)
    try:
        c0 = profiler.counters()
        outs, wall = serve(eng, prompts[:WINDOW_REQUESTS], vocab_size,
                           f"{tag}, window drafter")
        d = counter_delta(c0)
        st = drain(eng, f"{tag}, window drafter")
        row["window_drafter"] = {
            "layers": WINDOW_DRAFTER_LAYERS, "requests": len(outs),
            "tok_s": len(outs) * DRIVE_NEW / wall,
            "decode_steps": st["decode_steps"],
            "drafts_proposed": d["serve_draft_proposed"],
            "drafts_accepted": d["serve_draft_accepted"]}
        print(f"  engine ({tag}) window drafter ({WINDOW_DRAFTER_LAYERS} "
              f"layers, random weights): {row['window_drafter']}")
        if not d["serve_draft_proposed"]:
            fail(f"engine ({tag}): the window drafter proposed nothing")
    finally:
        eng.close()
    del drafter
    return row


class _Launches:
    """Paged-kernel launch counts zeroed just before each sub-drive of (g)
    and (h) and summed just after it; a sub-drive that decodes without a
    launch fails."""

    def __init__(self):
        self.total = {"paged_attention_rows": 0, "int8_matmul": 0}

    def __call__(self, tag, run):
        from paddle_tpu_torch.ops import kernels as K

        K.reset_launch_counts()
        out = run()
        counts = K.launch_counts()
        if not counts["paged_attention_rows"]:
            fail(f"engine ({tag}): kernel launches {counts}")
        for k in self.total:
            self.total[k] += counts[k]
        return out


def chaos_wave(submit, prompts, spec=None, **submit_kw):
    """Arm ``FIRST_STEP_WAITS`` (with ``spec`` joined to it by the grammar's
    ``;``) and submit every prompt for ``DRIVE_NEW`` greedy tokens; returns
    the handles. The caller disarms."""
    from paddle_tpu_torch.fault import inject

    inject.arm(FIRST_STEP_WAITS + (f";{spec}" if spec else ""))
    return [submit(p, max_new_tokens=DRIVE_NEW, **submit_kw) for p in prompts]


def same_share(outs, ref):
    return sum(a == b for a, b in zip(outs, ref)) / len(ref)


def wait_until(tag, cond, what, timeout=300):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"engine ({tag}): {what} not within {timeout}s")
        time.sleep(0.002)


def handoff_run(model, prompts, vocab_size, tag, launches, corrupt=False):
    """One handoff: an engine serves ``prompts`` until ``HANDOFF_AFTER_STEPS``
    decode steps, then ``new.adopt(old.handoff())`` on a fresh engine
    (``serve.snapshot_corrupt`` armed around the capture when ``corrupt``);
    the original handles finish on the successor. Returns (outputs, adopt
    info, handoff ms, adopt ms, checksum ms, successor's pages used after its
    close())."""
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import Engine

    def run():
        old = Engine(model, **ENGINE_KW, int8=False, seed=0)
        new = None
        try:
            handles = chaos_wave(old.submit, prompts,
                                 "serve.snapshot_corrupt" if corrupt else None)
            wait_until(tag, lambda: old.stats()["decode_steps"]
                       >= HANDOFF_AFTER_STEPS, "the decode steps")
            t0 = time.monotonic()
            snap = old.handoff()
            t_handoff = time.monotonic() - t0
            inject.disarm()
            new = Engine(model, **ENGINE_KW, int8=False, seed=0)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            info = new.adopt(snap)
            t_adopt = time.monotonic() - t0
            t0 = time.monotonic()
            with torch.inference_mode():
                G.kv_block_checksums(snap["kpool"], snap["vpool"],
                                     snap["fingerprint"]["bids"])
            t_sums = time.monotonic() - t0
            del snap
            outs = [h.result(timeout=900) for h in handles]
        finally:
            inject.disarm()
            old.close()
            if new is not None:
                new.close()
        return outs, info, t_handoff, t_adopt, t_sums, \
            new.stats()["pages_used"]

    outs, info, t_h, t_a, t_s, used = launches(tag, run)
    well_formed(tag, prompts, outs, vocab_size)
    print(f"  engine ({tag}): handoff() {t_h * 1e3:.1f} ms, adopt() "
          f"{t_a * 1e3:.1f} ms, kv_block_checksums over "
          f"{info['blocks_reattached'] or 'the'} blocks {t_s * 1e3:.1f} ms; "
          f"adopt {({k: v for k, v in info.items() if k != 'installed'})}")
    if used:
        fail(f"engine ({tag}): the successor holds {used} pages after close()")
    return outs, info, {"handoff_ms": t_h * 1e3, "adopt_ms": t_a * 1e3,
                        "checksums_ms": t_s * 1e3}


def flight_dir(sub):
    """A fresh flight-dump directory for one sub-drive, set as
    ``PADDLE_TPU_FLIGHT_DIR``."""
    d = FLIGHT_DIR / sub
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    os.environ["PADDLE_TPU_FLIGHT_DIR"] = str(d)
    return d


def read_dump(tag, path):
    """(bytes, document) of one flight dump, or ``fail`` if it does not
    parse."""
    try:
        return path.stat().st_size, json.loads(path.read_text())
    except (OSError, ValueError) as e:
        fail(f"engine ({tag}): flight dump {path.name} unreadable: {e!r}")


def crash_dumps_check(d):
    """g2's post-mortems: the engine loop's ``serving_loop_error`` and the
    supervisor's ``serving_supervisor_crash`` dump must each parse, carry
    the engine's in-flight table (``DRIVE_REQUESTS`` running rows at the
    crash step) and the supervisor's context (no restart yet in the loop's,
    one in the supervisor's), and their recent spans must
    end in the last decode step before the crash (step ``CRASH_STEP - 1``,
    all rows) and its ``schedule`` span. Returns the dump sizes."""
    sizes = {}
    # the loop's dump precedes the supervisor's detection: 0 restarts yet
    for reason, restarts in (("serving_loop_error", 0),
                             ("serving_supervisor_crash", 1)):
        paths = sorted(d.glob(f"*_{reason}.json"))
        if len(paths) != 1:
            fail(f"engine (g2): {len(paths)} {reason} flight dumps")
        size, doc = read_dump("g2", paths[0])
        ctx = doc["context"]
        engines = [v for k, v in ctx.items() if "running" in v
                   and v.get("step") == CRASH_STEP]
        sups = [v for k, v in ctx.items()
                if k.startswith("paddle_tpu_torch_serving_supervisor_")]
        if len(engines) != 1 \
                or len(engines[0]["running"]) != DRIVE_REQUESTS \
                or len(sups) != 1 or sups[0].get("restarts") != restarts:
            fail(f"engine (g2): {reason} dump context {sorted(ctx)}")
        tail = [(s["name"], s["attrs"].get("step"), s["attrs"].get("rows"))
                for s in doc["recent_spans"][-2:]]
        if tail != [("decode_step", CRASH_STEP - 1, DRIVE_REQUESTS),
                    ("schedule", CRASH_STEP - 1, None)]:
            fail(f"engine (g2): {reason} dump's recent spans end in {tail}")
        sizes[reason] = size
    return sizes


def reattach_check(tag, info, outs, ref):
    """A clean handoff or crash must re-attach with nothing re-prefilled and
    give the uninterrupted run's tokens; a ``reprefill`` here is a failure,
    not a fallback."""
    if info.get("mode") != "reattach" or info.get("reprefill_tokens", 0) \
            or not info.get("reattached"):
        fail(f"engine ({tag}): recovery {info}")
    if outs != ref:
        fail(f"engine ({tag}): {same_share(outs, ref):.3f} of the outputs "
             "equal the uninterrupted run's")


def g0_runs(model, prompts, vocab_size, tag, launches):
    """g0 / h0: an uninterrupted engine, twice; the two runs must agree token
    for token (the control of every identity check after it)."""
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.serving import Engine

    def run():
        eng = Engine(model, **ENGINE_KW, int8=False, seed=0)
        try:
            outs = [h.result(timeout=900) for h in chaos_wave(eng.submit,
                                                              prompts)]
        finally:
            inject.disarm()
            eng.close()
        well_formed(tag, prompts, outs, vocab_size)
        return outs

    first = launches(f"{tag}0", run)
    if launches(f"{tag}0", run) != first:
        fail(f"engine ({tag}0): two uninterrupted runs differ")
    print(f"  engine ({tag}0): two uninterrupted runs agree token for token")
    return first


def durability_drive(model, cfg, prompts, tag, full=True):
    """Drive (g) (``full``, GPT-3 1.3B) or (h) (Llama-7B): ``ENGINE_KW`` with
    the paged kernel over ``prompts``, each sub-drive's wave queued before
    the first admission (``FIRST_STEP_WAITS``). 0: the uninterrupted run,
    twice. 1: a handoff after ``HANDOFF_AFTER_STEPS`` decode steps must
    re-attach with no token re-prefilled and finish with 0's tokens. With
    ``full``: 2, a ``ServingSupervisor`` (snapshot on) over a crash at decode
    step 24 must restart once, re-attach and give 0's tokens; 3, a handoff
    whose capture is torn must fall back to re-prefill and complete; 4, a
    synthesized out-of-memory must park blocks and complete; 5, the shed
    policy, a deadline and a drain. Injection is disarmed after each
    sub-drive. Returns the drive's row."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.fault import memory as fmem
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.serving import (DeadlineExceeded, Engine,
                                          Overloaded, ServingSupervisor)

    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    V = cfg.vocab_size
    launches = _Launches()
    row = {"drive": tag, "int8": False}
    ref = g0_runs(model, prompts, V, tag, launches)
    outs, info, ms = handoff_run(model, prompts, V, f"{tag}1", launches)
    reattach_check(f"{tag}1", info, outs, ref)
    row[f"{tag}1"] = {"adopt": info, **ms}
    if not full:
        row["launches"] = launches.total
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return row

    dumps = flight_dir("g2")

    def g2():
        sup = ServingSupervisor(model, snapshot=True,
                                watchdog_s=SUPERVISOR_WATCHDOG_S,
                                **ENGINE_KW, int8=False, seed=0)
        try:
            outs = [h.result(timeout=900) for h in
                    chaos_wave(sup.submit, prompts, CRASH_SPEC)]
            return outs, sup.restarts, sup.health()["last_recovery"]
        finally:
            inject.disarm()
            sup.close()

    outs, restarts, rec = launches("g2", g2)
    well_formed("g2", prompts, outs, V)
    print(f"  engine (g2): crash at decode step 24 under ServingSupervisor "
          f"(snapshot on, watchdog {SUPERVISOR_WATCHDOG_S}s): restarts "
          f"{restarts}, recovery {rec}")
    if restarts != 1:
        fail(f"engine (g2): {restarts} restarts")
    reattach_check("g2", {**rec, "reprefill_tokens": 0}, outs, ref)
    sizes = crash_dumps_check(dumps)
    print(f"  engine (g2): flight dumps parse, carry the {DRIVE_REQUESTS} "
          f"running rows at step {CRASH_STEP} and the supervisor's context, "
          f"and end in decode step {CRASH_STEP - 1}; bytes {sizes}")
    row["g2"] = {"restarts": restarts, "recovery": rec, "dump_bytes": sizes}

    outs, info, ms = handoff_run(model, prompts, V, "g3", launches,
                                 corrupt=True)
    if info["mode"] != "reprefill" or "CRC" not in info.get(
            "reject_reason", ""):
        fail(f"engine (g3): a torn capture adopted as {info}")
    share = same_share(outs, ref)
    print(f"  engine (g3): torn capture rejected ({info['reject_reason']}); "
          f"{info['reprefill_tokens']} tokens re-prefilled; {share:.3f} of "
          "the outputs equal g0's")
    row["g3"] = {"adopt": info, "equal_share": share, **ms}

    def g4():
        eng = Engine(model, **ENGINE_KW, int8=False, seed=0)
        c0 = profiler.counters()
        try:
            outs = [h.result(timeout=900) for h in
                    chaos_wave(eng.submit, prompts, OOM_SPEC)]
            parked = eng.stats()["pages_parked"]
            # the post-mortem of the exhaustion, taken while the engine
            # holds its pool
            ev = fmem.recent_ooms()[-1]
            dump = fmem.post_mortem(
                ev["where"], [dict(ev, action="park", pages_parked=parked)])
        finally:
            inject.disarm()
            eng.close()
        return outs, counter_delta(c0), parked, dump

    flight_dir("g4")
    outs, d, parked, dump = launches("g4", g4)
    size, doc = read_dump("g4", Path(dump))
    census = doc["extra"]["census"]
    hbm = doc["context"].get("hbm", {}).get("recent_oom", [{}])[-1]
    if not (census.get("device", "").startswith("cuda")
            and 0 < census["allocated_bytes"] <= census["reserved_bytes"]
            and census["allocated_bytes"] <= census["peak_allocated_bytes"]
            and doc["allocator"] and hbm.get("where") == "serve.step"):
        fail(f"engine (g4): post-mortem census {census}, allocator "
             f"{doc['allocator']}, hbm context {hbm}")
    print(f"  engine (g4): hbm_exhausted post-mortem of {size} bytes: "
          f"allocated {census['allocated_bytes'] / 2**30:.2f} GiB, reserved "
          f"{census['reserved_bytes'] / 2**30:.2f} GiB, peak allocated "
          f"{census['peak_allocated_bytes'] / 2**30:.2f} GiB, the OOM event "
          "in its hbm context")
    well_formed("g4", prompts, outs, V)
    share = same_share(outs, ref)
    print(f"  engine (g4): out-of-memory at step 8: serve_pool_shrunk "
          f"{d.get('serve_pool_shrunk', 0)}, hbm_oom_trips "
          f"{d.get('hbm_oom_trips', 0)}, {parked} pages parked at the end; "
          f"{share:.3f} of the outputs equal g0's")
    if not d.get("serve_pool_shrunk", 0) > 0 or d.get("serve_failed", 0):
        fail(f"engine (g4): counters {d}")
    row["g4"] = {"pool_shrunk": d["serve_pool_shrunk"],
                 "oom_trips": d.get("hbm_oom_trips", 0),
                 "equal_share": share, "dump_bytes": size}

    def g5():
        eng = Engine(model, **ENGINE_KW, **SHED_KW, int8=False, seed=0)
        shed, handles, drain_seen = [], [], []
        try:
            inject.arm(FIRST_STEP_WAITS)
            for p in prompts:
                try:
                    handles.append((p, eng.submit(p,
                                                  max_new_tokens=DRIVE_NEW)))
                except Overloaded as e:
                    shed.append(e.retry_after_s)
            accepted = [(p, h.result(timeout=900)) for p, h in handles]
            inject.disarm()
            late = eng.submit(prompts[0], max_new_tokens=DRIVE_NEW,
                              deadline_s=1e-3)
            try:
                late.result(timeout=900)
                expired = None
            except DeadlineExceeded as e:
                expired = str(e)
            wave = [(p, eng.submit(p, max_new_tokens=DRIVE_NEW))
                    for p in prompts[:DRAIN_REQUESTS]]
            closer = threading.Thread(
                target=lambda: eng.close(drain=True, timeout=900),
                daemon=True)
            closer.start()
            while closer.is_alive():
                r = eng.ready()
                if r["reason"] == "draining" and not r \
                        and not all(h.done for _, h in wave):
                    drain_seen.append(r["queue_depth"])
                time.sleep(0.002)
            closer.join()
            drained = [(p, h.result(timeout=5)) for p, h in wave]
        finally:
            inject.disarm()
            eng.close()
        return shed, accepted, expired, drain_seen, drained

    shed, accepted, expired, drain_seen, drained = launches("g5", g5)
    for what, pairs in (("accepted", accepted), ("drained", drained)):
        well_formed(f"g5 {what}", [p for p, _ in pairs],
                    [o for _, o in pairs], V)
    print(f"  engine (g5): max_queue {SHED_KW['max_queue']} with shed: "
          f"{len(accepted)} accepted and completed, {len(shed)} Overloaded "
          f"(retry_after_s {min(shed, default=0):.3f}-"
          f"{max(shed, default=0):.3f}); deadline 1 ms: {expired}; "
          f"drain: {len(drained)} completed, ready() False with reason "
          f"'draining' in {len(drain_seen)} probes")
    if not shed or not all(r > 0 for r in shed) or not accepted:
        fail(f"engine (g5): {len(shed)} shed {shed}, {len(accepted)} "
             "accepted")
    if expired is None:
        fail("engine (g5): the 1 ms deadline did not expire")
    if not drain_seen or len(drained) != DRAIN_REQUESTS:
        fail(f"engine (g5): drain probes {drain_seen}, {len(drained)} "
             "completed")
    row["g5"] = {"accepted": len(accepted), "overloaded": len(shed),
                 "retry_after_s": [min(shed), max(shed)],
                 "deadline": expired, "drained": len(drained),
                 "draining_probes": len(drain_seen)}
    row["launches"] = launches.total
    row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return row

# -- observability (drive i) ---------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_get(port, path):
    """(status, body) of a GET to the local telemetry endpoint."""
    from urllib.error import HTTPError
    from urllib.request import urlopen

    try:
        with urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read().decode()
    except HTTPError as e:
        return e.code, e.read().decode()


_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^{}]*\})? "
    r"(NaN|[-+]?Inf|[-+]?(\d+(\.\d*)?|\.\d+)([eE][-+]?\d+)?)$")


def check_prometheus(tag, body):
    """``body`` must parse as Prometheus text: every sample line
    ``name{labels} value``, every histogram's buckets non-decreasing and
    ending in ``+Inf`` equal to its ``_count``, with the four SLO histogram
    families and the ``paddle_tpu_serve_e2e_latency`` summary present.
    Returns {(family, labels): count} of the histograms."""
    types, buckets, counts = {}, {}, {}
    for line in body.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            types[name] = typ
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            fail(f"engine ({tag}): /metrics line {line!r} is not "
                 "name{labels} value")
        name, labels, val = m.group(1), m.group(2) or "", float(m.group(3))
        lab = dict(re.findall(r'(\w+)="([^"]*)"', labels))
        for suffix, into in (("_bucket", buckets), ("_count", counts)):
            fam = name[:-len(suffix)]
            if name.endswith(suffix) and types.get(fam) == "histogram":
                le = lab.pop("le", None)
                key = (fam, tuple(sorted(lab.items())))
                if suffix == "_bucket":
                    into.setdefault(key, []).append((le, val))
                else:
                    into[key] = val
    for fam in SLO_FAMILIES:
        if types.get(fam) != "histogram":
            fail(f"engine ({tag}): /metrics lacks the {fam} histogram")
    if types.get("paddle_tpu_serve_e2e_latency") != "summary":
        fail(f"engine ({tag}): /metrics lacks the e2e latency summary")
    for key, seq in buckets.items():
        vals = [v for _, v in seq]
        if vals != sorted(vals) or seq[-1][0] != "+Inf" \
                or vals[-1] != counts.get(key):
            fail(f"engine ({tag}): /metrics histogram {key} buckets {seq}, "
                 f"count {counts.get(key)}")
    return {k: int(v) for k, v in counts.items()}


def observe_tax(model, prompts):
    """The reference's ``bench_observe_overhead`` at GPT-3 1.3B: two warm
    engines of (a)'s setting, trace off and trace on, serve the same wave of
    ``TAX_NEW`` tokens a request in alternating order, ``TAX_PAIRS`` pairs;
    the median of the per-pair on/off ratios, minus 1, is the tax. Then the
    inert tripwire: with every ``serving.observe`` hook made to raise, a
    trace-off engine must still serve a wave. Host-clock waves spread
    between runs, so the tax is reported, not held to a bound."""
    from paddle_tpu_torch.serving import Engine, observe

    def wave(eng, n=None):
        t0 = time.monotonic()
        hs = [eng.submit(p, max_new_tokens=TAX_NEW)
              for p in prompts[:n or len(prompts)]]
        outs = [h.result(timeout=900) for h in hs]
        torch.cuda.synchronize()
        return time.monotonic() - t0, outs

    observe.reset()
    off = Engine(model, **ENGINE_KW, int8=False, seed=0, trace=False)
    on = Engine(model, **ENGINE_KW, int8=False, seed=0, trace=True)
    try:
        wave(off)
        wave(on)  # warm both engines' step functions
        ratios, pairs = [], []
        for i in range(TAX_PAIRS):
            if i % 2 == 0:
                t_on, t_off = wave(on)[0], wave(off)[0]
            else:
                t_off, t_on = wave(off)[0], wave(on)[0]
            ratios.append(t_on / t_off)
            pairs.append((t_off, t_on))
    finally:
        off.close()
        on.close()
    tax = sorted(ratios)[len(ratios) // 2] - 1.0
    hooks = [n for n in dir(observe) if n.startswith("on_")] \
        + ["drift", "drift_value", "trace_book", "start_endpoint"]
    saved = {n: getattr(observe, n) for n in hooks}

    def explode(*a, **k):
        raise AssertionError("observe hook reached from a trace-off engine")

    try:
        for n in hooks:
            setattr(observe, n, explode)
        eng = Engine(model, **ENGINE_KW, int8=False, seed=0)
        try:
            _, outs = wave(eng, n=4)
        finally:
            eng.close()
    finally:
        for n, f in saved.items():
            setattr(observe, n, f)
    if any(len(o) != len(p) + TAX_NEW for o, p in zip(outs, prompts)):
        fail("engine (i): the inert tripwire's wave is malformed")
    observe.reset()
    print(f"  engine (i): observability tax {tax * 100:+.2f}% (median of "
          f"{TAX_PAIRS} alternating pairs of {len(prompts)} x {TAX_NEW} "
          f"token waves; wave s off/on "
          f"{[(round(a, 4), round(b, 4)) for a, b in pairs]}); the "
          f"reference's acceptance is < 2% a step; inert tripwire: a "
          f"trace-off engine served {len(outs)} requests with every hook "
          "raising")
    return {"tax_pct": tax * 100, "ratios": ratios, "pairs_s": pairs,
            "inert_ok": True}


def traced_drive(model, cfg, prompts):
    """Drive (i): (a)'s engine (paged kernel) with ``trace=True`` and the
    telemetry endpoint on a free local port serves (a)'s wave, queued before
    the first admission (``FIRST_STEP_WAITS``), as does a trace-off engine
    first, whose tokens it must equal. Fatal checks: one closed timeline per
    request (unique trace ids, outcome ok, none left open; ``queue``, then
    ``prefill``, then decode steps), the TTFT, end-to-end and queue-wait
    histograms counting ``DRIVE_REQUESTS`` and the inter-token one
    ``DRIVE_REQUESTS * (DRIVE_NEW - 1)``, ``/metrics`` valid Prometheus text
    with the same counts, ``/debug/requests`` listing the live trace ids
    mid-drive, ``/healthz`` 200 during the drive, ``/readyz`` 200 before and
    503 after ``close(drain=True)``. Then, on the idle engine, a device
    timeline of ``TIMELINE_STEPS`` decode steps must name the paged kernel
    at ``num_layers`` launches a step, as many as its wrapper counted; and
    the observability tax (``observe_tax``). Launch counts are zeroed just
    before the traced wave and read just after it."""
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine, observe

    tag, V = "i", cfg.vocab_size
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    eng = Engine(model, **ENGINE_KW, int8=False, seed=0)
    try:
        ref = [h.result(timeout=900) for h in chaos_wave(eng.submit, prompts)]
    finally:
        inject.disarm()
        eng.close()
    observe.reset()
    port = free_port()
    eng = Engine(model, **ENGINE_KW, int8=False, seed=0, trace=True,
                 metrics_port=port)
    if eng._endpoint is None:
        fail(f"engine ({tag}): the endpoint did not bind port {port}")
    prober = observe.start_endpoint(eng, 0)  # an outside readiness probe
    try:
        K.reset_launch_counts()
        t0 = time.monotonic()
        handles = chaos_wave(eng.submit, prompts)
        code, body = http_get(port, "/debug/requests")
        live = {r["trace"] for r in json.loads(body)} if code == 200 else set()
        health = http_get(port, "/healthz")[0]
        outs = [h.result(timeout=900) for h in handles]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = K.launch_counts()
        inject.disarm()
        well_formed(tag, prompts, outs, V)
        if outs != ref:
            fail(f"engine ({tag}): {same_share(outs, ref):.3f} of the traced "
                 "outputs equal the trace-off engine's")
        if not counts["paged_attention_rows"]:
            fail(f"engine ({tag}): kernel launches {counts}")
        book = observe.trace_book()
        done, still = book.completed(), book.open_traces()
        ids = {tl["trace"] for tl in done}
        bad = [tl["trace"] for tl in done if tl["outcome"] != "ok"]
        for tl in done:
            names = [ev["name"] for ev in tl["events"]]
            if names[:2] != ["queue", "prefill"] or "decode_step" not in names \
                    or set(names[2:]) != {"decode_step"}:
                bad.append((tl["trace"], names[:4]))
        if len(done) != len(prompts) or len(ids) != len(prompts) or still \
                or bad:
            fail(f"engine ({tag}): {len(done)} closed timelines, "
                 f"{len(ids)} ids, {len(still)} open, bad {bad[:4]}")
        if code != 200 or not live or not live <= ids:
            fail(f"engine ({tag}): /debug/requests {code}, live ids {live}")
        if health != 200:
            fail(f"engine ({tag}): /healthz {health} during the drive")
        snap = observe.slo().snapshot()
        want = {"serve_ttft_seconds": len(prompts),
                "serve_e2e_seconds": len(prompts),
                "serve_queue_seconds": len(prompts),
                "serve_inter_token_seconds": len(prompts) * (DRIVE_NEW - 1)}
        got = {m: sum(h["count"] for h in snap.get(m, {}).values())
               for m in want}
        if got != want:
            fail(f"engine ({tag}): histogram counts {got}, want {want}")
        code, body = http_get(port, "/metrics")
        if code != 200:
            fail(f"engine ({tag}): /metrics {code}")
        prom = check_prometheus(tag, body)
        prom_counts = {}
        for (fam, _), n in prom.items():
            key = "serve_" + fam.split("_serve_")[1]
            prom_counts[key] = prom_counts.get(key, 0) + n
        if prom_counts != got:
            fail(f"engine ({tag}): /metrics counts {prom_counts}, the "
                 f"histograms' {got}")
        pct = {f"{m}_p{q}": observe.percentile(f"serve_{m}_seconds", q / 100)
               for m in ("ttft", "inter_token") for q in (50, 99)}
        ready_before = http_get(prober.port, "/readyz")[0]
        # the device timeline on the idle engine: its own decode step
        with torch.inference_mode():
            step = decode_step(eng)
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            K.reset_launch_counts()
            ev = device_timeline(step, TIMELINE_STEPS, f"timeline ({tag})")
            wrapped = K.launch_counts()["paged_attention_rows"]
        tl = timeline_kernels(ev, ("paged_attention_kernel",), TIMELINE_STEPS)
        n_tl = tl["paged_attention_kernel"]["launches"]
        if n_tl != cfg.num_layers * TIMELINE_STEPS or n_tl != wrapped:
            fail(f"engine ({tag}): the device timeline names the paged "
                 f"kernel {n_tl} times, its wrapper counted {wrapped}, want "
                 f"{cfg.num_layers} x {TIMELINE_STEPS}")
        eng.close(drain=True)
        ready_after, body = http_get(prober.port, "/readyz")
        if ready_before != 200 or ready_after != 503:
            fail(f"engine ({tag}): /readyz {ready_before} before and "
                 f"{ready_after} after close(drain=True): {body}")
    finally:
        inject.disarm()
        prober.close()
        eng.close()
    tok_s = len(outs) * DRIVE_NEW / wall
    print(f"  engine ({tag}) traced, endpoint on port {port}: "
          f"{len(outs) * DRIVE_NEW} tokens in {wall:.2f}s = {tok_s:.1f} tok/s "
          f"(the first step waits {FIRST_STEP_WAITS}), launches {counts}; "
          f"{len(done)} closed timelines, tokens equal the trace-off "
          f"engine's; TTFT p50 {pct['ttft_p50'] * 1e3:.1f} ms, p99 "
          f"{pct['ttft_p99'] * 1e3:.1f} ms; inter-token p50 "
          f"{pct['inter_token_p50'] * 1e3:.2f} ms, p99 "
          f"{pct['inter_token_p99'] * 1e3:.2f} ms (bucket estimates); "
          f"histogram counts {got}; /metrics valid, /debug/requests listed "
          f"{len(live)} live ids, /readyz {ready_before} then {ready_after}")
    t = tl["paged_attention_kernel"]
    print(f"  timeline ({tag}): {TIMELINE_STEPS} decode steps at B=32, "
          f"ctx~640: paged_attention_kernel {t['launches']} launches "
          f"({t['launches'] // TIMELINE_STEPS} a step, the wrapper counted "
          f"{wrapped}), {t['ms_per_step']:.4f} ms a step, "
          f"{t['us_per_launch']:.2f} us a launch")
    tax = observe_tax(model, prompts)
    return {"drive": tag, "int8": False, "tok_s": tok_s, "wall_s": wall,
            "launches": {k: counts[k] for k in
                         ("paged_attention_rows", "int8_matmul")},
            "timelines": len(done), "histogram_counts": got,
            **{k + "_s": v for k, v in pct.items()},
            "device_timeline": tl, "tax": tax}


def engine_phase(profile=False):
    """Each of ``engine_models()`` at full width and depth through its
    drives: GPT-3 1.3B (a) paged kernel, (b) int8 weights with both kernels,
    (e) the prefix cache and chunked prefill, (f) speculative decoding with
    int8 weights, (g) durability and resilience, (i) tracing, the endpoint,
    the decode timeline and the observability tax; then Llama-7B (c), (d) as
    (a), (b), with the tail, chunked and verify builders checked on (c)'s
    engine after its drive, and (h) as (g)'s g0 and g1.
    Each model and its engines are freed before the next model is built.
    Returns the launch counts summed over the drives, and the drives'
    rows."""
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
        runs = [lambda tag=tag, int8=int8: engine_drive(
                    model, cfg.vocab_size, tag, int8, prompts, profile,
                    checks=tag == "c") for tag, int8 in drives[name]]
        if name == "gpt3_1p3b":
            runs += [lambda: prefix_drive(model, cfg.vocab_size),
                     lambda: spec_drive(model, cfg, prompts, profile),
                     lambda: durability_drive(model, cfg, prompts, "g"),
                     lambda: traced_drive(model, cfg, prompts)]
        else:
            runs.append(lambda: durability_drive(model, cfg, prompts, "h",
                                                 full=False))
        for run in runs:
            torch.cuda.reset_peak_memory_stats()
            row = run()
            rows.append({"model": name, **row})
            for k, n in row["launches"].items():
                total[k] += n
            torch.cuda.empty_cache()
        del model, runs
        torch.cuda.empty_cache()
    return total, rows


# -- phase 17: tensor-parallel serving and the native host runtime -----------

TP = 2
TP_DEVICES = ("cuda:0", "cuda:0")  # both shards on the one card
TP_LLAMA_REQUESTS = 8  # (17b): the first 8 of drive (c)'s prompts
# (17b): Llama-7B's depth at tp = 2, cut from 32 to 8, then to 4 when
# phase 23 joined, to hold the whole script near 1000 s (full width: the
# shard shapes are the full model's)
TP_LLAMA_LAYERS = 4
TP_NATIVE = {}  # phase 17's results: the {"tp_native": ...} line
LOADER_STEPS = 4  # (17e): 12a's steps fed by the thread-worker loader


def tp_serve(model, vocab_size, tag, waves, tp, **kw):
    """One engine with the paged kernel (at ``tp``: ``TP`` shards on
    ``TP_DEVICES``; else one device) serves ``waves`` of prompts greedily,
    each wave run to its end and queued whole before its first step
    (``FIRST_STEP_WAITS``), so the tp and one-device runs batch alike.
    Launch counts and the engine's counters are zeroed just before the last
    wave and read just after it. Returns (every output, the last wave's
    wall s, its decode steps, its mean decode-step ms, its launches, its
    counter deltas, the engine, still open)."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.serving import Engine

    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    where = {"tp": TP, "device": TP_DEVICES} if tp else {}
    eng = Engine(model, **ENGINE_KW, seed=0, **where, **kw)
    outs = []
    for i, wave in enumerate(waves):
        last = i == len(waves) - 1
        if last:
            st0 = eng.stats()
            K.reset_launch_counts()
            c0 = profiler.counters()
        t0 = time.monotonic()
        try:
            got = [h.result(timeout=900) for h in chaos_wave(eng.submit,
                                                             wave)]
        finally:
            inject.disarm()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        well_formed(tag, wave, got, vocab_size)
        outs += got
    counts = K.launch_counts()
    d = counter_delta(c0)
    st = drain(eng, tag, cached=bool(kw.get("prefix_cache")))
    steps = st["decode_steps"] - st0["decode_steps"]
    step_ms = (st["decode_step_ms_mean"] * st["decode_steps"]
               - st0["decode_step_ms_mean"] * st0["decode_steps"]) / steps
    return outs, wall, steps, step_ms, counts, d, eng


def token_agreement(outs, ref, prompts):
    """The share of generated tokens equal to the reference's at the same
    place, and the requests whose every token is equal."""
    same = total = whole = 0
    for o, r, p in zip(outs, ref, prompts):
        a, b = o[len(p):], r[len(p):]
        same += sum(x == y for x, y in zip(a, b))
        total += len(b)
        whole += a == b
    return same / total, whole


def tp_logits_diff(eng, eng1, prompts):
    """The max abs difference of the first step's logits (the monolithic
    prefill's, at each prompt's last token) between the tp engine and the
    one-device engine, and of one decode step's through the kernels."""
    mono_tp = eng._debug_prefill_paths(prompts)[0]
    mono_1 = eng1._debug_prefill_paths(prompts)[0]
    step_tp = eng._debug_step_logits(prompts)[0]
    step_1 = eng1._debug_step_logits(prompts)[0]
    return (float(np.abs(mono_tp - mono_1).max()),
            float(np.abs(step_tp - step_1).max()))


def tp_op_probe(model, B=32):
    """Where a tp step can stop being the one-device step's bits: each
    sharded product of layer 0 and the head at decode batch ``B`` (bf16,
    random inputs from a seed) as the shards' concat against the full
    product's columns, and the paged kernel over the shards' KV heads (the
    unsharded shape's cluster size) against the whole pool's. Returns
    ``[(op, bit_equal, max_abs_diff)]`` in the step's order."""
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.ops import kernels as K

    dev = torch.device("cuda", 0)
    decode_state = G.gpt_decode_state if hasattr(model, "gpt") \
        else G.llama_decode_state
    key, arch, params, _ = decode_state(model, dev)
    packed, vocab = G.tp_pack_params(key, params, TP, [dev] * TP)
    g = torch.Generator(device="cuda").manual_seed(0)
    HD = params["wte"].shape[1]
    h = torch.randn(B, 1, HD, generator=g, device="cuda").to(params[
        "wte"].dtype)
    w0, s0 = params["layers"][0], [s["layers"][0] for s in packed["shard"]]
    out = []

    def probe(op, full, parts):
        got = torch.cat(parts, -1)[..., :full.shape[-1]]
        out.append((op, bool(torch.equal(got, full)),
                    float((got.float() - full.float()).abs().max())))

    if key[0] == "gpt":
        probe("qkv", (h @ w0["qkv_w"] + w0["qkv_b"]).reshape(
            B, 1, 3, -1, arch["head_dim"]).transpose(2, 3).reshape(B, 1, -1),
            [(h @ s["qkv_w"] + s["qkv_b"]).reshape(
                B, 1, 3, -1, arch["head_dim"]).transpose(2, 3).reshape(
                    B, 1, -1) for s in s0])
        probe("up", h @ w0["up_w"] + w0["up_b"],
              [h @ s["up_w"] + s["up_b"] for s in s0])
        head = h[:, 0] @ params["wte"].T
        parts = [h[:, 0] @ s["head_w"].T for s in packed["shard"]]
    else:
        for name in ("q_w", "k_w", "v_w", "gate_w", "up_w"):
            probe(name[:-2], h @ w0[name], [h @ s[name] for s in s0])
        head = h[:, 0] @ params["head_w"]
        parts = [h[:, 0] @ s["head_w"] for s in packed["shard"]]
    KV, D = arch["kv_heads"], arch["head_dim"]
    rep = key[1] // KV
    q, kp, vp, tables, pos = paged_inputs(params["wte"].dtype, rep=rep, B=B,
                                          KV=KV, D=D, seed=2)
    bs, mb = kp.shape[1], tables.shape[1]
    cfg = {"split": kernel_split(B, KV, bs, mb)}
    full = K.paged_attention_rows(q, kp, vp, tables, pos, config=cfg)
    kvl = KV // TP
    shards = [K.paged_attention_rows(
        q[:, d * kvl * rep:(d + 1) * kvl * rep].contiguous(),
        kp[:, :, d * kvl:(d + 1) * kvl].contiguous(),
        vp[:, :, d * kvl:(d + 1) * kvl].contiguous(), tables, pos,
        config=cfg) for d in range(TP)]
    probe("paged_attention", full, shards)
    probe("head", head, parts)
    del packed, params, q, kp, vp
    torch.cuda.empty_cache()
    return out


def tp_first_divergence(tag, agree, probe):
    """A tp run whose tokens differ from the one-device run's must have a
    sharded op whose bits differ (its first, in the step's order, is the
    cause named); a mismatch with every op bit-equal fails."""
    first = next(((op, d) for op, eq, d in probe if not eq), None)
    if agree < 1.0 and first is None:
        fail(f"tp ({tag}): token agreement {agree:.4f} with every sharded "
             "op bit-equal to the one-device op: no cause found")
    return None if first is None else {"op": first[0], "max_abs": first[1]}


def tp_shard_kernel(B=32, MB=64, KV=16):
    """The paged kernel at a tp shard's shape (KV/TP heads, the unsharded
    shape's cluster size) against its plain version, bf16 against the f32
    plain read on the same inputs (``TOL`` and ``PAGED_O_REL_TOL``), then
    timed beside the plain version and the card's least time (as
    ``paged_timing``)."""
    from paddle_tpu_torch.ops import kernels as K

    kvl = KV // TP
    split = kernel_split(B, KV, 16, MB)
    q, kp, vp, tables, pos = paged_inputs(torch.bfloat16, B=B, KV=kvl,
                                          MB=MB, seed=1)
    cfg = {"split": split}
    out = K.paged_attention_rows(q, kp, vp, tables, pos, config=cfg)
    ref = K.paged_attention_rows_plain(q.float(), kp.float(), vp.float(),
                                       tables, pos)
    rel = rel_err(out, ref)
    note = (f" at the tp shard shape B={B} MB={MB} KV={kvl} split={split}, "
            f"rel_norm_err={rel:.3e} (tol rel {PAGED_O_REL_TOL})")
    err = compare("paged_attention_rows", torch.bfloat16, out, ref, note)
    if not rel <= PAGED_O_REL_TOL:
        fail(f"paged_attention_rows bf16{note}")
    H, D, BS = q.shape[1], q.shape[2], kp.shape[1]
    live = int((pos.long() + 1).sum())
    nbytes = (2 * B * H * D * 2 + 2 * live * kvl * D * 2
              + 4 * int((pos.long() // BS + 1).sum()) + 4 * B)
    b_ms, b_by = bound(nbytes, 4 * live * H * D, torch.bfloat16)
    row = {"shape": f"B={B} H={H} KV={kvl} D={D} BS={BS} MB={MB} "
                    f"mean_ctx={live / B:.1f} bf16, split {split} (the "
                    f"rule's at KV={KV}; at KV={kvl} it gives "
                    f"{kernel_split(B, kvl, BS, MB)})",
           "max_abs_err": err, "rel_norm_err": rel,
           "ms": time_ms(lambda: K.paged_attention_rows(q, kp, vp, tables,
                                                        pos, config=cfg)),
           "plain_ms": time_ms(lambda: K.paged_attention_rows_plain(
               q, kp, vp, tables, pos), iters=5),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"  (17a) paged kernel at the shard shape: {row['ms']:.4f} ms "
          f"(plain {row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}) "
          f"at {row['shape']}")
    del q, kp, vp, out, ref
    torch.cuda.empty_cache()
    return row


def tp_wire_bytes(eng, params_key, params, B=32):
    """The gather bytes one decode step of ``eng`` at batch B sends
    (``serve_tp_gather_bytes``), beside ``tp_collective_bytes``."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.models import generation as G

    step = decode_step(eng, B=B)
    with torch.inference_mode():
        step()
        c0 = profiler.counters().get("serve_tp_gather_bytes", 0)
        step()
    got = profiler.counters()["serve_tp_gather_bytes"] - c0
    fp32_b, int8_b = G.tp_collective_bytes(params_key, params, B, TP)
    return got, fp32_b, int8_b


def tp_gpt_phase(model, cfg):
    """(17a) GPT-3 1.3B at tp = 2, both shards on the one card, with the
    paged kernel: drive (a)'s 32 requests and drive (e)'s prefix-plus-chunk
    mix, each beside a one-device run of the same waves; (17c) the int8
    wire on (a)'s requests; (17d) drive (i)'s observability tax with the
    spans in the native ring."""
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    L, V = cfg.num_layers, cfg.vocab_size
    prompts = drive_prompts(V)
    probe = tp_op_probe(model)
    print(f"  (17) sharded ops against the one-device ops (bit_equal, max "
          f"abs): {probe}")
    res, refs = {"card_ops": probe}, {}
    for tag, waves, kw in (
            ("17a", [prompts], {}),
            ("17a+e", [prefix_prompts(V)[:1], prefix_prompts(V)[1:]],
             PREFIX_KW)):
        ref, wall1, _, step1, _, _, eng1 = tp_serve(model, V, tag + " tp1",
                                                    waves, 0, **kw)
        refs[tag] = ref
        try:
            outs, wall, steps, step_ms, counts, d, eng = tp_serve(
                model, V, tag, waves, TP, **kw)
            try:
                last = waves[-1]
                agree, whole = token_agreement(outs, ref, sum(waves, []))
                diff = tp_logits_diff(eng, eng1, last[:8])
                kl, pl = eng._debug_step_logits(last[:8])
                rel = float(np.linalg.norm(kl - pl) / np.linalg.norm(pl))
                want = TP * L * steps
                row = {"tok_s": len(last) * DRIVE_NEW / wall,
                       "wall_s": wall, "decode_steps": steps,
                       "decode_step_ms_mean": step_ms,
                       "tp1": {"tok_s": len(last) * DRIVE_NEW / wall1,
                               "decode_step_ms_mean": step1},
                       "launches_tp": counts["paged_attention_rows"],
                       "token_agreement": agree, "requests_equal": whole,
                       "first_step_logits_max_abs": diff[0],
                       "decode_step_logits_max_abs": diff[1],
                       "shard_kernel_vs_plain_rel": rel,
                       "first_divergence": tp_first_divergence(tag, agree,
                                                               probe),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                if kw:
                    row.update(prefix_hits=d["serve_prefix_hits"],
                               prefill_chunks=d["serve_prefill_chunks"])
                if tag == "17a":
                    got, fp32_b, int8_b = tp_wire_bytes(
                        eng, eng._arch_key, G.gpt_decode_state(model)[2])
                    row["gather_bytes_step"] = got
                    row["tp_collective_bytes"] = [fp32_b, int8_b]
            finally:
                eng.close()
        finally:
            eng1.close()
        print(f"  ({tag}) tp={TP} on {TP_DEVICES}: {len(last) * DRIVE_NEW} "
              f"tokens in {wall:.2f}s = {row['tok_s']:.1f} tok/s, decode "
              f"steps {steps}, mean decode step {step_ms:.2f} ms (one "
              f"device: {row['tp1']['tok_s']:.1f} tok/s, {step1:.2f} ms), "
              "paged "
              f"launches {row['launches_tp']} (want {TP} x {L} x {steps} = "
              f"{want}); greedy tokens equal to tp=1's: {agree:.4f} "
              f"({whole} of {len(last)} requests whole); max abs logit diff "
              f"first step {diff[0]:.4e}, one decode step {diff[1]:.4e}; the "
              f"shard kernel's step against its plain path rel "
              f"{rel:.3e} (tol {LOGITS_REL_TOL}); first diverging op "
              f"{row['first_divergence']}"
              + (f"; prefix hits {row['prefix_hits']}, chunk steps "
                 f"{row['prefill_chunks']}" if kw else ""))
        if row["launches_tp"] != want:
            fail(f"tp ({tag}): {row['launches_tp']} paged launches, want "
                 f"{want} (one a layer a shard a decode step)")
        if rel > LOGITS_REL_TOL:
            fail(f"tp ({tag}): shard kernel step rel {rel:.3e}")
        if kw and row["prefix_hits"] != len(last):
            fail(f"tp ({tag}): {row['prefix_hits']} prefix hits")
        res[tag] = row
    a = res["17a"]
    print(f"  (17a) gather bytes a decode step at B=32: {a['gather_bytes_step']}"
          f" (bf16; tp_collective_bytes counts 4 bytes an element: "
          f"{a['tp_collective_bytes'][0]}, half of it "
          f"{a['tp_collective_bytes'][0] // 2})")
    if a["gather_bytes_step"] * 2 != a["tp_collective_bytes"][0]:
        fail(f"tp (17a): gather bytes {a['gather_bytes_step']}")
    res["shard_kernel"] = tp_shard_kernel()
    # (17c) the int8 wire: lossy, every stream at its length
    outs, wall, steps, step_ms, counts, d, eng = tp_serve(
        model, V, "17c", [prompts], TP, tp_int8=True)
    try:
        got, fp32_b, int8_b = tp_wire_bytes(eng, eng._arch_key,
                                            G.gpt_decode_state(model)[2])
    finally:
        eng.close()
    agree, whole = token_agreement(outs, refs["17a"], prompts)
    res["17c"] = {"tok_s": len(prompts) * DRIVE_NEW / wall,
                  "decode_step_ms_mean": step_ms, "token_agreement": agree,
                  "requests_equal": whole, "gather_bytes_step": got,
                  "tp_collective_bytes": [fp32_b, int8_b],
                  "launches_tp": counts["paged_attention_rows"]}
    print(f"  (17c) int8 wire: every stream complete at {DRIVE_NEW} new "
          f"tokens; {res['17c']['tok_s']:.1f} tok/s, mean decode step "
          f"{step_ms:.2f} ms; greedy tokens equal to tp=1's {agree:.4f} "
          f"({whole} requests whole); wire bytes a decode step at B=32 "
          f"{got} against tp_collective_bytes' int8 {int8_b} (f32 {fp32_b})")
    if got != int8_b:
        fail(f"tp (17c): wire bytes {got}, want {int8_b}")
    # (17d) drive (i)'s tax with every span in the native ring
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.profiler import export

    with Profiler(targets=[ProfilerTarget.CPU]):
        tax = observe_tax(model, prompts)
        dropped = export.dropped()
        ring = [s for s in profiler.span_events()
                if s["name"] == "decode_step"]
    res["17d"] = {"tax_pct": tax["tax_pct"], "ratios": tax["ratios"],
                  "native_ring_decode_spans": len(ring),
                  "ring_dropped": dropped}
    print(f"  (17d) observability tax with spans in the native ring: "
          f"{tax['tax_pct']:+.2f}% (median of {TAX_PAIRS} alternating "
          f"pairs); the ring holds {len(ring)} decode_step spans; records "
          f"the rings overwrote {dropped}")
    if not ring:
        fail("tp (17d): no decode_step span in the native ring")
    TP_NATIVE.update(gpt=res)
    return res


def card_memory():
    """After a collection and ``empty_cache``: the caching allocator's
    allocated and reserved bytes and the bytes in use on the card (all
    processes; one here), from ``cudaMemGetInfo``."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {"allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved(),
            "card_used": total - free}


def tp_phase():
    """Phase 17's serving part: (17a, c, d) on GPT-3 1.3B, then (17b) on
    Llama-7B, each model built as the engine phase builds it and freed
    before the next, with the card's memory before and after each part
    and at the end (what the tp engines leave behind); the phase's seconds
    go on the ``tp_native`` line."""
    t0 = time.monotonic()
    mem = {"start": card_memory()}
    for name, cfg, _, _ in engine_models():
        if name == "llama_7b":
            cfg = dataclasses.replace(cfg, num_layers=TP_LLAMA_LAYERS)
        model = build_engine_model(name, cfg)
        mem[f"{name} built"] = card_memory()
        torch.cuda.reset_peak_memory_stats()
        (tp_gpt_phase if name == "gpt3_1p3b" else tp_llama_phase)(model, cfg)
        mem[f"{name} after"] = card_memory()
        del model
    mem["end"] = card_memory()
    print(f"  (17) the card's memory (allocated / reserved / in use, MiB): "
          + "; ".join(f"{k} " + " / ".join(f"{v / 2**20:.1f}"
                                             for v in m.values())
                      for k, m in mem.items()))
    TP_NATIVE["memory"] = mem
    TP_NATIVE["seconds"] = time.monotonic() - t0


def tp_llama_phase(model, cfg):
    """(17b) Llama-7B at tp = 2, both shards on the one card, with the paged
    kernel, over the first ``TP_LLAMA_REQUESTS`` of drive (c)'s prompts,
    beside a one-device run of the same wave; with the peak memory."""
    L, V = cfg.num_layers, cfg.vocab_size
    prompts = drive_prompts(V)[:TP_LLAMA_REQUESTS]
    probe = tp_op_probe(model, B=TP_LLAMA_REQUESTS)  # the drive's bucket
    print(f"  (17b) sharded ops at B={TP_LLAMA_REQUESTS} against the "
          f"one-device ops (bit_equal, max abs): {probe}")
    ref, wall1, _, step1, _, _, eng1 = tp_serve(model, V, "17b tp1",
                                                [prompts], 0)
    mono1 = eng1._debug_prefill_paths(prompts[:4])[0]
    kl1 = eng1._debug_step_logits(prompts[:4])[0]
    eng1.close()
    del eng1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    outs, wall, steps, step_ms, counts, d, eng = tp_serve(
        model, V, "17b", [prompts], TP)
    try:
        peak = torch.cuda.max_memory_allocated() / 2**30
        mono = eng._debug_prefill_paths(prompts[:4])[0]
        kl, pl = eng._debug_step_logits(prompts[:4])
    finally:
        eng.close()
    agree, whole = token_agreement(outs, ref, prompts)
    rel = float(np.linalg.norm(kl - pl) / np.linalg.norm(pl))
    want = TP * L * steps
    row = {"requests": len(prompts), "tok_s": len(prompts) * DRIVE_NEW / wall,
           "wall_s": wall, "decode_steps": steps,
           "decode_step_ms_mean": step_ms,
           "tp1": {"tok_s": len(prompts) * DRIVE_NEW / wall1,
                   "decode_step_ms_mean": step1},
           "launches_tp": counts["paged_attention_rows"],
           "token_agreement": agree, "requests_equal": whole,
           "first_step_logits_max_abs": float(np.abs(mono - mono1).max()),
           "decode_step_logits_max_abs": float(np.abs(kl - kl1).max()),
           "shard_kernel_vs_plain_rel": rel, "peak_gib": peak,
           "card_ops": probe,
           "first_divergence": tp_first_divergence("17b", agree, probe)}
    print(f"  (17b) tp={TP} on {TP_DEVICES}: {len(prompts) * DRIVE_NEW} "
          f"tokens in {wall:.2f}s = {row['tok_s']:.1f} tok/s, decode steps "
          f"{steps}, mean decode step {step_ms:.2f} ms (one device: "
          f"{row['tp1']['tok_s']:.1f} tok/s, {step1:.2f} ms), paged launches "
          f"{row['launches_tp']} (want {want}); greedy tokens equal to "
          f"tp=1's: {agree:.4f} ({whole} of {len(prompts)} whole); max abs "
          f"logit diff first step {row['first_step_logits_max_abs']:.4e}, "
          f"one decode step {row['decode_step_logits_max_abs']:.4e}; shard "
          f"kernel step against its plain path rel {rel:.3e}; peak memory "
          f"{peak:.2f} GiB; first diverging op {row['first_divergence']}")
    if row["launches_tp"] != want:
        fail(f"tp (17b): {row['launches_tp']} paged launches, want {want}")
    if rel > LOGITS_REL_TOL:
        fail(f"tp (17b): shard kernel step rel {rel:.3e}")
    TP_NATIVE.update(llama=row)
    return row


def native_loader_check(paddle, cfg):
    """(17e) the thread-worker ``DataLoader`` over the native queue
    (``use_shared_memory=False``, ``RT_WORKERS`` threads) on 12a's data: an
    epoch of its batches must equal the serial loader's in order. Returns
    the result, and a fresh such loader with its ``DevicePrefetcher`` for
    12a's loop to take ``LOADER_STEPS`` steps from."""
    from paddle_tpu_torch.core import native

    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (RT_SEQS, 2048)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (RT_SEQS, 2048)).astype(np.int64)

    def loader(**kw):
        return paddle.io.DataLoader(
            paddle.io.TensorDataset([ids, labels]), batch_size=2,
            shuffle=True, seed=0, **kw)

    made = []
    real = native.NativeQueue

    class Counted(real):
        def __init__(self, cap):
            made.append(cap)
            super().__init__(cap)

    native.NativeQueue = Counted
    try:
        serial = [b[0].cpu() for b in loader(places="cpu")]
        threaded = [b[0].cpu() for b in loader(
            places="cpu", num_workers=RT_WORKERS, use_shared_memory=False)]
    finally:
        native.NativeQueue = real
    same = len(serial) == len(threaded) and all(
        torch.equal(a, b) for a, b in zip(serial, threaded))
    if not same or not made:
        fail(f"runtime (17e): thread-worker batches equal the serial order: "
             f"{same}; native queues made {made}")
    ld = loader(num_workers=RT_WORKERS, use_shared_memory=False)
    pf = paddle.io.DevicePrefetcher(ld, buffer_size=RT_PREFETCH)
    return {"batches_equal_serial": same, "batches": len(serial),
            "workers": RT_WORKERS, "native_queues": len(made)}, ld, pf


# -- train phase -------------------------------------------------------------

def train_arrays(cfg, B=2, T=2048, seed=0):
    """The training batch as int64 numpy (ids, labels)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int64)
    return ids, labels


def train_batch(cfg, B=2, T=2048, seed=0):
    ids, labels = train_arrays(cfg, B, T, seed)
    return torch.from_numpy(ids).cuda(), torch.from_numpy(labels).cuda()


def train_flops_per_token(cfg, n_params, T):
    """bench.py's count: 6N (forward + backward matmuls) + 6 L d T
    (attention)."""
    return 6.0 * n_params + 6.0 * cfg.num_layers * cfg.hidden_size * T


def train_model(layers=None):
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0, remat=False,
                    attention_impl="flash", fused_lm_loss=True)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return GPTForPretraining(cfg, dtype=torch.bfloat16, seed=0).train()


def grad_check_against_plain(model, ids, labels, tol, label):
    """One bf16 backward of ``model.loss`` through the flash kernels against
    the same backward with attention on the plain version (the attention
    module's ``flash_attention_array`` swapped for it); fails when a
    parameter's gradient is beyond ``tol`` by relative norm."""
    import paddle_tpu_torch.nn.functional.attention as A
    from paddle_tpu_torch.ops import kernels as K

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
    print(f"  grad check ({label}): loss kernel {losses[0]:.5f} plain "
          f"{losses[1]:.5f}; worst per-parameter rel_norm_err "
          f"{worst[0]:.3e} ({worst[1]}), tol {tol}")
    if not worst[0] <= tol or abs(losses[0] - losses[1]) > 1e-2:
        fail(f"grad check ({label}): {worst[1]} rel_err {worst[0]:.3e}, "
             f"losses {losses}")
    return {"worst_rel_err": worst[0], "worst_param": worst[1],
            "losses": losses}


def grad_check():
    """One bf16 backward of a full-width 4-layer model through the flash
    kernels against the same backward with attention on the plain
    version."""
    model = train_model(TRAIN_LAYERS_CHECK)
    ids, labels = train_batch(model.config)
    grad_check_against_plain(
        model, ids, labels, GRAD_REL_TOL,
        f"{TRAIN_LAYERS_CHECK} layers, full width, bf16")
    del model
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
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

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
    # host spans with the memory census on every train_step span
    with Profiler(targets=[ProfilerTarget.CPU], profile_memory=True):
        timed, queued, wall = time_steps(step, ids, labels, TRAIN_STEPS)
    losses += timed
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    census = profiler.memory_stats()
    spans = [sp for sp in profiler.span_events() if sp["name"] == "train_step"]
    if len(spans) != TRAIN_STEPS or not all(
            "live_bytes" in sp["attrs"] and "delta_bytes" in sp["attrs"]
            for sp in spans):
        fail(f"train: {len(spans)} train_step spans, census attrs "
             f"{[sorted(sp['attrs']) for sp in spans[:2]]}")
    print(f"  census: {TRAIN_STEPS} train_step spans, live_bytes "
          f"{[round(sp['attrs']['live_bytes'] / 2**30, 3) for sp in spans]} "
          f"GiB, delta_bytes "
          f"{[sp['attrs']['delta_bytes'] for sp in spans]}; peak_live_bytes "
          f"{census['peak_live_bytes']} against "
          f"torch.cuda.max_memory_allocated() {peak} in the same window")
    if abs(census["peak_live_bytes"] - peak) > 0.01 * peak:
        fail(f"train: peak_live_bytes {census['peak_live_bytes']} vs "
             f"max_memory_allocated {peak}")
    vals = [x.item() for x in losses]
    want = cfg.num_layers * TRAIN_STEPS
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    flops_tok = train_flops_per_token(cfg, n_params, T)
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
    ev = device_timeline(lambda: step(ids, labels), 1, "timeline (train)")
    tl = timeline_kernels(ev, tuple(FLASH_KERNELS.values()), 1)
    bad = {k: v["launches"] for k, v in tl.items()
           if v["launches"] != cfg.num_layers}
    if bad:
        fail(f"train: the device timeline of one step names {bad}, want "
             f"{cfg.num_layers} launches each")
    print(f"  timeline (train): one step: " + ", ".join(
        f"{k} {v['launches']} launches, {v['ms_per_step']:.4f} ms, "
        f"{v['us_per_launch']:.2f} us a launch" for k, v in tl.items()))
    if profile:
        device_breakdown(lambda: step(ids, labels), 2,
                         f"profile (train) b{B}xs{T}", top=14)
    del step, opt, model
    torch.cuda.empty_cache()
    compiled = {"losses": vals, "step_ms": step_ms, "tokens_per_s": tok_s,
                "mfu": tok_s * flops_tok / 989e12, "peak_gib": peak / 2**30}
    return {k: counts[k] for k in FLASH_REPLACES}, tl, compiled


# -- Paddle-API train phase ---------------------------------------------------

API_LR, API_T_MAX, API_WARMUP_STEPS, API_CLIP = 1e-4, 16, 4, 1.0
API_EAGER_STEPS = 3  # (7a): eager steps held to phase 5's compiled losses
API_CLIP_STEPS = 3  # (7b): steps whose clipped global norm is checked
API_RESUME_AT = 5  # (7c): the step after which the state is captured
API_RESUME_STEPS = 3
API_LOSS_REL_TOL = 1e-3


def api_model(paddle):
    """GPT-3 1.3B as the Paddle-API user builds it: f32 from seed 0, then
    ``bfloat16()``; under ``unique_name.guard()`` so two builds carry the
    same parameter names (the optimizer's state keys)."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b

    paddle.seed(0)
    with paddle.utils.unique_name.guard():
        model = GPTForPretraining(gpt3_1p3b(
            hidden_dropout=0.0, attention_dropout=0.0, remat=False,
            attention_impl="flash", fused_lm_loss=True))
    model.bfloat16()
    return model.train()


def api_lr_closed_form(epoch):
    """LinearWarmup(CosineAnnealingDecay(lr, T_max), warmup, 0, lr) at the
    scheduler's ``last_epoch``: linear up to ``API_WARMUP_STEPS``, then the
    cosine, whose own epoch is one at the first step after the warm-up."""
    import math

    if epoch < API_WARMUP_STEPS:
        return API_LR * epoch / API_WARMUP_STEPS
    inner = epoch - API_WARMUP_STEPS + 1
    return API_LR * (1 + math.cos(math.pi * inner / API_T_MAX)) / 2


def api_optimizer(paddle, model, clip):
    """The slice's loop's AdamW, schedule and decay list."""
    decay = [p.name for n, p in model.named_parameters()
             if not n.endswith("bias") and "ln" not in n]
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(API_LR, T_max=API_T_MAX),
        warmup_steps=API_WARMUP_STEPS, start_lr=0.0, end_lr=API_LR)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(),
        weight_decay=0.01, apply_decay_param_fun=lambda n: n in decay,
        grad_clip=clip)
    return opt, sched, decay


def rel_diff(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def api_eager_check(paddle, np_ids, np_labels, compiled):
    """(7a): a fresh model, AdamW(1e-4), no clip, no scheduler: the first
    eager steps' losses against phase 5's compiled steps' on one batch."""
    model = api_model(paddle)
    opt = paddle.optimizer.AdamW(learning_rate=API_LR,
                                 parameters=model.parameters())
    ids, labels = paddle.to_tensor(np_ids), paddle.to_tensor(np_labels)
    losses = []
    for i in range(API_EAGER_STEPS):
        loss = model.loss(ids, labels)
        loss.backward()
        if i == 0:
            exact = api_clip_exact(paddle, model.parameters())
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    got = [x.item() for x in losses]
    want = compiled["losses"][:API_EAGER_STEPS]
    err = rel_diff(got, want)
    print(f"  (7a) the global-norm clip's flat f32 multiply equals the "
          f"per-tensor f32 round trip bit for bit on {exact} bf16 gradients "
          "of the first step")
    print(f"  (7a) eager AdamW({API_LR}) losses {got} against phase 5's "
          f"compiled {want}: largest relative difference {err:.3e} (tol "
          f"{API_LOSS_REL_TOL})")
    if not err <= API_LOSS_REL_TOL:
        fail(f"paddle api (7a): eager losses {got} vs compiled {want}")
    del opt, model, loss
    torch.cuda.empty_cache()
    return {"losses": got, "compiled_losses": want, "max_rel_diff": err}


def api_clip_exact(paddle, params):
    """``ClipGradByGlobalNorm`` scales bf16 gradients by a float32 0-d scale
    in float32 (one flat multiply with a bf16 output); on the card that must
    equal the reference's arithmetic, ``(g.float() * scale).to(bf16)``
    tensor by tensor, bit for bit (the scale must not be rounded to bf16
    first). Returns the count held; fails on a mismatch."""
    from paddle_tpu_torch.nn.clip import _global_norm

    pairs = [(p, p.grad) for p in params]
    grads = [g for _, g in pairs]
    scale = API_CLIP / torch.clamp_min(_global_norm(grads), API_CLIP)
    out = paddle.nn.ClipGradByGlobalNorm(API_CLIP)(pairs)
    bad = [p.name for (p, g), (_, c) in zip(pairs, out)
           if not torch.equal(c, (g.float() * scale).to(g.dtype))]
    if bad or grads[0].dtype != torch.bfloat16:
        fail(f"paddle api (7a): the clip's bf16 products differ from the f32 "
             f"round trip on {len(bad)} gradients ({bad[:3]}), dtype "
             f"{grads[0].dtype}")
    return len(pairs)


def snapshot(state):
    """Tensors copied on their device, the rest deep-copied: a capture the
    training that goes on does not change, with no host sync. The copies
    are one multi-tensor multiply by 1.0 (exact, -0.0 and NaN kept), so the
    capture inside the timed window costs a few launches, not one a
    tensor."""
    import copy

    keys = [k for k, v in state.items() if isinstance(v, torch.Tensor)]
    copies = torch._foreach_mul([state[k].detach() for k in keys], 1.0)
    out = {k: copy.deepcopy(v) for k, v in state.items() if k not in keys}
    out.update(zip(keys, copies))
    return out


def to_cpu(state):
    import copy

    return copy.deepcopy({k: v.cpu() if isinstance(v, torch.Tensor) else v
                          for k, v in state.items()})


def api_resume(paddle, ids, labels, model_sd, opt_sd, want):
    """(7c): a fresh model, optimizer and schedule take the captured state
    through ``set_state_dict`` and run the next steps."""
    model = api_model(paddle)
    missing, unexpected = model.set_state_dict(model_sd)
    opt, sched, _ = api_optimizer(
        paddle, model, paddle.nn.ClipGradByGlobalNorm(API_CLIP))
    opt.set_state_dict(opt_sd)
    restored = sum(1 for n in opt._names if n in opt._accumulators)
    if missing or unexpected or restored != len(opt._names) \
            or sched.last_epoch != API_RESUME_AT:
        fail(f"paddle api (7c): missing {missing}, unexpected {unexpected}, "
             f"{restored}/{len(opt._names)} optimizer states restored, "
             f"schedule at epoch {sched.last_epoch}")
    losses = []
    for _ in range(API_RESUME_STEPS):
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
    got = [x.item() for x in losses]
    err = rel_diff(got, want)
    print(f"  (7c) resumed after step {API_RESUME_AT}: steps "
          f"{API_RESUME_AT + 1}-{API_RESUME_AT + API_RESUME_STEPS} losses "
          f"{got} against the uninterrupted {want}: largest relative "
          f"difference {err:.3e} (tol {API_LOSS_REL_TOL}; the embedding "
          "backward's atomics may reorder bf16 sums)")
    if not err <= API_LOSS_REL_TOL:
        fail(f"paddle api (7c): resumed losses {got} vs {want}")
    del opt, model, loss
    torch.cuda.empty_cache()
    return {"losses": got, "uninterrupted": want, "max_rel_diff": err}


def paddle_api_phase(compiled):
    """GPT-3 1.3B bf16, 24 layers, b2 x s2048 through the Paddle API:
    ``to_tensor`` ids, ``model.loss``, ``loss.backward()``, ``opt.step()``,
    ``opt.clear_grad()``, ``sched.step()`` with AdamW, a warm-up/cosine
    schedule and global-norm clipping."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn.clip import _global_norm
    from paddle_tpu_torch.ops import kernels as K

    class ProbeClip(paddle.nn.ClipGradByGlobalNorm):
        """The slice's clip; also keeps the global norm (f32, on the card)
        of its output at its first calls, and the host time of each call."""

        def __init__(self, clip_norm, calls):
            super().__init__(clip_norm)
            self.calls, self.norms, self.host_s = calls, [], []

        def __call__(self, params_grads):
            t0 = time.perf_counter()
            out = super().__call__(params_grads)
            self.host_s.append(time.perf_counter() - t0)
            if len(self.norms) < self.calls:
                self.norms.append(_global_norm([g for _, g in out]))
            return out

    from paddle_tpu_torch.models import gpt3_1p3b

    np_ids, np_labels = train_arrays(gpt3_1p3b())  # phase 5's batch
    eager = api_eager_check(paddle, np_ids, np_labels, compiled)

    t0 = time.monotonic()
    model = api_model(paddle)
    cfg = model.config
    clip = ProbeClip(API_CLIP, API_CLIP_STEPS)
    opt, sched, decay = api_optimizer(paddle, model, clip)
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    gates = [opt._wd_on(n) for n in opt._gate_names]
    bad = [p.name for p, w in zip(params, gates)
           if (w == 1.0) != (p.name in decay)]
    if opt._gate_names != [p.name for p in params] or bad:
        fail(f"paddle api (7b): the decay gate reads {opt._gate_names[:3]}..., "
             f"wrong on {bad[:5]}")
    ids, labels = paddle.to_tensor(np_ids), paddle.to_tensor(np_labels)
    if ids.dtype != paddle.int64 or ids.device != params[0].device:
        fail(f"paddle api: to_tensor gave {ids.dtype} on {ids.device}, the "
             f"model is on {params[0].device}")
    B, T = ids.shape
    torch.cuda.synchronize()
    print(f"  (7b) model: {n_params / 1e9:.3f}B params as nn.Layer, built "
          f"f32 then bfloat16() in {time.monotonic() - t0:.1f}s; "
          f"{len(decay)} of {len(params)} parameters in the decay list, the "
          f"gate reads p.name")
    lrs, losses, unclipped = [], [], []
    captured = {}
    host = {"forward_backward": [], "opt_step": [], "clear_grad_sched": []}

    def one_step(i):
        lrs.append(opt.get_lr())
        t0 = time.perf_counter()
        loss = model.loss(ids, labels)
        loss.backward()
        t1 = time.perf_counter()
        if i < API_CLIP_STEPS:  # a copy of the gradients before step()
            grads = torch._foreach_mul([p.grad for p in params], 1.0)
            unclipped.append(_global_norm(grads))
            del grads
        t2 = time.perf_counter()
        opt.step()
        t3 = time.perf_counter()
        opt.clear_grad()
        sched.step()
        t4 = time.perf_counter()
        for k, dt in zip(host, (t1 - t0, t3 - t2, t4 - t3)):
            host[k].append(dt)
        losses.append(loss.detach())
        if i + 1 == API_RESUME_AT:
            # the peak of the loop alone: the capture holds ~8 GB more
            captured["peak"] = torch.cuda.max_memory_allocated()
            captured["model"] = snapshot(model.state_dict())
            captured["opt"] = snapshot(opt.state_dict())

    for i in range(TRAIN_WARMUP):
        one_step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    mem0 = torch.cuda.memory_stats()
    t0 = time.monotonic()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        one_step(i)
    queued = time.monotonic() - t0
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launch_counts()
    mem1 = torch.cuda.memory_stats()
    # cudaMalloc calls (new segments) and allocator retries (a cudaFree of
    # the cache, which waits for the card) inside the window
    allocator = {k: mem1.get(k, 0) - mem0.get(k, 0) for k in
                 ("segment.all.allocated", "num_alloc_retries")}
    peak, peak_all = captured["peak"], torch.cuda.max_memory_allocated()
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    mfu = tok_s * train_flops_per_token(cfg, n_params, T) / 989e12
    vals = [x.item() for x in losses]
    norms = [(u.item(), c.item()) for u, c in zip(unclipped, clip.norms)]
    timed = slice(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
    host_ms = {k: float(np.mean(v[timed])) * 1e3 for k, v in host.items()}
    host_ms["clip"] = float(np.mean(clip.host_s[timed])) * 1e3
    per_step = {"opt_step": [round(v * 1e3, 2) for v in
                             host["opt_step"][timed]],
                "clip": [round(v * 1e3, 2) for v in clip.host_s[timed]]}
    print(f"  (7b) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, step "
          f"{step_ms:.2f} ms (host clock, one sync at the end; the clip "
          f"check's gradient copy runs in step {API_CLIP_STEPS} and the "
          f"capture after step {API_RESUME_AT}, both on the card), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f}, peak memory "
          f"{peak / 2**30:.2f} GiB over steps {TRAIN_WARMUP + 1}-"
          f"{API_RESUME_AT} ({peak_all / 2**30:.2f} GiB with the capture), "
          f"launches {counts}; the host queued the "
          f"steps in {queued * 1e3:.1f} ms; phase 5's compiled step "
          f"{compiled['step_ms']:.2f} ms, {compiled['tokens_per_s']:.1f} "
          f"tokens/s, MFU {compiled['mfu']:.4f}, peak "
          f"{compiled['peak_gib']:.2f} GiB")
    print(f"  (7b) host ms a timed step (queueing, no sync): " + ", ".join(
        f"{k} {v:.2f}" for k, v in host_ms.items()) + " (the clip inside "
        f"opt_step); by step {per_step}; the allocator in the window: "
        f"{allocator}")
    print(f"  (7b) losses {[round(v, 4) for v in vals]}; lrs {lrs}")
    print(f"  (7b) global norm of the gradients, unclipped -> clipped: "
          + ", ".join(f"{u:.4f} -> {c:.4f}" for u, c in norms))
    want = cfg.num_layers * TRAIN_STEPS
    bad = [k for k in ("flash_attention_fwd", "flash_attention_dq",
                       "flash_attention_dkv") if counts[k] != want]
    if bad:
        fail(f"paddle api (7b): launches {counts}, want {want} for each "
             "flash kernel")
    wrong = [(e, lr) for e, lr in enumerate(lrs)
             if abs(lr - api_lr_closed_form(e)) > 1e-12 * API_LR]
    if wrong:
        fail(f"paddle api (7b): lr at (epoch, lr) {wrong} is not the "
             "closed form")
    if len(norms) != API_CLIP_STEPS or any(
            u > API_CLIP and not c <= API_CLIP * (1 + 1e-2)
            for u, c in norms):
        fail(f"paddle api (7b): clipped norms {norms}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"paddle api (7b): losses {vals}")
    ev = device_timeline(lambda: one_step(TRAIN_WARMUP + TRAIN_STEPS), 1,
                         "timeline (paddle api)")
    tl = timeline_kernels(ev, tuple(FLASH_KERNELS.values()), 1)
    bad = {k: v["launches"] for k, v in tl.items()
           if v["launches"] != cfg.num_layers}
    if bad:
        fail(f"paddle api (7b): the device timeline of one step names {bad}, "
             f"want {cfg.num_layers} launches each")
    print(f"  (7b) timeline: one step: " + ", ".join(
        f"{k} {v['launches']} launches, {v['ms_per_step']:.4f} ms"
        for k, v in tl.items()))
    del opt, sched, model, params, clip
    torch.cuda.empty_cache()
    model_sd, opt_sd = to_cpu(captured["model"]), to_cpu(captured["opt"])
    del captured
    resume = api_resume(paddle, ids, labels, model_sd, opt_sd,
                        vals[API_RESUME_AT:API_RESUME_AT + API_RESUME_STEPS])
    out = {"eager_check": eager, "step_ms": step_ms, "tokens_per_s": tok_s,
           "mfu": mfu, "peak_gib": peak / 2**30,
           "peak_gib_with_capture": peak_all / 2**30, "queued_ms": queued * 1e3,
           "host_ms": host_ms, "host_ms_by_step": per_step,
           "allocator": allocator,
           "compiled": {k: v for k, v in compiled.items() if k != "losses"},
           "launches": {k: counts[k] for k in FLASH_REPLACES},
           "lrs": lrs, "losses": vals,
           "clip_norms": [{"unclipped": u, "clipped": c} for u, c in norms],
           "device_timeline": tl, "resume": resume}
    print(json.dumps({"paddle_api_train": out}))
    return out


# -- Llama-7B train phase ------------------------------------------------------



def llama_train_model(layers=None):
    """Llama-7B (32 layers, hidden 4096, 32 heads, FFN 11008, vocab 32000,
    untied head) in bf16 on the card, random weights from seed 0; Llama has
    no dropout."""
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_7b

    cfg = llama_7b()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return LlamaForCausalLM(cfg, dtype=torch.bfloat16, seed=0).train()


def llama_train_phase(profile=False):
    """Llama-7B bf16 at full width and depth, b1 x s2048 through
    ``jit.compile_train_step`` with AdamW(1e-4): 2 warm-up and 8 timed
    steps under the memory census, the flash counters, a device timeline of
    one more step; a 2-layer full-width model's gradients through the
    kernels against the plain attention first."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    small = llama_train_model(LLAMA_GRAD_LAYERS)
    ids, labels = train_batch(small.model.config, LLAMA_TRAIN_B,
                              LLAMA_TRAIN_T, seed=1)
    gcheck = grad_check_against_plain(
        small, ids, labels, FLASH_GRAD_REL_TOL,
        f"llama_7b, {LLAMA_GRAD_LAYERS} layers, full width, bf16")
    del small
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    model = llama_train_model()
    cfg = model.model.config
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    step = pt.jit.compile_train_step(model, lambda m, i, l: m.loss(i, l), opt)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  model: llama_7b bf16 train, {n_params / 1e9:.3f}B params, "
          f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, FFN "
          f"{cfg.ffn_size}, built in {time.monotonic() - t0:.1f}s")
    losses = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with Profiler(targets=[ProfilerTarget.CPU], profile_memory=True):
        timed, queued, wall = time_steps(step, ids, labels, TRAIN_STEPS)
    losses += timed
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    census = profiler.memory_stats()
    print(f"  census: peak_live_bytes {census['peak_live_bytes']} against "
          f"torch.cuda.max_memory_allocated() {peak} in the same window")
    if abs(census["peak_live_bytes"] - peak) > 0.01 * peak:
        fail(f"llama train: peak_live_bytes {census['peak_live_bytes']} vs "
             f"max_memory_allocated {peak}")
    vals = [x.item() for x in losses]
    B, T = ids.shape
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    flops_tok = train_flops_per_token(cfg, n_params, T)
    mfu = tok_s * flops_tok / 989e12
    print(f"  llama train: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
          f"step {step_ms:.2f} ms (host clock, one sync at the end), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (6N + 6*L*d*T = "
          f"{flops_tok:.4e} FLOP/token against 989 TFLOP/s bf16), peak "
          f"memory {peak / 2**30:.2f} GiB, launches {counts}; queued in "
          f"{queued * 1e3:.1f} ms")
    print(f"  losses: {[round(v, 4) for v in vals]}")
    want = cfg.num_layers * TRAIN_STEPS
    bad = [k for k in FLASH_REPLACES if counts[k] != want]
    if bad:
        fail(f"llama train: launches {counts}, want {want} for each flash "
             "kernel")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"llama train: losses {vals}")
    ev = device_timeline(lambda: step(ids, labels), 1,
                         "timeline (llama train)")
    tl = timeline_kernels(ev, tuple(FLASH_KERNELS.values()), 1)
    bad = {k: v["launches"] for k, v in tl.items()
           if v["launches"] != cfg.num_layers}
    if bad:
        fail(f"llama train: the device timeline of one step names {bad}, "
             f"want {cfg.num_layers} launches each")
    print(f"  timeline (llama train): one step: " + ", ".join(
        f"{k} {v['launches']} launches, {v['ms_per_step']:.4f} ms, "
        f"{v['us_per_launch']:.2f} us a launch" for k, v in tl.items()))
    if profile:
        device_breakdown(lambda: step(ids, labels), 2,
                         f"profile (llama train) b{B}xs{T}", top=14)
    del step
    print("[13c] Llama-7B through HybridParallelEngine at b"
          f"{LLAMA_OOM_B} x s{LLAMA_TRAIN_T}: a real out-of-memory, absorbed")
    oom = llama_oom_phase(model, opt, cfg)
    del opt, model
    torch.cuda.empty_cache()
    return {"oom": oom, "model": "llama_7b", "layers": cfg.num_layers,
            "batch": [B, T], "params": n_params, "step_ms": step_ms,
            "tokens_per_s": tok_s, "mfu": mfu, "peak_gib": peak / 2**30,
            "queued_ms": queued * 1e3, "losses": vals,
            "launches": {k: counts[k] for k in FLASH_REPLACES},
            "device_timeline": tl, "grad_check": gcheck}


# -- ERNIE and optimizers phase -------------------------------------------------

ERNIE_B, ERNIE_T, ERNIE_MASK_ID = 8, 512, 3
ERNIE_LR = 1e-3
OPT_STEPS = 3
OPT_LAYERS = 2
OPT_F32_TOL = 1e-6  # |card - cpu| <= tol * (1 + |cpu|), params and state


def ernie_arrays(vocab, B=ERNIE_B, T=ERNIE_T, seed=0):
    """Synthetic MLM data: 15% of the positions labelled with their token
    and masked in the input, the rest -100; NSP labels 0/1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, (B, T)).astype(np.int64)
    pick = rng.rand(B, T) < 0.15
    labels = np.where(pick, ids, -100).astype(np.int64)
    ids = np.where(pick, ERNIE_MASK_ID, ids)
    nsp = rng.randint(0, 2, (B,)).astype(np.int64)
    return ids, labels, nsp


def ln_excluder(model):
    """``exclude_from_weight_decay_fn`` that is true on the LayerNorms'
    weights and biases (it receives the parameter)."""
    from paddle_tpu_torch.nn import LayerNorm

    ln = {id(p) for m in model.sublayers() if isinstance(m, LayerNorm)
          for p in m.parameters()}
    return lambda p: id(p) in ln


OPTIMIZERS = {
    "Adamax": lambda o, ps: o.Adamax(1e-3, parameters=ps),
    "RMSProp": lambda o, ps: o.RMSProp(1e-3, momentum=0.9, centered=True,
                                       parameters=ps),
    "Adagrad": lambda o, ps: o.Adagrad(1e-2, parameters=ps),
    "Adadelta": lambda o, ps: o.Adadelta(1.0, parameters=ps),
    "Lamb": lambda o, ps: o.Lamb(1e-3, lamb_weight_decay=0.01, parameters=ps),
    "LarsMomentum": lambda o, ps: o.LarsMomentum(0.1, parameters=ps),
}


def opt_state_diff(card, cpu, opt_card, opt_cpu, bf16):
    """The largest disagreement between the card's and the CPU's
    parameters and optimizer state: f32 as |d| / (1 + |cpu|); bf16 in bf16
    ulps of each tensor's largest |cpu| value (Lamb's and LARS's bf16
    trust ratio and local lr may round one ulp apart from f32 norms summed
    in another order, and a parameter that the update nearly cancels would
    read that as many ulps of its own); and whether every dtype agrees."""
    pairs = [(a.detach(), b.detach()) for a, b in zip(card, cpu)]
    sa, sb = opt_card.state_dict(), opt_cpu.state_dict()
    if set(sa) != set(sb):
        fail(f"optimizers: state keys differ {sorted(set(sa) ^ set(sb))[:4]}")
    pairs += [(sa[k], sb[k]) for k in sa if isinstance(sa[k], torch.Tensor)]
    worst, dtypes_ok = 0.0, True
    for a, b in pairs:
        dtypes_ok &= a.dtype == b.dtype
        a, b = a.float().cpu(), b.float()
        d = (a - b).abs()
        if bf16:
            e = torch.floor(torch.log2(b.abs().max().clamp_min(2.0 ** -126)))
            d = d / torch.exp2(e - 7)
        else:
            d = d / (1 + b.abs())
        worst = max(worst, float(d.max()))
    return worst, dtypes_ok


def optimizer_checks(ids, labels, nsp):
    """Each new rule's steps on the card and on the CPU from the same
    weights, on the card's gradients of the same batch (copied to the CPU
    before each step): ``OPT_STEPS`` steps in f32, then one in bf16."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base

    cfg = ernie_3_base(num_layers=OPT_LAYERS, hidden_dropout=0.0,
                       attention_dropout=0.0)
    base = ErnieForPretraining(cfg, seed=0).train()
    base_sd = {k: v.detach().cpu().clone() for k, v in base.state_dict().items()}
    del base
    out = {}
    for name, make in OPTIMIZERS.items():
        for dtype, steps in ((torch.float32, OPT_STEPS), (torch.bfloat16, 1)):
            card = ErnieForPretraining(cfg, seed=0).train()
            card.load_state_dict(base_sd)
            card.to(dtype=dtype)
            cpu = [p.detach().cpu().clone().requires_grad_()
                   for p in card.parameters()]
            names = [n for n, _ in card.named_parameters()]
            oc = make(pt.optimizer, list(zip(names, card.parameters())))
            oh = make(pt.optimizer, list(zip(names, cpu)))
            worst = []
            for _ in range(steps):
                card.zero_grad(set_to_none=True)
                card.loss(ids, labels, nsp).backward()
                for p, q in zip(card.parameters(), cpu):
                    q.grad = p.grad.detach().cpu().to(q.dtype)
                oc.step()
                oh.step()
                w, same_dt = opt_state_diff(list(card.parameters()), cpu, oc,
                                            oh, dtype == torch.bfloat16)
                if not same_dt:
                    fail(f"optimizers ({name}, {dtype}): the card's and the "
                         "CPU's dtypes differ")
                worst.append(w)
            tol = 1.0 if dtype == torch.bfloat16 else OPT_F32_TOL
            key = f"{name}_{str(dtype)[6:]}"
            out[key] = {"worst": worst, "tol": tol,
                        "param_dtype": str(card.parameters()[0].dtype)[6:]}
            print(f"  {key}: {steps} step(s), worst card-vs-CPU disagreement "
                  f"{['%.3e' % w for w in worst]} "
                  f"({'bf16 ulps' if tol == 1.0 else 'rel'}; tol {tol}); "
                  f"parameters now {out[key]['param_dtype']}")
            if max(worst) > tol:
                fail(f"optimizers ({key}): card and CPU disagree by "
                     f"{max(worst):.3e}")
            del card, cpu, oc, oh
            torch.cuda.empty_cache()
    return out


def ernie_phase(profile=False):
    """ERNIE-3.0 base f32 (dropout 0.1) in the eager Paddle loop with Lamb,
    LayerNorm parameters excluded from the decay, on synthetic MLM + NSP
    data; then the six new optimizers card against CPU."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base

    cfg = ernie_3_base()
    t0 = time.monotonic()
    model = ErnieForPretraining(cfg, seed=0).train()
    n_params = sum(p.numel() for p in model.parameters())
    opt = pt.optimizer.Lamb(learning_rate=ERNIE_LR, lamb_weight_decay=0.01,
                            parameters=model.parameters(),
                            exclude_from_weight_decay_fn=ln_excluder(model))
    np_ids, np_labels, np_nsp = ernie_arrays(cfg.vocab_size)
    ids, labels, nsp = (pt.to_tensor(a) for a in (np_ids, np_labels, np_nsp))
    torch.cuda.synchronize()
    print(f"  model: ernie_3_base f32 train, {n_params / 1e6:.1f}M params, "
          f"{cfg.num_layers} layers, hidden {cfg.hidden_size}, dropout "
          f"{cfg.hidden_dropout}, built in {time.monotonic() - t0:.1f}s; "
          f"{int((np_labels != -100).sum())} labelled positions of "
          f"{np_labels.size}")

    def one_step():
        loss = model.loss(ids, labels, nsp)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    losses = [one_step() for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed, queued, wall = time_steps(lambda *_: one_step(), None, None,
                                     TRAIN_STEPS)
    vals = [x.item() for x in losses + timed]
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = ERNIE_B * ERNIE_T * TRAIN_STEPS / wall
    print(f"  ernie train: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up "
          f"(eager loop, Lamb lr {ERNIE_LR}), step {step_ms:.2f} ms, "
          f"{tok_s:.1f} tokens/s, queued in {queued * 1e3:.1f} ms, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  losses: {[round(v, 4) for v in vals]}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"ernie train: losses {vals}")
    if profile:
        device_breakdown(one_step, 2,
                         f"profile (ernie train) b{ERNIE_B}xs{ERNIE_T}",
                         top=10)
    del model, opt
    torch.cuda.empty_cache()
    # the optimizer checks take a slice of the batch (b2 x s128)
    checks = optimizer_checks(pt.to_tensor(np_ids[:2, :128]),
                              pt.to_tensor(np_labels[:2, :128]),
                              pt.to_tensor(np_nsp[:2]))
    return {"model": "ernie_3_base", "params": n_params,
            "batch": [ERNIE_B, ERNIE_T], "step_ms": step_ms,
            "tokens_per_s": tok_s, "queued_ms": queued * 1e3,
            "losses": vals, "optimizers": checks}


# -- training runtime phase ------------------------------------------------------

RT_SEQS = 2 * 16  # 16 batches of b2 x s2048: 2 + 8 steps, 2 traced, 1 trip
RT_TIMELINE_STEPS = 2
RT_WORKERS = 2
RT_PREFETCH = 2
RT_SENTINEL_WARMUP = 4
RT_SPIKE = 10000  # grad.spike's scale on the trip step
RT_SCALER_INIT = 2.0 ** 15
RT_RESUME_AT = 5  # (12b): the step after which the guard is preempted
RT_RESUME_STEPS = 3  # (12b): steps 6-8 again after the resume
RT_LOSS_REL_TOL = 1e-3


def rt_loader(paddle, cfg, profile):
    """(12a) synthetic token rows from seed 0 through ``io.DataLoader``
    (seeded shuffle, forked workers) and ``io.DevicePrefetcher``."""
    n = RT_SEQS + (4 if profile else 0)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (n, 2048)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (n, 2048)).astype(np.int64)
    loader = paddle.io.DataLoader(
        paddle.io.TensorDataset([ids, labels]), batch_size=2, shuffle=True,
        seed=0, num_workers=RT_WORKERS)
    return loader, paddle.io.DevicePrefetcher(loader, buffer_size=RT_PREFETCH)


def rt_copy_overlap(ev_full, compute_streams):
    """(12a) the host-to-device copies of a device timeline on streams other
    than the compute streams (the prefetcher's), their streams and bytes,
    and how many of them overlap a compute-stream kernel in time; beside
    them the host-to-device copies on the compute streams."""
    copies = [e for e in ev_full if "HtoD" in e["name"]]
    side = [c for c in copies if c["stream"] not in compute_streams]
    kernels = [e for e in ev_full if e["stream"] in compute_streams
               and "Memcpy" not in e["name"]]
    overlap = sum(1 for c in side if any(
        k["start_ns"] < c["end_ns"] and c["start_ns"] < k["end_ns"]
        for k in kernels))
    return {"prefetch_copies": len(side),
            "prefetch_streams": sorted({c["stream"] for c in side}),
            "prefetch_names": sorted({c["name"] for c in side}),
            "overlapping_compute": overlap,
            "compute_stream_copies": len(copies) - len(side)}


def gpt_amp_phase(paddle, api, profile=False):
    """(12a) GPT-3 1.3B with f32 parameters under ``amp.auto_cast(O1,
    bfloat16)`` by phase 7's loop, fed by DataLoader -> DevicePrefetcher,
    each step judged by the stability sentinel; then one skip trip."""
    import paddle_tpu_torch.nn.functional as F
    import paddle_tpu_torch.nn.functional.attention as A
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.fault.sentinel import StabilitySentinel
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.profiler import Profiler, ProfilerTarget

    t0 = time.monotonic()
    paddle.seed(0)
    with paddle.utils.unique_name.guard():
        model = GPTForPretraining(gpt3_1p3b(
            hidden_dropout=0.0, attention_dropout=0.0, remat=False,
            attention_impl="flash", fused_lm_loss=True)).train()
    cfg = model.config
    params = model.parameters()
    n_params = sum(p.numel() for p in params)
    if {p.dtype for p in params} != {torch.float32}:
        fail("runtime (12a): the parameters are not all float32")
    opt, sched, _ = api_optimizer(paddle, model,
                                  paddle.nn.ClipGradByGlobalNorm(API_CLIP))
    loader, pf = rt_loader(paddle, cfg, profile)
    sentinel = StabilitySentinel(warmup=RT_SENTINEL_WARMUP, name="gpt_amp")
    torch.cuda.synchronize()
    print(f"  (12a) model: {n_params / 1e9:.3f}B float32 parameters, built "
          f"in {time.monotonic() - t0:.1f}s; {len(loader)} batches from "
          f"DataLoader(seed=0, num_workers={RT_WORKERS}) through "
          f"DevicePrefetcher(buffer_size={RT_PREFETCH})")
    host = {"wait": [], "sentinel": []}
    losses, verdicts, seen = [], [], {}

    def spy_flash(q, k, v, causal=False):
        seen.setdefault("qkv", (q.detach(), k.detach(), v.detach()))
        return flash_fn(q, k, v, causal=causal)

    def spy_ce(x, w, labels, *a, **kw):
        seen.setdefault("ce", (x.dtype, w.dtype))
        return ce_fn(x, w, labels, *a, **kw)

    def one_step(i, trip=False):
        pos = tuple(pf.state_dict()[k] for k in ("epoch", "batch_idx"))
        t0 = time.perf_counter()
        ids, labels = next(pf)
        host["wait"].append(time.perf_counter() - t0)
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model.loss(ids, labels)
        loss.backward()
        if trip:
            spiked = sentinel.maybe_spike([p.grad for p in params], step=i)
            for p, g in zip(params, spiked):
                p.grad = g
        t0 = time.perf_counter()
        v = sentinel.observe(
            i, loss, [p.grad for p in params], params, lr=opt.get_lr(),
            pos=pos, indices_fn=lambda: loader.batch_indices(*pos))
        host["sentinel"].append(time.perf_counter() - t0)
        if v is None:
            opt.step()
            sched.step()
        else:
            verdicts.append(v)
        opt.clear_grad()
        losses.append(loss.detach())
        return pos, v

    flash_fn, ce_fn = A.flash_attention_array, F.fused_linear_cross_entropy
    A.flash_attention_array, F.fused_linear_cross_entropy = spy_flash, spy_ce
    try:
        one_step(0)
    finally:
        A.flash_attention_array, F.fused_linear_cross_entropy = flash_fn, ce_fn
    for i in range(1, TRAIN_WARMUP):
        one_step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.monotonic()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        one_step(i)
    queued = time.monotonic() - t0
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = 2 * 2048 * TRAIN_STEPS / wall
    mfu = tok_s * train_flops_per_token(cfg, n_params, 2048) / 989e12
    timed = slice(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS)
    host_ms = {k: float(np.mean(v[timed])) * 1e3 for k, v in host.items()}
    vals = [x.item() for x in losses]
    want = cfg.num_layers * TRAIN_STEPS
    print(f"  (12a) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, f32 "
          f"parameters under auto_cast(O1, bfloat16): step {step_ms:.2f} ms "
          f"(host clock, one sync at the end; the sentinel reads 4 floats "
          f"back each step), {tok_s:.1f} tokens/s, MFU {mfu:.4f}, peak "
          f"memory {peak / 2**30:.2f} GiB, the host queued the steps in "
          f"{queued * 1e3:.1f} ms; host ms a step: waiting on the "
          f"prefetcher {host_ms['wait']:.3f}, the sentinel's observe "
          f"{host_ms['sentinel']:.2f}; launches {counts}")
    print(f"  (12a) beside phase 7's bf16-parameter step: {api['step_ms']:.2f} "
          f"ms, {api['tokens_per_s']:.1f} tokens/s, MFU {api['mfu']:.4f}, "
          f"peak {api['peak_gib']:.2f} GiB")
    print(f"  (12a) losses {[round(v, 4) for v in vals]}")
    q_dt = seen["qkv"][0].dtype
    print(f"  (12a) under O1 the flash kernels got {q_dt} q/k/v and the "
          f"fused CE {seen['ce'][0]} x with a {seen['ce'][1]} weight (its "
          "full-f32 branch: layer_norm is on the black list)")
    if q_dt != torch.bfloat16 or seen["ce"] != (torch.float32, torch.float32):
        fail(f"runtime (12a): flash q/k/v {q_dt}, fused CE {seen['ce']}")
    bad = [k for k in FLASH_KERNELS if counts[k] != want]
    if bad:
        fail(f"runtime (12a): launches {counts}, want {want} for each flash "
             "kernel")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0] or verdicts:
        fail(f"runtime (12a): losses {vals}, sentinel verdicts {verdicts}")
    # the device timeline: the flash kernels on the compute stream, the
    # batches' copies on the prefetch stream beside them
    with Profiler(targets=[ProfilerTarget.GPU]) as prof:
        for i in range(RT_TIMELINE_STEPS):
            one_step(TRAIN_WARMUP + TRAIN_STEPS + i)
    ev_full = prof.device_events()
    ev = [(e["start_ns"], e["end_ns"], e["name"]) for e in ev_full]
    tl = timeline_kernels(ev, tuple(FLASH_KERNELS.values()),
                          RT_TIMELINE_STEPS)
    compute = {e["stream"] for e in ev_full if "fwd_wgmma" in e["name"]}
    copies = rt_copy_overlap(ev_full, compute)
    print(f"  (12a) timeline of {RT_TIMELINE_STEPS} steps: " + ", ".join(
        f"{k} {v['launches']} launches" for k, v in tl.items())
        + f"; compute streams {sorted(compute)}; host-to-device copies "
        f"{copies}")
    if any(v["launches"] != cfg.num_layers * RT_TIMELINE_STEPS
           for v in tl.values()) or copies["prefetch_copies"] < 2 \
            or not copies["overlapping_compute"]:
        fail(f"runtime (12a): timeline {tl}, copies {copies}")
    if profile:
        device_breakdown(lambda: one_step(len(losses)), 2,
                         "profile (runtime train, gpt O1) b2xs2048", top=12,
                         watch=("Memcpy",))
    # the flash kernels on layer 0's own bf16 q/k/v, against the plain ones
    B, T, H, D = seen["qkv"][0].shape
    amp_errs = flash_check(B, T, T, H, D, True, torch.bfloat16,
                           fused_qkv=True, qkv=seen.pop("qkv"))
    # one skip trip: grad.spike x RT_SPIKE on the next batch
    trip_step = len(losses)
    inject.arm(f"grad.spike:step={trip_step},scale={RT_SPIKE}")
    try:
        with torch.no_grad():
            before = torch._foreach_mul(params, 1.0)
        torch.cuda.synchronize()
        pos, v = one_step(trip_step, trip=True)
        same = all(torch.equal(a, p) for a, p in zip(before, params))
        fired = inject.fired_counts()
    finally:
        inject.disarm()
    del before
    q = sentinel.quarantine.entries()
    print(f"  (12a) skip trip at step {trip_step} (grad.spike x{RT_SPIKE}, "
          f"fired {fired}): verdict {v}; parameters bit-equal across the "
          f"step: {same}; quarantined {q}")
    if v is None or (v.action, v.signal) != ("skip", "grad_norm") \
            or not same or not sentinel.is_quarantined(pos=pos) \
            or q[-1]["sample_indices"] != loader.batch_indices(*pos):
        fail(f"runtime (12a): trip verdict {v}, parameters equal {same}, "
             f"quarantine {q}")
    # (17e) the same loop fed by the thread-worker loader over the native
    # queue; its batches' order first
    t17 = time.monotonic()
    native_info, native_loader, native_pf = native_loader_check(paddle, cfg)
    pf.close()
    loader, pf = native_loader, native_pf  # what one_step reads
    n0 = len(host["wait"])
    for _ in range(LOADER_STEPS):
        one_step(len(losses))
    torch.cuda.synchronize()
    waits = [w * 1e3 for w in host["wait"][n0:]]
    native_info.update(steps=LOADER_STEPS, host_wait_ms=waits,
                       losses=[x.item() for x in losses[-LOADER_STEPS:]],
                       seconds=time.monotonic() - t17)
    print(f"  (17e) 12a's loop over the thread-worker DataLoader "
          f"({RT_WORKERS} threads, NativeQueue): an epoch of "
          f"{native_info['batches']} batches equal to the serial order; "
          f"{LOADER_STEPS} steps, host ms waiting on the prefetcher "
          f"{[round(w, 3) for w in waits]}, losses "
          f"{[round(v, 4) for v in native_info['losses']]}")
    if not all(np.isfinite(native_info["losses"])):
        fail(f"runtime (17e): losses {native_info['losses']}")
    TP_NATIVE.update(loader=native_info)
    sentinel.close()
    pf.close()
    del opt, sched, model, params, pf, loader
    torch.cuda.empty_cache()
    return {"model": "gpt3_1p3b", "params": n_params, "batch": [2, 2048],
            "param_dtype": "float32", "amp": "O1 bfloat16",
            "step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
            "peak_gib": peak / 2**30, "queued_ms": queued * 1e3,
            "host_ms": host_ms, "losses": vals,
            "launches": {k: counts[k] for k in FLASH_REPLACES},
            "device_timeline": tl, "h2d_copies": copies,
            "flash_check_max_abs_err": amp_errs,
            "fused_ce_dtypes": [str(d)[6:] for d in seen["ce"]],
            "trip": {"step": trip_step, "verdict": v.to_dict(),
                     "params_bit_equal": same, "quarantine": q[-1]},
            "bf16_params_step": {k: api[k] for k in
                                 ("step_ms", "tokens_per_s", "mfu",
                                  "peak_gib")}}


class RtCheckpoint:
    """(12b) ``PreemptionGuard``'s checkpoint: ``save_now`` writes the state
    tree's ``state_dict()``s (and plain values) with ``paddle.save``."""

    def __init__(self, paddle, path):
        self.paddle, self.path, self.saves = paddle, path, []

    def save_now(self, step, state, sync=True):
        t0 = time.monotonic()
        tree = {k: v.state_dict() if hasattr(v, "state_dict") else v
                for k, v in state.items()}
        self.paddle.save({"step": step, **tree}, self.path)
        self.saves.append({"step": step, "sync": sync,
                           "ms": (time.monotonic() - t0) * 1e3,
                           "bytes": os.path.getsize(self.path)})


def rt_ernie(paddle, seed):
    """(12b) phase 9's model, Lamb, loader over phase 9's batch (one
    seeded-shuffle batch an epoch) and a GradScaler, built under
    ``unique_name.guard()`` (the optimizer's state keys)."""
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base

    with paddle.utils.unique_name.guard():
        model = ErnieForPretraining(ernie_3_base(), seed=seed).train()
    opt = paddle.optimizer.Lamb(
        learning_rate=ERNIE_LR, lamb_weight_decay=0.01,
        parameters=model.parameters(),
        exclude_from_weight_decay_fn=ln_excluder(model))
    arrays = ernie_arrays(model.config.vocab_size)
    loader = paddle.io.DataLoader(paddle.io.TensorDataset(list(arrays)),
                                  batch_size=ERNIE_B, shuffle=True, seed=0)
    scaler = paddle.amp.GradScaler(init_loss_scaling=RT_SCALER_INIT)
    return model, opt, loader, scaler


def rt_batches(loader):
    """The loader's batches, epoch after epoch (its position rolls to the
    next epoch as each one ends)."""
    while True:
        yield from loader


def rt_ernie_step(paddle, model, opt, batches, scaler):
    """One fp16 O1 step on the next batch; (loss, stepped)."""
    ids, labels, nsp = next(batches)
    with paddle.amp.auto_cast(level="O1", dtype="float16"):
        loss = model.loss(ids, labels, nsp)
    scaler.scale(loss).backward()
    scaler.step(opt)
    stepped = not scaler._found_inf
    scaler.update()
    opt.clear_grad()
    return loss.detach(), stepped


def rt_unscale_bits():
    """(12b) ``GradScaler``'s unscale on the card against a float32 CPU
    division, bit for bit, at a scale that is not a power of two."""
    from paddle_tpu_torch.amp import _unscale_grads

    g = torch.randn(1 << 20, generator=torch.Generator().manual_seed(0))
    p = torch.nn.Parameter(torch.zeros(1 << 20, device="cuda"))
    p.grad = g.cuda()
    found = _unscale_grads([p], 3.0 * 2 ** 13)
    want = torch.div(g, torch.tensor(3.0 * 2 ** 13))
    same = torch.equal(p.grad.cpu().view(torch.int32), want.view(torch.int32))
    if found or not same:
        fail(f"runtime (12b): unscale on the card differs from the CPU "
             f"division (found_inf {found})")
    return same


def ernie_amp_phase(paddle, ernie, profile=False):
    """(12b) ERNIE-3.0 base, f32 parameters under ``auto_cast(O1,
    float16)`` with a GradScaler; then a preemption after step 5, a
    checkpoint through ``paddle.save`` and a resume through
    ``paddle.load`` that must replay the next ``RT_RESUME_STEPS`` steps."""
    from paddle_tpu_torch.core import random as random_state
    from paddle_tpu_torch.fault import PreemptionGuard, RESUMABLE_EXIT_CODE

    bits_ok = rt_unscale_bits()
    paddle.seed(0)
    model, opt, loader, scaler = rt_ernie(paddle, 0)
    batches = rt_batches(loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, scales, stepped = [], [], []
    t0 = time.monotonic()
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            torch.cuda.synchronize()
            t0 = time.monotonic()
        loss, ok = rt_ernie_step(paddle, model, opt, batches, scaler)
        losses.append(loss)
        scales.append(scaler.get_scale())
        stepped.append(ok)
    torch.cuda.synchronize()
    n = TRAIN_STEPS
    wall = time.monotonic() - t0
    step_ms = wall / n * 1e3
    tok_s = ERNIE_B * ERNIE_T * n / wall
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses]
    skipped = [i for i, ok in enumerate(stepped) if not ok]
    print(f"  (12b) ernie_3_base f32 parameters under auto_cast(O1, "
          f"float16) with GradScaler(init_loss_scaling={RT_SCALER_INIT:g}): "
          f"{n} steps after {TRAIN_WARMUP}, step {step_ms:.2f} ms (each "
          f"step syncs once on the scaler's non-finite flag), "
          f"{tok_s:.1f} tokens/s, peak {peak / 2**30:.2f} GiB; phase 9's "
          f"f32 step {ernie['step_ms']:.2f} ms, {ernie['tokens_per_s']:.1f} "
          f"tokens/s")
    print(f"  (12b) scale after each step {scales}; steps skipped for inf "
          f"{skipped}; unscale bit-equal to a CPU division: {bits_ok}")
    print(f"  (12b) losses {[round(v, 4) for v in vals]}; phase 9's f32 "
          f"losses {[round(v, 4) for v in ernie['losses']]}")
    if not all(np.isfinite(vals)):
        fail(f"runtime (12b): losses {vals}")
    if profile:
        device_breakdown(
            lambda: rt_ernie_step(paddle, model, opt, batches, scaler), 2,
            f"profile (runtime train, ernie O1 fp16) b{ERNIE_B}xs{ERNIE_T}",
            top=10)
    del model, opt, loader, batches, scaler, losses
    torch.cuda.empty_cache()
    # the same run, preempted after step RT_RESUME_AT
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_ckpt_")
    try:
        ckpt = RtCheckpoint(paddle, os.path.join(tmp, "state.pdckpt"))
        codes = []
        paddle.seed(0)
        model, opt, loader, scaler = rt_ernie(paddle, 0)
        batches = rt_batches(loader)
        with PreemptionGuard(checkpoint=ckpt, exit_fn=codes.append) as guard:
            for i in range(RT_RESUME_AT + 1):
                rt_ernie_step(paddle, model, opt, batches, scaler)
                if i == RT_RESUME_AT:
                    guard.preempt()
                state = {"model": model, "opt": opt, "scaler": scaler,
                         "loader": loader,
                         "rng": random_state.get_rng_state()}
                if guard.check(i, state):
                    break
        del model, opt, loader, batches, scaler, state
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        sd = paddle.load(ckpt.path)
        load_ms = (time.monotonic() - t0) * 1e3
        model, opt, loader, scaler = rt_ernie(paddle, 1)  # other weights
        missing, unexpected = model.set_state_dict(sd["model"])
        opt.set_state_dict(sd["opt"])
        scaler.load_state_dict(sd["scaler"])
        loader.load_state_dict(sd["loader"])
        random_state.set_rng_state(sd["rng"])
        batches = rt_batches(loader)
        got = [rt_ernie_step(paddle, model, opt, batches, scaler)[0].item()
               for _ in range(RT_RESUME_STEPS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = vals[RT_RESUME_AT + 1:RT_RESUME_AT + 1 + RT_RESUME_STEPS]
    err = rel_diff(got, want)
    save = ckpt.saves[0] if ckpt.saves else {}
    print(f"  (12b) preempted after step {RT_RESUME_AT}: exit codes {codes}, "
          f"{len(ckpt.saves)} save(s), sync {save.get('sync')}; the file "
          f"{save.get('bytes', 0) / 2**20:.1f} MiB, saved in "
          f"{save.get('ms', 0):.1f} ms, loaded in {load_ms:.1f} ms; resumed "
          f"steps {RT_RESUME_AT + 1}-{RT_RESUME_AT + RT_RESUME_STEPS} "
          f"losses {got} "
          f"against the uninterrupted {want}: largest relative difference "
          f"{err:.3e} (tol {RT_LOSS_REL_TOL})")
    if codes != [RESUMABLE_EXIT_CODE] or len(ckpt.saves) != 1 \
            or sd["step"] != RT_RESUME_AT or missing or unexpected \
            or not err <= RT_LOSS_REL_TOL:
        fail(f"runtime (12b): exit codes {codes}, saves {ckpt.saves}, "
             f"missing {missing}, unexpected {unexpected}, resumed losses "
             f"{got} vs {want}")
    del model, opt, loader, batches, scaler, sd
    torch.cuda.empty_cache()
    return {"model": "ernie_3_base", "batch": [ERNIE_B, ERNIE_T],
            "param_dtype": "float32", "amp": "O1 float16",
            "step_ms": step_ms, "tokens_per_s": tok_s,
            "peak_gib": peak / 2**30, "scales": scales,
            "skipped_steps": skipped, "losses": vals,
            "f32_losses": ernie["losses"],
            "f32_step": {k: ernie[k] for k in ("step_ms", "tokens_per_s")},
            "unscale_bit_equal": bits_ok,
            "resume": {"after_step": RT_RESUME_AT, "exit_codes": codes,
                       "file_bytes": save.get("bytes"),
                       "save_ms": save.get("ms"), "load_ms": load_ms,
                       "losses": got, "uninterrupted": want,
                       "max_rel_diff": err}}


def runtime_phase(api, ernie, profile=False):
    """Phase 12: the training runtime (amp, io, save/load, fault)."""
    import paddle_tpu_torch as paddle

    gpt = gpt_amp_phase(paddle, api, profile)
    ern = ernie_amp_phase(paddle, ernie, profile)
    out = {"gpt_o1_bf16": gpt, "ernie_o1_fp16": ern}
    print(json.dumps({"runtime_train": out}))
    return out


# -- dense generation phase ------------------------------------------------------

GEN_PROMPTS, GEN_LLAMA_PROMPTS, GEN_T0, GEN_NEW = 4, 2, 128, 32
GEN_TIE_GAP = 1e-2  # top-two logits this close may break either way


def gen_timed(fn):
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def gen_well_formed(tag, prompts, out, vocab):
    o = out.cpu().numpy()
    if o.shape != (prompts.shape[0], GEN_T0 + GEN_NEW) or not (
            o[:, :GEN_T0] == prompts).all() or not (
            (o >= 0) & (o < vocab)).all():
        fail(f"generate ({tag}): output {o.shape} malformed")
    return o


def gen_engine_oracle(tag, model, prompts, dense, vocab):
    """The dense prefill's last-position logits against the engine's
    monolithic prefill's, and the first generated token of each row against
    the engine's greedy one (rows whose engine logits have their top two
    within ``GEN_TIE_GAP`` may differ; they are printed); returns the share
    of all greedy tokens equal to the engine's."""
    from paddle_tpu_torch.models import generation as G
    from paddle_tpu_torch.serving import Engine

    from paddle_tpu_torch.framework.flags import set_flags

    plist = [p.tolist() for p in prompts]
    # the serving main path's decode: the paged kernel, dense weights
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})
    with Engine(model, **ENGINE_KW) as eng:
        handles = [eng.submit(p, max_new_tokens=GEN_NEW) for p in plist]
        served = np.asarray([h.result(timeout=900) for h in handles])
        mono, _, _ = eng._debug_prefill_paths(plist)
    state = (G.gpt_decode_state if tag.startswith("gpt")
             else G.llama_decode_state)(model)
    with torch.inference_mode():
        ids = torch.from_numpy(prompts).cuda()
        _, logits = G._prefill_dense(state[1], state[2], ids, GEN_T0,
                                     GEN_T0 + GEN_NEW)
    rel = logits_rel(tag, "dense prefill vs engine prefill",
                     logits.float().cpu().numpy(), mono)[0]
    ties = []
    for r in range(len(plist)):
        if dense[r, GEN_T0] != served[r, GEN_T0]:
            top2 = np.sort(mono[r])[-2:]
            gap = float(top2[1] - top2[0])
            ties.append({"row": r, "gap": gap})
            print(f"  generate ({tag}): row {r} first token {dense[r, GEN_T0]}"
                  f" vs engine {served[r, GEN_T0]}, engine top-two gap {gap:.3e}")
            if gap > GEN_TIE_GAP:
                fail(f"generate ({tag}): row {r}'s first token differs from "
                     "the engine's")
    share = float((dense[:, GEN_T0:] == served[:, GEN_T0:]).mean())
    print(f"  generate ({tag}): share of greedy tokens equal to the engine's "
          f"{share:.4f}")
    return {"prefill_rel_err": rel, "first_token_ties": ties,
            "engine_equal_share": share}


def seq_logprob(model, seqs):
    """Sum of the f32 log-probs of each row's generated tokens."""
    with torch.inference_mode():
        ids = torch.from_numpy(seqs).cuda()
        logp = torch.log_softmax(model(ids).float(), -1)
        tok = ids[:, GEN_T0:]
        got = logp[:, GEN_T0 - 1:-1].gather(-1, tok[..., None])[..., 0]
        return got.sum(-1).cpu().numpy()


def generation_phase():
    """GPT-3 1.3B: greedy, beam 4 and sampled dense generation of 4 prompts
    of 128 tokens; an eos run; Llama-7B greedy on 2 prompts."""
    from paddle_tpu_torch.models import generation as G

    out = {}
    for name, cfg, _, _ in engine_models():
        t0 = time.monotonic()
        model = build_engine_model(name, cfg)
        n = GEN_PROMPTS if name == "gpt3_1p3b" else GEN_LLAMA_PROMPTS
        prompts = np.random.RandomState(7).randint(
            0, cfg.vocab_size, (n, GEN_T0)).astype(np.int64)
        print(f"  model: {name} bf16 eval, built in "
              f"{time.monotonic() - t0:.1f}s; {n} prompts of {GEN_T0}")
        calls = {"greedy": dict(do_sample=False)}
        if name == "gpt3_1p3b":
            g = torch.Generator(device="cuda").manual_seed(0)
            calls["beam4"] = dict(do_sample=False, num_beams=4)
            calls["sampled"] = dict(do_sample=True, top_k=50, top_p=0.9,
                                    generator=g)
        res, outs = {}, {}
        for tag, kw in calls.items():
            gen, wall = gen_timed(lambda: model.generate(
                prompts, max_new_tokens=GEN_NEW, **kw))
            steps = G.last_decode_steps()
            outs[tag] = gen_well_formed(f"{name} {tag}", prompts, gen,
                                        cfg.vocab_size)
            res[tag] = {"tokens_per_s": n * GEN_NEW / wall,
                        "step_ms": wall / steps * 1e3, "steps": steps}
            print(f"  generate ({name} {tag}): {n} x {GEN_NEW} tokens in "
                  f"{wall * 1e3:.1f} ms, {res[tag]['tokens_per_s']:.1f} "
                  f"tokens/s, {res[tag]['step_ms']:.2f} ms a step (prefill "
                  f"included), {steps} steps")
        res["engine"] = gen_engine_oracle(name, model, prompts,
                                          outs["greedy"], cfg.vocab_size)
        if name == "gpt3_1p3b":
            eos = int(outs["greedy"][0, GEN_T0 + 2])
            e = model.generate(prompts[:1], max_new_tokens=GEN_NEW,
                               do_sample=False, eos_token_id=eos).cpu().numpy()
            steps = G.last_decode_steps()
            first = list(outs["greedy"][0, GEN_T0:]).index(eos)
            print(f"  generate ({name} eos {eos}): {steps} steps of "
                  f"{GEN_NEW}, tail all eos: "
                  f"{bool((e[0, GEN_T0 + first:] == eos).all())}")
            if not steps == first + 1 < GEN_NEW or not (
                    e[0, GEN_T0 + first:] == eos).all():
                fail(f"generate ({name}): eos run took {steps} steps")
            res["eos"] = {"steps": steps, "max_new_tokens": GEN_NEW}
            model.float()
            lp_beam = seq_logprob(model, outs["beam4"])
            lp_greedy = seq_logprob(model, outs["greedy"])
            print(f"  generate ({name}): f32 sum log-prob of the generated "
                  f"tokens, beam 4 {np.round(lp_beam, 3).tolist()} vs greedy "
                  f"{np.round(lp_greedy, 3).tolist()}")
            res["logprob"] = {"beam4": lp_beam.tolist(),
                              "greedy": lp_greedy.tolist()}
        out[name] = res
        del model
        torch.cuda.empty_cache()
    return out


# -- nan/inf scan phase --------------------------------------------------------

def naninf_phase():
    """``FLAGS_check_nan_inf`` on a 2-layer full-width GPT-3 1.3B forward:
    with one weight NaN it must raise naming the op, write a ``naninf``
    flight dump and count one trip; cleared, the forward runs and no
    dispatch mode is left; the forward's ms with the flag on and off."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.models import gpt3_1p3b
    from paddle_tpu_torch.profiler import flight

    cfg = dataclasses.replace(gpt3_1p3b(hidden_dropout=0.0,
                                        attention_dropout=0.0), num_layers=2)
    model = build_engine_model("gpt3_1p3b", cfg)
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 512))).cuda()
    w = model.gpt.layers[0].mlp.up.weight

    def forward():
        with torch.no_grad():
            return model(ids)

    def ms(n=5):
        forward()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            forward()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / n * 1e3

    off_ms = ms()
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        on_ms = ms()
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    saved = w[0, 0].item()
    with torch.no_grad():  # poisoned with the flag off: the write is an op
        w[0, 0] = float("nan")
    c0 = profiler.counters().get("naninf_trips", 0)
    set_flags({"FLAGS_check_nan_inf": True})
    try:
        forward()
    except FloatingPointError as e:
        msg = str(e)
    else:
        fail("nan/inf scan: a NaN weight did not raise")
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    trips = profiler.counters().get("naninf_trips", 0) - c0
    dump = flight.last_dump()
    if dispatch.scan_active():
        fail("nan/inf scan: a dispatch mode is left with the flag cleared")
    print(f"  raised: {msg}")
    doc = json.load(open(dump)) if dump and os.path.exists(dump) else {}
    if not msg.startswith("Operator 'aten.") or trips != 1 or \
            doc.get("reason") != "naninf" or doc.get("extra", {}).get(
                "message") != msg:
        fail(f"nan/inf scan: trips {trips}, dump {dump}")
    bad = forward()  # the flag off: the same forward runs, NaN and all
    with torch.no_grad():
        w[0, 0] = saved
    print(f"  dump {Path(dump).name}, naninf_trips +{trips}; flag cleared: "
          f"forward ran (non-finite logits {int((~torch.isfinite(bad)).sum())}"
          f"), dispatch mode left: {dispatch.scan_active()}; forward "
          f"b2 x s512 {off_ms:.2f} ms with the flag off, {on_ms:.2f} ms on")
    del model, bad
    torch.cuda.empty_cache()
    return {"message": msg, "trips": trips, "off_ms": off_ms, "on_ms": on_ms}


# -- registry phase ----------------------------------------------------------

def tune_keys():
    """(kernel, key) of each search: the main path's shapes in the kernel
    table. The paged kernel at the engine's decode batch and a 64-block
    gather width, at GPT-3 1.3B's and Llama-7B's KV heads; the int8 head at
    GPT's (decode batch, (N, K)) and Llama's (one row, (K, N)); the flash
    kernels at the training shape; the fused CE at the train step's rows."""
    from paddle_tpu_torch.ops import kernels as K

    bf16 = torch.bfloat16
    keys = []
    for _, cfg, kv, _ in engine_models():
        keys.append(("paged_attention", K.paged_attention_key(
            ENGINE_KW["max_batch"], 64, ENGINE_KW["block_size"], kv,
            cfg.num_heads // kv, cfg.hidden_size // cfg.num_heads, bf16)))
    keys.append(("int8_matmul", K.int8_matmul_key(
        ENGINE_KW["max_batch"], *INT8_HEAD, True, bf16)))
    keys.append(("int8_matmul", K.int8_matmul_key(1, *LLAMA_HEAD, False,
                                                  bf16)))
    B, T, Tk, H, D, causal = FLASH_TRAIN
    keys.append(("flash_attention", K.flash_attention_key(
        B, H, T, Tk, D, bf16, causal)))
    gpt = engine_models()[0][1]
    keys.append(("fused_ce", K.fused_ce_key(B * T, gpt.hidden_size,
                                            gpt.vocab_size, bf16)))
    return keys


def tune_counters_delta(c0):
    return {k: v for k, v in counter_delta(c0).items()
            if k.startswith("kernel_tune") and v}


def registry_off_check(c0, tune_dir):
    """After the engine and train phases ran with ``FLAGS_kernel_autotune``
    off: no ``kernel_tune*`` counter moved and the tune dir holds nothing."""
    from paddle_tpu_torch.framework import flags

    moved = tune_counters_delta(c0)
    files = sorted(os.listdir(tune_dir)) if os.path.isdir(tune_dir) else []
    mode = flags.flag("FLAGS_kernel_autotune")
    print(f"  off: FLAGS_kernel_autotune={mode!r} through the engine and "
          f"train phases: kernel_tune counters moved {moved}, tune dir "
          f"{tune_dir} holds {len(files)} files "
          f"{'ok' if mode == 'off' and not moved and not files else 'MISMATCH'}")
    if mode != "off" or moved or files:
        fail(f"registry off: mode {mode!r}, counters {moved}, files {files}")


def registry_search():
    """``search`` at each of ``tune_keys``: one search a key, zero candidate
    errors and zero verify failures, and the winner persisted. Returns a row
    a key: the winner, the defaults' and the winner's median ms, the
    candidates tried, the budget stops and the cost-drift fraction (the
    discordant share of the estimated and measured orderings; None when
    fewer than two configs ran); where the winner is not the default, both
    timed again on the runner's inputs by CUDA events (``event_ms``)."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import autotune, db
    from paddle_tpu_torch.serving import observe
    from paddle_tpu_torch import profiler

    set_flags({"FLAGS_kernel_autotune": "search",
               "FLAGS_kernel_tune_budget_s": TUNE_BUDGET_S,
               "FLAGS_kernel_tune_samples": TUNE_SAMPLES})
    autotune.clear_cache()
    rows = []
    for name, key in tune_keys():
        c0 = profiler.counters()
        g0 = observe.drift_gauges().get("kernel_estimate", {}).get("samples", 0)
        t0 = time.monotonic()
        won = K.resolve_config(name, key)
        secs = time.monotonic() - t0
        torch.cuda.synchronize()
        d = counter_delta(c0)
        path = db.entry_path(name, key)
        if d.get("kernel_tune_searches", 0) != 1 or not os.path.isfile(path):
            fail(f"registry search {name} {key}: {d}, entry {path}")
        with open(path) as f:
            entry = json.load(f)
        g = observe.drift_gauges().get("kernel_estimate", {})
        row = {"kernel": name, "key": list(key), "winner": won,
               "default": dict(K.get_kernel(name).defaults),
               "default_ms": entry["default_ms"], "best_ms": entry["best_ms"],
               "candidates": d.get("kernel_tune_candidates", 0),
               "budget_stops": d.get("kernel_tune_budget_stops", 0),
               "cost_drift": g.get("last_rel_err")
               if g.get("samples", 0) > g0 else None,
               "seconds": secs}
        if won != row["default"]:
            # the device's view of the two on the runner's inputs (CUDA
            # events), beside the search's host-clock medians
            make = K.get_kernel(name).runner(key)
            row["event_ms"] = {"default": time_ms(make(row["default"])),
                               "winner": time_ms(make(won))}
            del make
            torch.cuda.empty_cache()
        ev = (f"; by CUDA events {row['event_ms']}" if "event_ms" in row
              else "")
        print(f"  search {name} {tuple(key)}: winner {won} (default "
              f"{row['default']}{ev}), default_ms {row['default_ms']:.4f}, "
              f"best_ms {row['best_ms']:.4f}, {row['candidates']} candidates "
              f"tried, {row['budget_stops']} budget stops, cost drift "
              f"{row['cost_drift']}, {secs:.1f}s; candidate errors "
              f"{d.get('kernel_tune_candidate_errors', 0)}, verify fails "
              f"{d.get('kernel_tune_verify_fails', 0)}")
        if d.get("kernel_tune_candidate_errors") or \
                d.get("kernel_tune_verify_fails") or entry["config"] != won:
            fail(f"registry search {name} {key}: {d}, entry {entry}")
        rows.append(row)
    return rows


def registry_persistence(rows):
    """A cleared memo under ``ondemand`` resolves every searched key from the
    tuning DB: one hit each, the search's winner, and no search."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import autotune

    autotune.clear_cache()
    set_flags({"FLAGS_kernel_autotune": "ondemand"})
    c0 = profiler.counters()
    got = [K.resolve_config(r["kernel"], tuple(r["key"])) for r in rows]
    d = counter_delta(c0)
    ok = got == [r["winner"] for r in rows] \
        and d.get("kernel_tune_hits", 0) == len(rows) \
        and not d.get("kernel_tune_searches") \
        and not d.get("kernel_tune_misses")
    print(f"  ondemand after clear_cache(): {d.get('kernel_tune_hits', 0)} "
          f"hits of {len(rows)} keys, searches "
          f"{d.get('kernel_tune_searches', 0)}, misses "
          f"{d.get('kernel_tune_misses', 0)}; configs equal the winners "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"registry persistence: {got} vs winners, counters {d}")
    return {"hits": d.get("kernel_tune_hits", 0),
            "searches": d.get("kernel_tune_searches", 0)}


def tuned_drive(rows):
    """GPT-3 1.3B at drive (a)'s setting (``ENGINE_KW``, the paged kernel,
    bf16, (a)'s prompts), the wave queued before the first admission
    (``FIRST_STEP_WAITS``) so two runs batch alike: once with
    ``FLAGS_kernel_autotune`` off, then with ``ondemand`` on the DB the
    search wrote. Both well-formed with paged launches; the tuned run never
    searches; the share of its outputs equal to the off run's is reported,
    and must be 1.0 when every winner is the default."""
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels import autotune
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving import Engine

    name, cfg, _, _ = engine_models()[0]
    model = build_engine_model(name, cfg)
    prompts = drive_prompts(cfg.vocab_size)
    set_flags({"FLAGS_serve_paged_kernel": True,
               "FLAGS_serve_int8_kernel": False})

    def run(mode):
        set_flags({"FLAGS_kernel_autotune": mode})
        autotune.clear_cache()
        eng = Engine(model, **ENGINE_KW, int8=False, seed=0)
        K.reset_launch_counts()
        c0 = profiler.counters()
        try:
            t0 = time.monotonic()
            outs = [h.result(timeout=900) for h in chaos_wave(eng.submit,
                                                              prompts)]
            wall = time.monotonic() - t0
        finally:
            inject.disarm()
            eng.close()
        counts = K.launch_counts()
        well_formed(f"a, {mode}", prompts, outs, cfg.vocab_size)
        if not counts["paged_attention_rows"]:
            fail(f"engine (a, {mode}): kernel launches {counts}")
        return outs, counts, tune_counters_delta(c0), wall

    off, off_counts, off_d, off_wall = run("off")
    tuned, counts, d, wall = run("ondemand")
    used = {f"{k[0]}{tuple(k[1])}": v for k, v in autotune._MEM.items()}
    set_flags({"FLAGS_kernel_autotune": "off"})
    autotune.clear_cache()
    share = same_share(tuned, off)
    defaults = all(r["winner"] == r["default"] for r in rows)
    row = {"drive": "a_tuned", "same_share_as_off": share,
           "every_winner_default": defaults, "launches": counts,
           "off_launches": off_counts, "tune_counters": d,
           "tok_s": len(tuned) * DRIVE_NEW / wall,
           "off_tok_s": len(off) * DRIVE_NEW / off_wall,
           "configs_resolved": used}
    print(f"  engine (a) with ondemand on the tuned DB: launches {counts} "
          f"(off: {off_counts}), tune counters {d} (off: {off_d}), configs "
          f"resolved {used}; {share:.3f} of the outputs equal the off run's "
          f"(every winner the default: {defaults}); {row['tok_s']:.1f} tok/s "
          f"against {row['off_tok_s']:.1f} off, both with the first step's "
          "500 ms wait")
    if off_d or d.get("kernel_tune_searches") or (defaults and share != 1.0):
        fail(f"engine (a) tuned: off counters {off_d}, ondemand {d}, share "
             f"{share}")
    del model
    torch.cuda.empty_cache()
    return row


def host_us_ab(fa, fb, chunks=HOST_US_CHUNKS, per_chunk=256):
    """Host µs of one call of ``fa`` and of ``fb``, interleaved call by
    call (a, b, a, b, ...) so host drift falls on both alike, each call on
    the host clock: ``chunks`` runs of ``per_chunk`` calls, each run queued
    behind a sleep kernel and drained (untimed) after it, so no launch
    waits for the device. Returns the two medians."""
    fa()
    fb()
    ta, tb = [], []
    clock = time.perf_counter_ns
    for _ in range(chunks):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e8))
        for i in range(per_chunk):
            fn, acc = (fa, ta) if i % 2 == 0 else (fb, tb)
            t0 = clock()
            fn()
            acc.append(clock() - t0)
    torch.cuda.synchronize()
    return float(np.median(ta)) / 1e3, float(np.median(tb)) / 1e3


def registry_host_us():
    """The wrapper's host µs per call with ``FLAGS_kernel_autotune`` off:
    the config resolved through the registry (the main path's call) against
    the config named (the registry bypassed), interleaved call by call
    (``host_us_ab``): the paged kernel at the decode shape, the int8 head at
    GPT's decode batch, ``flash_attention_array``'s forward at the training
    shape; and, alone in a loop, the ``launch_config`` call that the
    resolved call adds."""
    from paddle_tpu_torch.ops import kernels as K

    bf16 = torch.bfloat16
    q, kp, vp, tables, pos = paged_inputs(bf16)
    qw, s = int8_weight(*INT8_HEAD)
    x = int8_x(ENGINE_KW["max_batch"], INT8_HEAD[0], bf16)
    B, T, Tk, H, D, causal = FLASH_TRAIN
    fq, fk, fv, _ = flash_inputs(B, T, Tk, H, D, bf16, fused_qkv=True)
    M, (Kd, N) = ENGINE_KW["max_batch"], INT8_HEAD
    calls = {
        "paged_attention_rows": (
            lambda: K.paged_attention_rows(q, kp, vp, tables, pos),
            lambda: K.paged_attention_rows(q, kp, vp, tables, pos,
                                           config={"split": 0}),
            lambda: K.launch_config("paged_attention", K.paged_attention_key,
                                    32, 64, 16, 16, 1, 128, bf16)),
        "int8_matmul": (
            lambda: K.int8_matmul(x, qw, s, True),
            lambda: K.int8_matmul(x, qw, s, True, config={"block_n": 384}),
            lambda: K.launch_config("int8_matmul", K.int8_matmul_key, M, Kd,
                                    N, True, bf16)),
        "flash_attention_array": (
            lambda: K.flash_attention_array(fq, fk, fv, causal),
            lambda: K.flash_attention_array(fq, fk, fv, causal, block_q=128,
                                            block_k=128),
            lambda: K.launch_config("flash_attention", K.flash_attention_key,
                                    B, H, T, Tk, D, bf16, causal)),
    }
    out = {}
    with torch.no_grad():
        for name, (resolved, named, lookup) in calls.items():
            r, n = host_us_ab(resolved, named)
            t0 = time.perf_counter()
            for _ in range(20000):
                lookup()
            alone = (time.perf_counter() - t0) / 20000 * 1e6
            out[name] = {"resolved_us": r, "named_us": n, "rise_us": r - n,
                         "launch_config_us": alone}
            print(f"  host us a call, {name}: config resolved (off) {r:.2f}, "
                  f"config named {n:.2f}, rise {r - n:+.2f} (medians of "
                  f"{HOST_US_CHUNKS * 128} calls each, interleaved); "
                  f"launch_config alone {alone:.3f}")
    del q, kp, vp, qw, x, fq, fk, fv
    torch.cuda.empty_cache()
    return out


def registry_phase(c0, tune_dir):
    """The kernel registry over the main path: the off check, a search at
    each of ``tune_keys``, their persistence, the tuned drive and the
    wrappers' host µs; ``FLAGS_kernel_autotune`` is off again after it."""
    from paddle_tpu_torch.framework.flags import set_flags

    registry_off_check(c0, tune_dir)
    try:
        rows = registry_search()
        persisted = registry_persistence(rows)
        drive = tuned_drive(rows)
    finally:
        set_flags({"FLAGS_kernel_autotune": "off"})
    return {"searches": rows, "persistence": persisted, "tuned_drive": drive,
            "host_us": registry_host_us()}



# -- engine train phase (13) ---------------------------------------------------

ENGINE_STEPS = 3  # steps from one start in each bit comparison of phase 13
ENGINE_ACC_REL_TOL = 1e-2  # grad_accumulate=2 against 1 (bf16 sum order)
LLAMA_OOM_B = 4  # Llama-7B at b4 x s2048 cannot fit one card (13c)


def engine_snapshot(model, opt):
    """The training state on the card: parameters, gradients, optimizer
    state (cloned) and the port's generator states."""
    from paddle_tpu_torch.core.random import get_rng_state

    params = [p.detach().clone() for p in model.parameters()]
    grads = [None if p.grad is None else p.grad.clone()
             for p in model.parameters()]
    opt_sd = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in opt.state_dict().items()}
    return params, grads, opt_sd, get_rng_state()


def engine_restore(model, opt, snap):
    from paddle_tpu_torch.core.random import set_rng_state

    params, grads, opt_sd, rng = snap
    with torch.no_grad():
        for p, s, g in zip(model.parameters(), params, grads):
            p.copy_(s)
            p.grad = None if g is None else g.clone()
    opt._accumulators = {}
    opt.set_state_dict({k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in opt_sd.items()})
    set_rng_state(rng)


def same_state(a, b):
    """(parameters bit-equal, gradients bit-equal, optimizer state
    bit-equal) of two ``engine_snapshot``s."""
    pa = all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    ga = all((x is None and y is None) or (x is not None and y is not None
                                           and torch.equal(x, y))
             for x, y in zip(a[1], b[1]))
    oa = a[2].keys() == b[2].keys() and all(
        torch.equal(v, b[2][k]) if isinstance(v, torch.Tensor)
        else v == b[2][k] for k, v in a[2].items())
    return pa, ga, oa


def engine_run(model, start, make_step, n=ENGINE_STEPS, ids=None,
               labels=None, spec=None):
    """``n`` steps of ``make_step(opt)`` from the initial parameters
    ``start`` with a fresh AdamW: (losses, parameters after). The
    gradients are dropped after, so only the parameters stay."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.fault import inject

    with torch.no_grad():
        for p, s in zip(model.parameters(), start):
            p.copy_(s)
            p.grad = None
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    step = make_step(opt)
    if spec:
        inject.arm(spec)
    try:
        losses = [step(ids, labels) for _ in range(n)]
    finally:
        inject.disarm()
    vals = [x.item() for x in losses]
    del step, opt
    for p in model.parameters():
        p.grad = None
    return vals, [p.detach().clone() for p in model.parameters()]


def engine_throughput(eng, ids, labels, cfg, n_params, tag="13a"):
    """13a (and 14a): 2 warm-up and 8 timed engine steps: step ms,
    tokens/s, MFU, peak, flash launches and bucket all-reduces a step."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.ops import kernels as K

    losses = [eng.train_step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    c0 = profiler.counters()
    timed, queued, wall = time_steps(eng.train_step, ids, labels,
                                     TRAIN_STEPS)
    counts = K.launch_counts()
    c1 = profiler.counters()
    peak = torch.cuda.max_memory_allocated()
    vals = [x.item() for x in losses + timed]
    B, T = ids.shape
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    flops_tok = train_flops_per_token(cfg, n_params, T)
    ar = (c1.get("dp_all_reduces", 0) - c0.get("dp_all_reduces", 0)) \
        / TRAIN_STEPS
    synced = (c1.get("dp_buckets", 0) - c0.get("dp_buckets", 0)) / TRAIN_STEPS
    buckets = len(eng._dp_model._buckets["plan"]) \
        if eng._dp_model is not None else 0
    print(f"  ({tag}) engine: {TRAIN_STEPS} steps after {TRAIN_WARMUP} "
          f"warm-up, step {step_ms:.2f} ms (host clock, one sync at the "
          f"end), {tok_s:.1f} tokens/s, MFU {tok_s * flops_tok / 989e12:.4f}"
          f", peak memory {peak / 2**30:.2f} GiB, {synced:g} buckets of <= "
          f"25 MiB synced a step as the single-participant identity (world "
          f"1), {ar:g} bucket all-reduces a step, launches {counts}; queued "
          f"in {queued * 1e3:.1f} ms")
    print(f"  losses: {[round(v, 4) for v in vals]}")
    want = cfg.num_layers * TRAIN_STEPS
    bad = [k for k in FLASH_REPLACES if counts[k] != want]
    if bad:
        fail(f"engine: launches {counts}, want {want} for each flash kernel")
    if ar != 0 or synced != buckets:
        fail(f"engine: {ar} bucket all-reduces and {synced} buckets a step at"
             f" world 1, want 0 and {buckets}")
    if not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"engine: losses {vals}")
    ev = device_timeline(lambda: eng.train_step(ids, labels), 1,
                         f"timeline ({tag} engine)")
    nccl = sum(1 for _, _, n in ev if "nccl" in n.lower())
    print(f"  timeline ({tag} engine): one step names {nccl} NCCL kernels")
    return {"step_ms": step_ms, "tokens_per_s": tok_s,
            "mfu": tok_s * flops_tok / 989e12, "peak_gib": peak / 2**30,
            "queued_ms": queued * 1e3, "losses": vals,
            "bucket_all_reduces_per_step": ar, "buckets": buckets,
            "buckets_synced_per_step": synced,
            "nccl_kernels_in_one_step": nccl,
            "launches": {k: counts[k] for k in FLASH_REPLACES}}


def nccl_collectives(dist):
    """13a: the collectives over the NCCL group of one rank, on the card:
    each gives its input back."""
    x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
    got = {"all_reduce_avg": dist.all_reduce(x.clone(), dist.ReduceOp.AVG),
           "all_gather": dist.all_gather(None, x)[0],
           "broadcast": dist.broadcast(x.clone(), src=0)}
    out = torch.empty_like(x)
    dist.all_gather_into_tensor(out, x)
    got["all_gather_into_tensor"] = out
    dist.barrier()
    torch.cuda.synchronize()
    ok = {k: bool(torch.equal(v, x)) for k, v in got.items()}
    print(f"  (13a) collectives over NCCL at world 1 on the card: {ok}")
    if not all(ok.values()):
        fail(f"collectives: {ok}")
    return ok


def engine_admission(model, start, ids, labels, loss_fn):
    """13b: the admission, from a fresh engine and a fresh AdamW."""
    import warnings

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import DataParallel, HybridParallelEngine
    from paddle_tpu_torch.fault import memory
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K

    with torch.no_grad():
        for p, s in zip(model.parameters(), start):
            p.copy_(s)
            p.grad = None
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    eng = HybridParallelEngine(DataParallel(model), opt, loss_fn)
    out = {}
    set_flags({"FLAGS_hbm_admission": "enforce", "FLAGS_hbm_budget_bytes": 0})
    measured = []
    for i in range(2):  # the state-building call, then the steady one
        eng.train_step(ids, labels)
        rows = [r for r in memory.attributions() if r["key"].startswith(
            "engine.step:x1:")]
        if not rows:
            fail(f"admission: no engine attribution in "
                 f"{memory.attributions()}")
        measured.append(dict(rows[0], max_memory_allocated=int(
            torch.cuda.max_memory_allocated())))
        print(f"  (13b) call {i + 1} measured: {rows[0]}; peak_bytes "
              f"{rows[0]['peak_bytes']} against max_memory_allocated "
              f"{measured[-1]['max_memory_allocated']}")
    budget = memory.budget_bytes()
    cap = torch.cuda.get_device_properties(0).total_memory
    live = torch.cuda.memory_allocated()
    first = measured[0]
    once = live + first["output_bytes"] + first["temp_bytes"]
    print(f"  (13b) budget {budget} (capacity {cap} less the reserve); the "
          f"allocator holds {torch.cuda.memory_reserved()} reserved, "
          f"{cap - budget} between the budget and the card's whole memory; "
          f"admitted with the first call's growth, call 3 would predict "
          f"{once} (live {live} + the gradients and moments counted again)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng.train_step(ids, labels)  # the first admitted call
    torch.cuda.synchronize()
    pred = memory.last_prediction()
    realized = torch.cuda.max_memory_allocated()
    drift = (pred["hbm_predicted_peak_bytes"] - realized) / realized
    print(f"  (13b) call 3 admitted: predicted peak "
          f"{pred['hbm_predicted_peak_bytes']} (live {pred['hbm_live_bytes']}"
          f" + extra {pred['hbm_extra_bytes']}), realized peak {realized}, "
          f"drift {drift:+.6f}")
    # a budget 1 MiB above the realized peak admits the next call
    set_flags({"FLAGS_hbm_budget_bytes": realized + (1 << 20)})
    try:
        eng.train_step(ids, labels)
    except memory.HbmBudgetExceeded as e:
        fail(f"admission: a budget 1 MiB above the realized peak {realized} "
             f"rejected the step: {e}")
    tight = memory.last_prediction()
    print(f"  (13b) call 4 at a budget 1 MiB above call 3's realized peak: "
          f"admitted, predicted {tight['hbm_predicted_peak_bytes']}")
    out.update(measured=measured, budget_bytes=budget, capacity_bytes=cap,
               first_growth_prediction=once,
               predicted_peak_bytes=pred["hbm_predicted_peak_bytes"],
               realized_peak_bytes=realized, drift=drift,
               admitted_at_realized_plus_1mib=True)
    # a budget 1 MiB under the prediction: rejected before any launch
    before = engine_snapshot(model, opt)
    torch.cuda.synchronize()
    extra = tight["hbm_extra_bytes"]
    set_flags({"FLAGS_hbm_budget_bytes":
               torch.cuda.memory_allocated() + extra - (1 << 20)})
    K.reset_launch_counts()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    try:
        eng.train_step(ids, labels)
        fail("admission: a budget under the prediction did not reject")
    except memory.HbmBudgetExceeded as e:
        err = e
    e1.record()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    margin = err.predicted_bytes - err.budget_bytes
    after = engine_snapshot(model, opt)
    equal = same_state(before, after)
    rng_equal = all(torch.equal(before[3][k], after[3][k])
                    for k in before[3])
    print(f"  (13b) rejected {margin} bytes over the budget: {err}; launches "
          f"{counts}, CUDA events {e0.elapsed_time(e1):.4f} ms around the "
          f"call; parameters, gradients, AdamW state bit-equal {equal}, RNG "
          f"{rng_equal}")
    if margin != 1 << 20:
        fail(f"admission: rejected {margin} bytes over the budget, want "
             f"{1 << 20}")
    if any(counts.values()) or not all(equal) or not rng_equal:
        fail(f"admission: the rejected call launched {counts} or changed "
             f"the state {equal}, rng {rng_equal}")
    out.update(rejected=str(err), rejected_margin_bytes=margin,
               rejected_event_ms=e0.elapsed_time(e1),
               rejected_launches=counts)
    # the budget restored: the same call equals an unadmitted run
    set_flags({"FLAGS_hbm_budget_bytes": 0})
    admitted = eng.train_step(ids, labels).item()
    a_params = [p.detach().clone() for p in model.parameters()]
    set_flags({"FLAGS_hbm_admission": "off"})
    engine_restore(model, opt, before)
    plain = eng.train_step(ids, labels).item()
    retry_equal = admitted == plain and all(
        torch.equal(x, p) for x, p in zip(a_params, model.parameters()))
    print(f"  (13b) the same call with the budget restored: loss {admitted}"
          f", unadmitted {plain}; parameters bit-equal {retry_equal}")
    if not retry_equal:
        fail("admission: the retried call differs from an unadmitted run")
    del a_params, before, after
    # warn: once a site
    set_flags({"FLAGS_hbm_admission": "warn", "FLAGS_hbm_budget_bytes": 10})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for _ in range(2):
            eng.train_step(ids, labels)
    n_warn = sum("exceeds budget" in str(x.message) for x in w)
    print(f"  (13b) warn at a 10-byte budget: {n_warn} warning over 2 "
          "steps")
    if n_warn != 1:
        fail(f"admission: warn gave {n_warn} warnings, want 1")
    set_flags({"FLAGS_hbm_admission": "off", "FLAGS_hbm_budget_bytes": 0})
    out.update(retry_bit_equal=retry_equal, warnings=n_warn)
    del eng, opt
    for p in model.parameters():
        p.grad = None
    return out


def engine_ladder(model, start, ids, labels, losses_acc2, params_acc2):
    """13d: the ladder's pins by injection at GPT-3 1.3B."""
    from paddle_tpu_torch.distributed import DataParallel, HybridParallelEngine
    from paddle_tpu_torch.fault import memory

    def loss_fn(m, i, l):
        return m._layers.loss(i, l)

    engines = []

    def make(opt):
        engines.append(HybridParallelEngine(DataParallel(model), opt,
                                            loss_fn))
        return engines[-1].train_step

    vals, params = engine_run(model, start, make, ids=ids, labels=labels,
                              spec="hbm.oom:op=engine.step,from=1")
    eng = engines.pop()
    bits = vals == losses_acc2 and all(
        torch.equal(a, b) for a, b in zip(params, params_acc2))
    print(f"  (13d) hbm.oom:op=engine.step,from=1: rung x"
          f"{eng.grad_accumulate} ({eng._dispatch_op}), losses {vals}; "
          f"against grad_accumulate=2 from the start {losses_acc2}: losses "
          f"and parameters bit-equal {bits}")
    if eng.grad_accumulate != 2 or not bits:
        fail("ladder: the degraded run is not bit-equal to accumulate-from-"
             "start")
    rung, op = eng.grad_accumulate, eng._dispatch_op
    del params, eng
    try:
        engine_run(model, start, make, n=1, ids=ids, labels=labels,
                   spec="hbm.oom:from=1")
        fail("ladder: hbm.oom:from=1 did not exhaust the ladder")
    except memory.HbmExhausted as e:
        exc = e
    actions = [a["action"] for a in exc.attempts]
    doc = json.loads(Path(exc.dump_path).read_text())
    ex = doc["extra"]
    print(f"  (13d) hbm.oom:from=1: HbmExhausted, attempts {actions}; dump "
          f"{Path(exc.dump_path).name}: budget_bytes {ex.get('budget_bytes')}"
          f", {len(ex.get('attributions', []))} attributions, census "
          f"{ex['census'].get('allocated_bytes', ex['census'])}")
    if not {"free_pressure", "degrade_x2", "degrade_x4"} <= set(actions) \
            or not ex.get("budget_bytes") or not ex.get("attributions"):
        fail(f"ladder: attempts {actions}, dump extra keys {sorted(ex)}")
    engines.clear()
    for p in model.parameters():
        p.grad = None
    return {"degrade_rung": rung, "degraded_dispatch": op,
            "degraded_losses": vals, "bit_equal_to_accumulate": bits,
            "exhausted_attempts": actions,
            "dump_budget_bytes": ex["budget_bytes"],
            "dump_attributions": len(ex["attributions"])}


def engine_serving_drift(model):
    """13e: one short traced serving drive under warn records the
    admission's drift."""
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.serving import Engine, observe

    observe.reset()
    set_flags({"FLAGS_hbm_admission": "warn"})
    try:
        model.eval()
        rng = np.random.RandomState(3)
        with Engine(model, block_size=16, num_blocks=64, max_batch=4,
                    max_seq_len=256, trace=True) as eng:
            hs = [eng.submit(rng.randint(0, 50000, (32,)).tolist(),
                             max_new_tokens=8) for _ in range(4)]
            outs = [h.result(timeout=300) for h in hs]
        g = observe.drift_gauges().get("hbm_admission")
    finally:
        set_flags({"FLAGS_hbm_admission": "off"})
        model.train()
        observe.reset()
    print(f"  (13e) traced serving drive under warn: {len(outs)} requests, "
          f"hbm_admission drift {g}")
    if not g or g["samples"] < 1 or any(len(o) != 40 for o in outs):
        fail(f"serving drift: gauge {g}, outputs {[len(o) for o in outs]}")
    return {"samples": g["samples"], "rel_err": g["rel_err"],
            "predicted": g["predicted"], "actual": g["actual"]}


def engine_train_phase(llama_oom):
    """Phase 13: GPT-3 1.3B through HybridParallelEngine over NCCL (13a),
    the admission (13b), the ladder by injection (13d), the serving drift
    (13e); 13c (Llama-7B's real out-of-memory) ran at the end of phase 8."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import DataParallel, HybridParallelEngine

    env = dist.init_parallel_env()
    print(f"  init_parallel_env: backend {dist.get_backend()}, world "
          f"{env.world_size}, rank {env.rank}, mesh {dist.global_mesh()}")
    try:
        collectives = nccl_collectives(dist)
        model = train_model()
        cfg = model.config
        ids, labels = train_batch(cfg)
        n_params = sum(p.numel() for p in model.parameters())
        start = [p.detach().clone() for p in model.parameters()]

        def loss_fn(m, i, l):
            return m._layers.loss(i, l)

        def engine_of(acc=1):
            def make(opt):
                return HybridParallelEngine(DataParallel(model), opt,
                                            loss_fn,
                                            grad_accumulate=acc).train_step
            return make

        def compiled(opt):
            return pt.jit.compile_train_step(
                model, lambda m, i, l: m.loss(i, l), opt)

        # three steps from one start: the engine, compile_train_step, and
        # the engine at grad_accumulate=2
        l_eng, p_eng = engine_run(model, start, engine_of(), ids=ids,
                                  labels=labels)
        l_cmp, p_cmp = engine_run(model, start, compiled, ids=ids,
                                  labels=labels)
        bits = l_eng == l_cmp and all(torch.equal(a, b)
                                      for a, b in zip(p_eng, p_cmp))
        p_eng = [p.cpu() for p in p_eng]  # phase 14a holds itself to them
        del p_cmp
        l_acc, p_acc = engine_run(model, start, engine_of(2), ids=ids,
                                  labels=labels)
        acc_rel = rel_diff(l_acc, l_eng)
        print(f"  (13a) from one start, {ENGINE_STEPS} steps: engine "
              f"{l_eng}, compile_train_step {l_cmp}: losses and parameters "
              f"bit-equal {bits}; grad_accumulate=2 {l_acc}, worst relative "
              f"loss difference {acc_rel:.3e} (tol {ENGINE_ACC_REL_TOL})")
        if not acc_rel <= ENGINE_ACC_REL_TOL:
            fail(f"engine: grad_accumulate=2 losses {l_acc} against {l_eng}")
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)
        opt = pt.optimizer.AdamW(learning_rate=1e-4,
                                 parameters=model.named_parameters())
        eng = HybridParallelEngine(DataParallel(model), opt, loss_fn)
        out = {"model": "gpt3_1p3b", "batch": list(ids.shape),
               "backend": dist.get_backend(), "world": env.world_size,
               "nccl_collectives": collectives}
        out.update(engine_throughput(eng, ids, labels, cfg, n_params))
        out.update(engine_vs_compiled_bit_equal=bits,
                   engine_vs_compiled_losses=[l_eng, l_cmp],
                   acc2_losses=l_acc, acc2_rel_diff=acc_rel)
        del eng, opt
        torch.cuda.empty_cache()
        out["admission"] = engine_admission(model, start, ids, labels,
                                            loss_fn)
        torch.cuda.empty_cache()
        # after the admission, so the exhaustion's dump has attributions
        out["ladder"] = engine_ladder(model, start, ids, labels, l_acc,
                                      p_acc)
        del p_acc
        torch.cuda.empty_cache()
        out["serving_drift"] = engine_serving_drift(model)
        out["llama_oom"] = llama_oom
        print("[14] fleet: gpt3_1p3b through fleet.init, distributed_model, "
              "distributed_optimizer and HybridParallelEngine(mesh=hcg.mesh) "
              "at world 1 over NCCL; the tensor-parallel layout at full "
              "width; sequence parallelism on the flash kernels")
        fleet = fleet_phase(model, start, ids, labels, n_params, l_eng,
                            p_eng, out)
        print("[15] fleet, part 2: ZeRO-3 (p_g_os) on phase 14's model, "
              "gpt3_1p3b as a one-stage PipelineLayer (1F1B, F-then-B), the "
              "MoE layer at full width, DGC and LocalSGD")
        part2, hcg = fleet_part2_phase(model, start, ids, labels, l_eng,
                                       p_eng)
        del model, start
        torch.cuda.empty_cache()
        fleet_part2_rest(part2, hcg)
        fleet["part2"] = part2
        print("[16] auto-parallel and the coordinated checkpoint: gpt3_1p3b "
              "through auto_parallel.Engine, CoordinatedCheckpoint over the "
              "TCPStore adapter, the sentinel's AutoCheckpoint anchor, "
              "launch(elastic=True) with a preemption")
        auto = auto_parallel_ckpt_phase(ids, labels, l_eng, p_eng)
        del p_eng
    finally:
        dist.destroy_process_group()
    return out, fleet, auto


ULYSSES_SHAPE = FLASH_LONG  # (B, T, T_kv, H, D, causal): 14c's long shape
RING_SHAPE = FLASH_TRAIN  # 14c's ring: GPT-3 1.3B's training shape
RING_REL_TOL = 1e-2  # ring (f32 scores) against the bf16 flash forward


def fleet_engine_of(model, hcg, level=None):
    """``make_step(opt)`` for ``engine_run``: the model and the optimizer
    through fleet's entry points (``level``: through
    ``group_sharded_parallel`` over the one-rank sharding group instead),
    trained by ``HybridParallelEngine(mesh=hcg.mesh)``."""
    from paddle_tpu_torch.distributed import HybridParallelEngine, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        group_sharded_parallel

    def make(opt):
        if level is None:
            m, o = fleet.distributed_model(model), \
                fleet.distributed_optimizer(opt)
        else:
            m, o, _ = group_sharded_parallel(
                model, opt, level, group=hcg.get_sharding_parallel_group())
        return HybridParallelEngine(m, o, lambda mm, i, l: mm.loss(i, l),
                                    mesh=hcg.mesh).train_step
    return make


def mp_layout_check(model):
    """14b: GPT-3 1.3B's bf16 state split into mp = 2 and 4 rank shards on
    the card and merged back; each rank's qkv shard holds its heads' q, k
    and v columns; the ranks' bytes sum to the logical bytes with the
    replicated parameters once a rank."""
    from paddle_tpu_torch.models import (merge_state_dicts, mp_layouts,
                                         split_state_dict)

    state = {k: v.detach() for k, v in model.state_dict().items()}
    layouts = mp_layouts(model)
    h, heads = model.config.hidden_size, model.config.num_heads
    logical = sum(v.numel() * v.element_size() for v in state.values())
    repl = sum(v.numel() * v.element_size() for k, v in state.items()
               if layouts[k] == "replicated")
    out = {"logical_bytes": logical, "replicated_bytes": repl,
           "kinds": {k: sum(1 for x in layouts.values() if x == k)
                     for k in sorted(set(layouts.values()))}}
    for mp in (2, 4):
        t0 = time.monotonic()
        shards = split_state_dict(state, layouts, mp)
        merged = merge_state_dicts(shards, layouts)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        equal = all(torch.equal(merged[k], v) for k, v in state.items())
        per = h // mp
        qkv_ok = True
        for li in (0, model.config.num_layers - 1):
            name = f"gpt.layers.{li}.attn.qkv.weight"
            w = state[name]
            for r, sh in enumerate(shards):
                got = sh[name]
                qkv_ok &= tuple(got.shape) == (h, 3 * per) and all(
                    torch.equal(got[:, g * per:(g + 1) * per],
                                w[:, g * h + r * per:g * h + (r + 1) * per])
                    for g in range(3))
        rank_bytes = [sum(v.numel() * v.element_size() for v in sh.values())
                      for sh in shards]
        bytes_ok = sum(rank_bytes) == logical + (mp - 1) * repl
        print(f"  (14b) mp={mp}: split and merge of {len(state)} tensors "
              f"({logical / 2**30:.3f} GiB) in {ms:.1f} ms, bit-equal "
              f"{equal}; qkv shards hold their {heads // mp} heads' q, k, v "
              f"{qkv_ok}; rank bytes {rank_bytes} sum to the logical "
              f"{logical} + {mp - 1} x replicated {repl}: {bytes_ok}")
        if not (equal and qkv_ok and bytes_ok):
            fail(f"mp layout at mp={mp}: merge {equal}, qkv {qkv_ok}, "
                 f"bytes {bytes_ok}")
        out[f"mp{mp}"] = {"bit_equal": equal, "qkv_heads": qkv_ok,
                          "rank_bytes": rank_bytes, "split_merge_ms": ms}
        del shards, merged
    return out


def sequence_parallel_check(group):
    """14c: ``ulysses_attention`` over the one-rank sp group at the long
    shape (forward and backward) bit-equal to ``flash_attention_array``
    and near the plain form, with its kernel launches; ``ring_attention``
    at GPT's training shape against the flash forward, both timed."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention, ulysses_attention)
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_array

    B, T, _, H, D, causal = ULYSSES_SHAPE
    q, k, v, do = flash_inputs(B, T, T, H, D, torch.bfloat16, seed=5)
    leaves = [[x.detach().clone().requires_grad_() for x in (q, k, v)]
              for _ in range(2)]
    K.reset_launch_counts()
    o_u = ulysses_attention(*leaves[0], group, causal=causal)
    o_u.backward(do)
    torch.cuda.synchronize()
    launches = {k_: n for k_, n in K.launch_counts().items() if n}
    o_f = flash_attention_array(*leaves[1], causal=causal)
    o_f.backward(do)
    bits = torch.equal(o_u, o_f) and all(
        torch.equal(a.grad, b.grad) for a, b in zip(*leaves))
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    po, _ = K.flash_attention_plain(qf, kf, vf, causal)
    gp = torch.autograd.grad(po, (qf, kf, vf), do.float())
    rels = {"O": rel_err(o_u, po)}
    rels.update({n: rel_err(a.grad, b) for n, a, b in
                 zip(("dQ", "dK", "dV"), leaves[0], gp)})
    tol = {"O": FLASH_O_REL_TOL, "dQ": FLASH_DQ_REL_TOL,
           "dK": FLASH_GRAD_REL_TOL, "dV": FLASH_GRAD_REL_TOL}
    ok = all(rels[n] <= tol[n] for n in rels)
    want = {"flash_attention_fwd": 1, "flash_attention_dq": 1,
            "flash_attention_dkv": 1}
    print(f"  (14c) ulysses_attention over a one-rank group at B={B} T={T} "
          f"H={H} D={D} causal bf16, forward and backward: bit-equal to "
          f"flash_attention_array {bits}; against the f32 plain form "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f" (tol {tol}); launches {launches}")
    if not bits or not ok or launches != want:
        fail(f"ulysses: bit-equal {bits}, errors {rels}, launches "
             f"{launches}")
    del leaves, o_u, o_f, po, gp, qf, kf, vf
    B, T, _, H, D, causal = RING_SHAPE
    q, k, v, do = flash_inputs(B, T, T, H, D, torch.bfloat16, seed=6)
    with torch.no_grad():
        o_r = ring_attention(q, k, v, group, causal=causal)
        o_f = flash_attention_array(q, k, v, causal=causal)
        ring_ms = time_ms(lambda: ring_attention(q, k, v, group,
                                                 causal=causal), 5)
        flash_ms = time_ms(lambda: flash_attention_array(q, k, v,
                                                         causal=causal), 5)
    diff = float((o_r.float() - o_f.float()).abs().max())
    rel = rel_err(o_r, o_f)
    print(f"  (14c) ring_attention over a one-rank group at B={B} T={T} "
          f"H={H} D={D} causal bf16 against the flash forward: max abs "
          f"difference {diff:.3e}, relative norm {rel:.3e} (tol "
          f"{RING_REL_TOL}); ring {ring_ms:.3f} ms, flash forward "
          f"{flash_ms:.3f} ms (CUDA events)")
    if not rel <= RING_REL_TOL:
        fail(f"ring attention: relative error {rel}")
    del o_r, o_f
    ring_bwd = ring_backward_check(group, q, k, v, do, causal)
    return {"ulysses": {"shape": list(ULYSSES_SHAPE), "bit_equal": bits,
                        "rel_err_vs_plain": rels, "launches": launches},
            "ring": {"shape": list(RING_SHAPE), "max_abs_diff": diff,
                     "rel_err": rel, "ring_ms": ring_ms,
                     "flash_fwd_ms": flash_ms, **ring_bwd}}


def ring_backward_check(group, q, k, v, do, causal):
    """14c: ``ring_attention``'s own backward (``_RingAttention.backward``)
    over the one-rank group on the card: its dQ, dK and dV against the f32
    plain form within the flash kernels' gradient tolerances, beside the
    flash backward's errors on the same inputs; the forward and backward
    of each timed by CUDA events (what one attention layer costs a
    training step when sp > 1 routes GPT to the ring)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ring_attention
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_array

    fns = {"ring": lambda a, b, c: ring_attention(a, b, c, group,
                                                  causal=causal),
           "flash": lambda a, b, c: flash_attention_array(a, b, c,
                                                          causal=causal)}
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    po, _ = K.flash_attention_plain(qf, kf, vf, causal)
    gp = torch.autograd.grad(po, (qf, kf, vf), do.float())
    del po, qf, kf, vf
    tol = {"dQ": FLASH_DQ_REL_TOL, "dK": FLASH_GRAD_REL_TOL,
           "dV": FLASH_GRAD_REL_TOL}
    rels, ms = {}, {}
    for name, fn in fns.items():
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*leaves).backward(do)
        rels[name] = {n: rel_err(a.grad, b) for n, a, b in
                      zip(("dQ", "dK", "dV"), leaves, gp)}

        def step(fn=fn, leaves=leaves):
            torch.autograd.grad(fn(*leaves), leaves, do)
        ms[name] = time_ms(step, 5)
        del leaves
    print(f"  (14c) ring_attention's backward on the card against the f32 "
          f"plain form: " + ", ".join(f"{n} {r:.3e}" for n, r in
                                       rels["ring"].items())
          + f" (tol {tol}); the flash backward's on the same inputs: "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels["flash"].items())
          + f"; forward + backward: ring {ms['ring']:.3f} ms, flash "
          f"{ms['flash']:.3f} ms (CUDA events)")
    if not all(rels["ring"][n] <= tol[n] for n in tol):
        fail(f"ring attention backward: errors {rels['ring']}")
    return {"bwd_rel_err_vs_plain": rels["ring"],
            "flash_bwd_rel_err_vs_plain": rels["flash"],
            "ring_fwd_bwd_ms": ms["ring"], "flash_fwd_bwd_ms": ms["flash"]}


def fleet_phase(model, start, ids, labels, n_params, l_eng, p_eng, base):
    """Phase 14 on phase 13's NCCL group of one rank and GPT-3 1.3B: (14a)
    fleet's entry points, 3 steps from one start bit-equal to 13a's engine,
    ``os_g`` over the one-rank group bit-equal too, 2 warm-up + 8 timed
    steps; (14b) the tensor-parallel layout; (14c) sequence parallelism."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import HybridParallelEngine, fleet

    cfg = model.config
    env = dist.init_parallel_env()  # joined by phase 13: returns at once
    strategy = fleet.DistributedStrategy()  # every degree 1
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    print(f"  (14a) fleet.init: backend {dist.get_backend()}, world "
          f"{env.world_size}, mesh {hcg.mesh}")
    res = {}
    for tag, level in (("fleet", None), ("os_g", "os_g")):
        losses, params = engine_run(model, start,
                                    fleet_engine_of(model, hcg, level),
                                    ids=ids, labels=labels)
        bits = losses == l_eng and all(torch.equal(a.cpu(), b)
                                       for a, b in zip(params, p_eng))
        del params
        print(f"  (14a) {tag}: {ENGINE_STEPS} steps from one start "
              f"{losses}, 13a's engine {l_eng}: losses and parameters "
              f"bit-equal {bits}")
        if not bits:
            fail(f"fleet {tag}: not bit-equal to phase 13a's engine")
        res[f"{tag}_bit_equal"] = bits
        res[f"{tag}_losses"] = losses
    with torch.no_grad():
        for p, s in zip(model.parameters(), start):
            p.copy_(s)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-4, parameters=model.named_parameters()))
    eng = HybridParallelEngine(fleet.distributed_model(model), opt,
                               lambda mm, i, l: mm.loss(i, l), mesh=hcg.mesh)
    res.update(engine_throughput(eng, ids, labels, cfg, n_params, "14a"))
    print(f"  (14a) step {res['step_ms']:.2f} ms and peak "
          f"{res['peak_gib']:.2f} GiB beside 13a's {base['step_ms']:.2f} ms "
          f"and {base['peak_gib']:.2f} GiB")
    res["engine_13a"] = {"step_ms": base["step_ms"],
                         "peak_gib": base["peak_gib"]}
    del eng, opt
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    res["mp_layout"] = mp_layout_check(model)
    torch.cuda.empty_cache()
    res["sequence_parallel"] = sequence_parallel_check(
        hcg.get_sequence_parallel_group())
    torch.cuda.empty_cache()
    res.update(model="gpt3_1p3b", batch=list(ids.shape), world=1,
               backend=dist.get_backend())
    return res


PIPE_B, PIPE_MICRO = 4, 4  # 15a: b4 x s2048 in 4 micro-batches
PIPE_REL_TOL = 1e-3  # 15a: the schedules against the engine, if not bit-equal
MOE_SHAPE = (4, 2048, 2048, 8192, 8, 2)  # 15c: B, T, d_model, d_hidden, E, k
# 15c: the bf16 layer against the f32 plain per-expert loop on the same bf16
# inputs and routing, by relative norm: h (8192 wide) and the output are
# rounded to bf16 once each, the gate values and the gradients' products
# too (~0.4% each)
MOE_REL_TOL = 2e-2
# the gate's gradient and the auxiliary loss go through the bf16 softmax
# (probabilities rounded to bf16, their mean taken in bf16)
MOE_GATE_REL_TOL = 5e-2
DGC_SPARSITY = 0.999  # 15d


def pipeline_gpt(cfg, device, gen):
    """GPT-3 1.3B as a one-stage ``PipelineLayer``: the embedding and the
    tied LM head as one ``SharedLayerDesc`` key (the head through its
    ``forward_func``), the decoder layers, the final LayerNorm, and the
    cross-entropy as ``loss_fn``."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, PipelineLayer, SharedLayerDesc)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import \
        tied_logits
    from paddle_tpu_torch.models.gpt import GPTDecoderLayer, GPTEmbeddings
    from paddle_tpu_torch.nn import LayerNorm
    from paddle_tpu_torch.nn import functional as F

    kw = {"device": device, "dtype": torch.bfloat16}
    emb = {"generator": gen, **kw}

    def head(layer, x):
        return tied_logits(x, layer.word_embeddings)

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))

    descs = [SharedLayerDesc("embed", GPTEmbeddings, None,
                             "word_embeddings.weight", cfg, **emb)] \
        + [LayerDesc(GPTDecoderLayer, cfg, **emb)
           for _ in range(cfg.num_layers)] \
        + [LayerDesc(LayerNorm, cfg.hidden_size, epsilon=1e-5, **kw),
           SharedLayerDesc("embed", GPTEmbeddings, head,
                           "word_embeddings.weight", cfg, **emb)]
    return PipelineLayer(descs, num_stages=1, loss_fn=loss_fn).train()


def pipeline_check(hcg):
    """15a: GPT-3 1.3B as a one-stage PipelineLayer, 3 AdamW steps from one
    start by 1F1B, F-then-B and the engine at grad_accumulate=4, each
    schedule's peak; then 2 warm-up and 8 timed 1F1B steps."""
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineTrainStep
    from paddle_tpu_torch.models import gpt3_1p3b
    from paddle_tpu_torch.ops import kernels as K

    cfg = gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0, remat=False,
                    attention_impl="flash")
    dev = torch.device("cuda")
    pl = pipeline_gpt(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    ids, labels = train_batch(cfg, PIPE_B, seed=3)
    n_params = sum(p.numel() for p in pl.parameters())
    start = [p.detach().clone() for p in pl.parameters()]

    def schedule(sch):
        def make(opt):
            return PipelineTrainStep(pl, opt, hcg.mesh, n_micro=PIPE_MICRO,
                                     schedule=sch)
        return make

    def engine(opt):
        return HybridParallelEngine(
            pl, opt, lambda m, i, l: m._loss_fn(m(i), l), mesh=hcg.mesh,
            grad_accumulate=PIPE_MICRO).train_step

    runs = {}
    for tag, make in (("1F1B", schedule("1F1B")),
                      ("F-then-B", schedule("F-then-B")),
                      ("engine_acc4", engine)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, params = engine_run(pl, start, make, ids=ids, labels=labels)
        peak = torch.cuda.max_memory_allocated()
        # off the card, so no run's peak counts another's parameters
        runs[tag] = (losses, [p.cpu() for p in params], peak)
        del params
    ref_l, ref_p, _ = runs["engine_acc4"]
    out = {"model": "gpt3_1p3b", "stages": 1, "batch": [PIPE_B, cfg.max_position_embeddings],
           "n_micro": PIPE_MICRO}
    for tag in ("1F1B", "F-then-B"):
        losses, params, peak = runs[tag]
        bits = all(torch.equal(a, b) for a, b in zip(params, ref_p))
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(params, ref_p))
        rel = max(rel_err(a, b) for a, b in zip(params, ref_p))
        lrel = rel_diff(losses, ref_l)
        print(f"  (15a) {tag}: {ENGINE_STEPS} AdamW steps from one start "
              f"{losses} against the engine at grad_accumulate="
              f"{PIPE_MICRO} {ref_l}: parameters bit-equal {bits}, max abs "
              f"difference {diff:.3e}, worst relative norm {rel:.3e}, "
              f"losses relative {lrel:.3e} (tol {PIPE_REL_TOL} unless "
              f"bit-equal); peak {peak / 2**30:.2f} GiB")
        if not bits and not (rel <= PIPE_REL_TOL and lrel <= PIPE_REL_TOL):
            fail(f"pipeline {tag}: parameters {rel}, losses {lrel} against "
                 "the engine")
        out[tag] = {"losses": losses, "bit_equal": bits,
                    "max_param_abs_diff": diff, "max_param_rel_err": rel,
                    "loss_rel_diff": lrel, "peak_gib": peak / 2**30}
    out["engine_acc4"] = {"losses": ref_l,
                          "peak_gib": runs["engine_acc4"][2] / 2**30}
    del runs, ref_p
    if not out["1F1B"]["peak_gib"] < out["F-then-B"]["peak_gib"]:
        fail(f"pipeline: 1F1B's peak {out['1F1B']['peak_gib']} GiB is not "
             f"below F-then-B's {out['F-then-B']['peak_gib']}")
    import paddle_tpu_torch as pt

    with torch.no_grad():
        for p, s in zip(pl.parameters(), start):
            p.copy_(s)
    del start
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=pl.named_parameters())
    step = PipelineTrainStep(pl, opt, hcg.mesh, n_micro=PIPE_MICRO)
    warm = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    timed, queued, wall = time_steps(step, ids, labels, TRAIN_STEPS)
    counts = K.launch_counts()
    B, T = ids.shape
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    mfu = tok_s * train_flops_per_token(cfg, n_params, T) / 989e12
    vals = [x.item() for x in warm + timed]
    want = cfg.num_layers * PIPE_MICRO * TRAIN_STEPS
    launches = {k: counts[k] for k in FLASH_REPLACES}
    print(f"  (15a) 1F1B: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up, "
          f"step {step_ms:.2f} ms (host clock, one sync at the end), "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f}; stash high-water "
          f"{step.stash_high_water}; launches {launches} (want {want} "
          f"each); losses {[round(v, 4) for v in vals]}")
    if any(n != want for n in launches.values()) \
            or not all(np.isfinite(vals)) or not vals[-1] < vals[0]:
        fail(f"pipeline 1F1B: launches {launches}, losses {vals}")
    out.update(step_ms=step_ms, tokens_per_s=tok_s, mfu=mfu,
               queued_ms=queued * 1e3, timed_losses=vals,
               stash_high_water=step.stash_high_water, launches=launches)
    del step, opt, pl
    torch.cuda.empty_cache()
    return out


def zero3_check(model, start, ids, labels, l_eng, p_eng, hcg):
    """15b: ``group_sharded_parallel(level="p_g_os")`` over the one-rank
    sharding group on phase 14's model and batch: 3 engine steps from one
    start bit-equal to 13a's (and 14a's) engine."""
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        group_sharded_parallel

    def make(opt):
        m, o, _ = group_sharded_parallel(
            model, opt, "p_g_os", group=hcg.get_sharding_parallel_group())
        return HybridParallelEngine(m, o, lambda mm, i, l: mm.loss(i, l),
                                    mesh=hcg.mesh, dp_axes=()).train_step

    losses, params = engine_run(model, start, make, ids=ids, labels=labels)
    bits = losses == l_eng and all(torch.equal(a.cpu(), b)
                                   for a, b in zip(params, p_eng))
    print(f"  (15b) p_g_os (ShardingStage3) over the one-rank sharding "
          f"group: {ENGINE_STEPS} steps from one start {losses}, 13a's "
          f"engine {l_eng}: losses and parameters bit-equal {bits}")
    if not bits:
        fail("zero-3: not bit-equal to phase 13a's engine")
    return {"losses": losses, "bit_equal": bits}


def moe_plain(x, gate_w, w_up, w_down, gate_idx, cf, act):
    """The f32 plain form of the MoE layer with the routing fixed to
    ``gate_idx``: each expert's kept tokens through its FFN in a loop,
    weighted by the softmax's values at the fixed experts; (out, aux)."""
    T, k = gate_idx.shape
    E = w_up.shape[0]
    probs = torch.softmax(x @ gate_w, dim=-1)
    vals = probs.gather(1, gate_idx)
    C = int(np.ceil(k * T * cf / E))
    onehot = torch.nn.functional.one_hot(gate_idx, E).reshape(T * k, E)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1).reshape(T, k) - 1
    keep = pos < C
    out = torch.zeros_like(x)
    for e in range(E):
        for j in range(k):
            rows = ((gate_idx[:, j] == e) & keep[:, j]).nonzero()[:, 0]
            y = act(x[rows] @ w_up[e]) @ w_down[e]
            out = out.index_add(0, rows, y * vals[rows, j:j + 1])
    me = probs.mean(0)
    ce = torch.nn.functional.one_hot(gate_idx[:, 0], E).float().mean(0)
    return out, (me * ce).sum() * E


def moe_check():
    """15c: MoELayer at full width in bf16 on 8192 tokens: the one-rank ep
    group against the local path (bit for bit), the layer against the f32
    plain per-expert loop on the card's routing, drops, and its forward
    and backward times."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.fleet.meta_parallel import MoELayer
    from paddle_tpu_torch.distributed.fleet.meta_parallel.moe_layer import \
        act_fn

    B, T, d, h, E, k = MOE_SHAPE
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    local = MoELayer(d, h, E, top_k=k, device=dev, dtype=torch.bfloat16,
                     generator=gen)
    group = C.new_group([0], axis_name="ep")
    ep = MoELayer(d, h, E, top_k=k, ep_group=group, device=dev,
                  dtype=torch.bfloat16)
    ep.set_state_dict(local.state_dict())
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(B, T, d, device=dev, generator=g).to(torch.bfloat16)
    cot = torch.randn(B, T, d, device=dev, generator=g).to(torch.bfloat16)
    res = {}
    for tag, layer in (("local", local), ("ep1", ep)):
        xl = x.detach().clone().requires_grad_()
        out = layer(xl)
        (out.float() * cot.float()).sum().add(layer.aux_loss.float() * 0.01) \
            .backward()
        res[tag] = (out.detach(), layer.aux_loss.detach(), xl.grad,
                    {n: p.grad.clone() for n, p in layer.named_parameters()})
    lo, ea = res["local"], res["ep1"]
    bits = torch.equal(lo[0], ea[0]) and torch.equal(lo[1], ea[1]) \
        and torch.equal(lo[2], ea[2]) and all(
            torch.equal(lo[3][n], ea[3][n]) for n in lo[3])
    gate_idx = local.last_routing[2]
    dropped = local.dropped_tokens()
    leaves = [t.detach().float().requires_grad_() for t in (
        x.reshape(-1, d), local.gate.weight, local.w_up, local.w_down)]
    po, paux = moe_plain(*leaves, gate_idx, local.capacity_factor,
                         act_fn(local.act))
    (po * cot.reshape(-1, d).float()).sum().add(paux * 0.01).backward()
    rels = {"out": rel_err(lo[0].reshape(-1, d), po.detach()),
            "aux": abs(float(lo[1]) - float(paux.detach()))
            / abs(float(paux.detach())),
            "dx": rel_err(lo[2].reshape(-1, d), leaves[0].grad),
            "dgate": rel_err(lo[3]["gate.weight"], leaves[1].grad),
            "dw_up": rel_err(lo[3]["w_up"], leaves[2].grad),
            "dw_down": rel_err(lo[3]["w_down"], leaves[3].grad)}
    del leaves, po, paux, res
    xt = x.detach().clone().requires_grad_()

    def fwd():
        with torch.no_grad():
            local(x)

    def fwd_bwd():
        local.zero_grad(set_to_none=True)
        out = local(xt)
        out.backward(cot)

    fwd_ms = time_ms(fwd, 5)
    fb_ms = time_ms(fwd_bwd, 5)
    n_choices = B * T * k
    print(f"  (15c) MoELayer(d_model={d}, d_hidden={h}, n_experts={E}, "
          f"top_k={k}) bf16 on {B * T} tokens: the one-rank ep group "
          f"bit-equal to the local path {bits}; against the f32 plain "
          f"per-expert loop on the card's routing "
          + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
          + f" (tol {MOE_REL_TOL}; dgate and aux {MOE_GATE_REL_TOL}); "
          f"{dropped} of {n_choices} token choices dropped at capacity; "
          f"forward {fwd_ms:.3f} ms, backward {fb_ms - fwd_ms:.3f} ms (CUDA "
          "events)")
    tol = {n: MOE_GATE_REL_TOL if n in ("dgate", "aux") else MOE_REL_TOL
           for n in rels}
    if not bits or not all(rels[n] <= tol[n] for n in rels):
        fail(f"moe: bit-equal {bits}, errors {rels}")
    del local, ep, x, xt, cot
    torch.cuda.empty_cache()
    return {"shape": list(MOE_SHAPE), "ep1_bit_equal": bits,
            "rel_err_vs_plain": rels, "tol": tol,
            "dropped": dropped, "choices": n_choices, "fwd_ms": fwd_ms,
            "bwd_ms": fb_ms - fwd_ms}


def dgc_localsgd_check():
    """15d: GPT-3 1.3B with DGCMomentumOptimizer (sparsity 0.999) for 3
    eager steps beside plain Momentum (one layer's update checked against
    the CPU rule bit for bit), then LocalSGDOptimizer(k_steps=2) for 4
    steps, whose sync at world 1 is the identity."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.tensor import Parameter
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer, LocalSGDOptimizer)

    model = train_model()
    ids, labels = train_batch(model.config)
    start = [p.detach().clone() for p in model.parameters()]
    probe = "gpt.layers.0.attn.qkv.weight"
    res = {}

    def restore():
        with torch.no_grad():
            for p, s in zip(model.parameters(), start):
                p.copy_(s)
                p.grad = None

    def run(opt, n, tag):
        losses, step_ms, cpu_check = [], [], None
        for i in range(n):
            loss = model.loss(ids, labels)
            loss.backward()
            if tag == "dgc" and i == n - 1:
                p = dict(model.named_parameters())[probe]
                before = (p.detach().cpu(), p.grad.cpu(),
                          opt._u[p.name].cpu(), opt._v[p.name].cpu())
            torch.cuda.synchronize()
            t0 = time.monotonic()
            opt.step()
            torch.cuda.synchronize()
            step_ms.append((time.monotonic() - t0) * 1e3)
            opt.clear_grad()
            losses.append(loss.item())
        if tag == "dgc":
            w, g, u, v = before
            cp = Parameter(w.clone(), name=probe)
            cp.grad = g
            cpu = DGCMomentumOptimizer(opt.get_lr(), opt._momentum, [cp],
                                       sparsity=(DGC_SPARSITY,))
            cpu._step_count = opt._step_count - 1
            cpu._u, cpu._v = {cp.name: u}, {cp.name: v}
            cpu.step()
            card = dict(model.named_parameters())[probe].detach().cpu()
            cpu_check = bool(torch.equal(cp.detach(), card))
        return losses, step_ms, cpu_check

    restore()
    dgc = DGCMomentumOptimizer(1e-3, 0.9, model.parameters(),
                               sparsity=(DGC_SPARSITY,))
    l_dgc, ms_dgc, bits = run(dgc, ENGINE_STEPS, "dgc")
    frac = dgc.last_comm_fraction
    del dgc
    restore()
    mom = pt.optimizer.Momentum(1e-3, momentum=0.9,
                                parameters=model.parameters())
    l_mom, ms_mom, _ = run(mom, ENGINE_STEPS, "momentum")
    del mom
    print(f"  (15d) DGCMomentumOptimizer(sparsity {DGC_SPARSITY}) on "
          f"gpt3_1p3b, {ENGINE_STEPS} steps: losses {l_dgc}, "
          f"last_comm_fraction {frac:.6f}, optimizer step "
          f"{[round(m, 2) for m in ms_dgc]} ms against Momentum's "
          f"{[round(m, 2) for m in ms_mom]} ms (losses {l_mom}); {probe}'s "
          f"last update bit-equal to the CPU rule on the card's gradient "
          f"{bits}")
    if not bits or not all(np.isfinite(l_dgc)) \
            or not abs(frac - (1 - DGC_SPARSITY)) < 1e-4:
        fail(f"dgc: cpu bit-equal {bits}, fraction {frac}, losses {l_dgc}")
    res["dgc"] = {"losses": l_dgc, "last_comm_fraction": frac,
                  "step_ms": ms_dgc, "momentum_step_ms": ms_mom,
                  "momentum_losses": l_mom, "cpu_bit_equal": bits,
                  "probe": probe}
    finals = {}
    for tag in ("localsgd", "sgd"):
        restore()
        sgd = pt.optimizer.SGD(1e-3, parameters=model.parameters())
        opt = LocalSGDOptimizer(sgd, k_steps=2) if tag == "localsgd" else sgd
        losses, _, _ = run(opt, 4, tag)
        finals[tag] = (losses, [p.detach().clone()
                                for p in model.parameters()])
        del opt, sgd
    same = finals["localsgd"][0] == finals["sgd"][0] and all(
        torch.equal(a, b) for a, b in zip(finals["localsgd"][1],
                                          finals["sgd"][1]))
    print(f"  (15d) LocalSGDOptimizer(k_steps=2) over SGD, 4 steps: losses "
          f"{finals['localsgd'][0]}; the sync at world 1 is the identity: "
          f"bit-equal to plain SGD {same}")
    if not same:
        fail("localsgd: the sync at world 1 changed the parameters")
    res["localsgd"] = {"losses": finals["localsgd"][0],
                       "identity_bit_equal": same}
    del finals, model, start
    torch.cuda.empty_cache()
    return res


def fleet_part2_phase(model, start, ids, labels, l_eng, p_eng):
    """Phase 15 on phase 14's NCCL group of one rank: (15b) ZeRO-3 on phase
    14's model first, then (15a) pipeline, (15c) MoE, (15d) DGC and
    LocalSGD on models of their own."""
    from paddle_tpu_torch.distributed import fleet

    hcg = fleet.get_hybrid_communicate_group()
    out = {"zero3": zero3_check(model, start, ids, labels, l_eng, p_eng,
                                hcg)}
    return out, hcg


def fleet_part2_rest(out, hcg):
    out["pipeline"] = pipeline_check(hcg)
    out["moe"] = moe_check()
    out.update(dgc_localsgd_check())
    return out


# -- phase 16: auto-parallel, the coordinated checkpoint, the sentinel's
# anchor and the elastic launcher ---------------------------------------------
ANCHOR_LAYERS = 2  # 16c/16d: full width, depth cut for the anchors' disk/time
LAUNCH_STEPS = 5   # 16d: the worker's steps; preempted after LAUNCH_PREEMPT
LAUNCH_PREEMPT = 3
LAUNCH_SAVE_EVERY = 4
SENTINEL_SPIKE = 6  # 16c: the batch whose loss spikes


def params_equal(model, want):
    """Every parameter bit-equal to ``want`` (host tensors)."""
    return all(torch.equal(p.detach().cpu(), w)
               for p, w in zip(model.parameters(), want))


def gpt_head_loss(model):
    """The f32 cross-entropy of the tied head on the GPT body's output
    (what ``GPTForPretraining.loss`` computes), vocab-parallel when the
    table is."""
    from paddle_tpu_torch.nn import functional as F

    emb = model.gpt.embeddings.word_embeddings

    def loss(x, labels):
        return F.fused_linear_cross_entropy(
            x, emb.weight, labels,
            group=emb.group if emb.world_size > 1 else None)
    return loss


def auto_engine_of(model):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import auto_parallel

    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    return auto_parallel.Engine(model.gpt, loss=gpt_head_loss(model),
                                optimizer=opt)


def auto_parallel_check(ids, labels, l_eng, p_eng):
    """16a: GPT-3 1.3B through ``auto_parallel.Engine`` on the one-rank
    mesh: the plan search's report, 3 steps through ``fit`` from 13a's
    start against 13a's engine, then 2 warm-up and 8 timed steps;
    ``shard_tensor``/``reshard`` of a card tensor at world 1."""
    from paddle_tpu_torch.distributed import sharding_api
    from paddle_tpu_torch.ops import kernels as K

    model = train_model()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    eng = auto_engine_of(model)
    t0 = time.monotonic()
    best = eng.auto_parallelize(ids, labels)
    search_s = time.monotonic() - t0
    plans = []
    for p in eng.plans:
        rep = p.report
        plans.append({"name": p.name, "score": list(p.score),
                      "flops": rep["flops"],
                      "bytes_accessed": rep["bytes_accessed"],
                      "comm_counts": rep["comm_counts"],
                      "comm_bytes": rep["comm_bytes"],
                      "peak_gib": rep["peak_memory_bytes"] / 2**30})
        print(f"  (16a) plan {p.name}: {rep['flops'] / 1e12:.3f} TFLOP "
              f"(FlopCounterMode + the flash kernels' tally), "
              f"{rep['bytes_accessed'] / 2**30:.2f} GiB read and written by "
              f"the aten ops, collectives {rep['comm_counts']} "
              f"({rep['comm_bytes']:.0f} bytes), peak "
              f"{rep['peak_memory_bytes'] / 2**30:.2f} GiB, score {p.score}")
    if [p["name"] for p in plans] != ["replicated"] \
            or best.name != "replicated":
        fail(f"auto_parallel: plans {[p['name'] for p in plans]}, winner "
             f"{best.name}; at mp 1 only 'replicated' is derived")
    losses = eng.fit([(ids, labels)] * ENGINE_STEPS)
    bits = losses == l_eng and params_equal(model, p_eng)
    print(f"  (16a) plan search {search_s:.2f} s; fit from 13a's start, "
          f"{ENGINE_STEPS} steps: {losses} against 13a's engine {l_eng}: "
          f"losses and parameters bit-equal {bits}")
    if not bits:
        fail(f"auto_parallel: fit {losses} against 13a's {l_eng}")
    step = eng._engine.train_step
    warm = [step(ids, labels) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    timed, queued, wall = time_steps(step, ids, labels, TRAIN_STEPS)
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    B, T = ids.shape
    step_ms = wall / TRAIN_STEPS * 1e3
    tok_s = B * T * TRAIN_STEPS / wall
    mfu = tok_s * train_flops_per_token(cfg, n_params, T) / 989e12
    vals = [x.item() for x in warm + timed]
    print(f"  (16a) {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: step "
          f"{step_ms:.2f} ms, {tok_s:.1f} tokens/s, MFU {mfu:.4f} (989 "
          f"TFLOP/s), peak {peak / 2**30:.2f} GiB, launches {counts}")
    want = cfg.num_layers * TRAIN_STEPS
    if any(counts[k] != want for k in FLASH_REPLACES):
        fail(f"auto_parallel: launches {counts}, want {want} each")
    if not all(np.isfinite(vals)):
        fail(f"auto_parallel: losses {vals}")
    # the sharding API on the card at world 1: the identity, bit for bit
    x = torch.randn(64, 2048, device=ids.device, dtype=torch.bfloat16)
    s = sharding_api.shard_tensor(x, None, ["dp", None])
    y = sharding_api.reshard(s, [None, "dp"])
    same = torch.equal(s, x) and torch.equal(y, x) \
        and tuple(y.placement) == (None, "dp")
    print(f"  (16a) shard_tensor/reshard of a (64, 2048) bf16 card tensor "
          f"at world 1: bit-equal {same}")
    if not same:
        fail("sharding_api: a world-1 placement changed the tensor")
    out = {"plans": plans, "winner": best.name, "search_s": search_s,
           "fit_losses": losses, "fit_bit_equal_13a": bits,
           "step_ms": step_ms, "tokens_per_s": tok_s, "mfu": mfu,
           "peak_gib": peak / 2**30, "losses": vals,
           "launches": {k: counts[k] for k in FLASH_REPLACES},
           "shard_reshard_bit_equal": same}
    return out, model, eng


def coordinated_check(model, eng, ids, labels, d):
    """16b: ``CoordinatedCheckpoint`` (store: the ``TCPStore`` adapter) of
    16a's engine state: an async save after step k waited on while steps
    k+1 and k+2 run; a fresh engine restored by ``resume`` runs the same
    two steps bit for bit; a flipped byte is named."""
    from paddle_tpu_torch.distributed import TCPStore
    from paddle_tpu_torch.distributed import checkpoint as ck

    free = shutil.disk_usage(d).free
    store = TCPStore("127.0.0.1", 0, is_master=True, timeout=60)
    cc = ck.CoordinatedCheckpoint(str(d / "coord"), world_size=1, rank=0,
                                  store=store, async_save=True)
    opt = eng.optimizer
    k = opt._step_count
    state = ck.engine_state_dict(eng._engine)
    nbytes = sum(t.numel() * t.element_size() for t in state.values())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    if not cc.save_now(k, state):
        fail("coordinated checkpoint: the async save did not start")
    blocked = time.monotonic() - t0
    after = [eng._engine.train_step(ids, labels) for _ in range(2)]
    vals = [x.item() for x in after]  # the two steps ran during the write
    t1 = time.monotonic()
    committed = cc.wait()
    waited = time.monotonic() - t1
    write_s = time.monotonic() - t0
    want = [p.detach().cpu() for p in model.parameters()]
    print(f"  (16b) async save of step {k}: {nbytes / 1e9:.3f} GB "
          f"({len(state)} leaves; {free / 1e9:.1f} GB free), host blocked "
          f"{blocked * 1e3:.1f} ms, the write {write_s:.2f} s from the call "
          f"(waited {waited:.2f} s after steps {k + 1}-{k + 2}), committed "
          f"{committed}")
    if not committed:
        fail("coordinated checkpoint: the save did not commit")
    fresh = train_model()
    feng = auto_engine_of(fresh)
    feng.prepare()
    fstate = ck.engine_state_dict(feng._engine)
    t0 = time.monotonic()
    step = cc.resume(fstate)
    ck.engine_apply_state(feng._engine, fstate)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    again = [feng._engine.train_step(ids, labels).item() for _ in range(2)]
    bits = step == k and again == vals and params_equal(fresh, want)
    print(f"  (16b) a fresh engine resumed step {step} in {restore_s:.2f} s; "
          f"steps {k + 1}-{k + 2}: {again} against {vals}: losses and "
          f"parameters bit-equal {bits}")
    if not bits:
        fail(f"coordinated checkpoint: resumed {step}, losses {again} "
             f"against {vals}")
    del fresh, feng, fstate
    torch.cuda.empty_cache()
    path = Path(cc._rank_path(k))
    index = json.loads((path / "index.json").read_text())["leaves"]
    leaf = index[0]
    f = path / leaf["file"]
    raw = bytearray(f.read_bytes()[:64])
    with open(f, "r+b") as fh:
        fh.seek(17)
        fh.write(bytes([raw[17] ^ 0x20]))
    try:
        ck.load_state_dict(ck.engine_state_dict(eng._engine), str(path))
        named = False
    except ck.CheckpointError as e:
        named = f"'{leaf['key']}'" in str(e)
        print(f"  (16b) one flipped byte in {leaf['file']}: {e}")
    if not named:
        fail("coordinated checkpoint: a flipped byte was not named")
    store.close()
    return {"step": k, "bytes": nbytes, "leaves": len(state),
            "host_blocked_ms": blocked * 1e3, "write_s": write_s,
            "waited_s": waited, "restore_s": restore_s,
            "losses_after": vals, "resumed_losses": again,
            "resume_bit_equal": bits, "corrupt_byte_named": named}


def sentinel_check(d):
    """16c: ``StabilitySentinel.from_flags`` (its ``AutoCheckpoint`` anchor
    in ``FLAGS_stability_ckpt_dir``) and ``for_engine`` at full width and
    ``ANCHOR_LAYERS`` layers: the spiked batch rolls back to the anchor,
    and the replay's next step equals the anchor's continuation bit for
    bit."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.fault.sentinel import StabilitySentinel
    from paddle_tpu_torch.framework.flags import set_flags

    set_flags({"FLAGS_stability_ckpt_dir": str(d / "anchor"),
               "FLAGS_stability_anchor_interval": 2})
    try:
        base = StabilitySentinel.from_flags()
    finally:
        set_flags({"FLAGS_stability_ckpt_dir": "",
                   "FLAGS_stability_anchor_interval": 25})
    anchor = base.anchor
    base.close()
    model = train_model(ANCHOR_LAYERS)
    cfg = model.config
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    # the batch carries a float loss weight (1.0): the spike scales the
    # batch's floating tensors, and the ids and labels are integers
    eng = HybridParallelEngine(model, opt,
                               lambda m, i, l, w: m.loss(i, l) * w)
    s = StabilitySentinel.for_engine(eng, anchor, window=16, warmup=3,
                                     zmax=8.0, max_rollbacks=1)
    one = torch.ones((), device=model.parameters()[0].device)
    batches = {k: (*train_batch(cfg, seed=200 + k), one)
               for k in range(1, 9)}
    inject.arm(f"loss.spike:step={SENTINEL_SPIKE},scale=1000")
    seen, after, rolled, replay = {}, {}, None, None
    t0 = time.monotonic()
    try:
        for k in range(1, 9):
            s.note_batch((0, k))
            seen[k] = eng.train_step(*batches[k]).item()
            after[k] = [p.detach().clone() for p in model.parameters()]
            s.maybe_anchor(opt._step_count)
            v = s.take_verdict()
            if v is not None:
                a = s.rollback(v)
                rolled = (v.step, v.action, a)
                # the replay of the batch after the anchor
                s.note_batch((0, a + 1))
                replay = eng.train_step(*batches[a + 1]).item()
                same = replay == seen[a + 1] and all(
                    torch.equal(p, q) for p, q in zip(model.parameters(),
                                                      after[a + 1]))
                break
    finally:
        inject.disarm()
        s.close()
    wall = time.monotonic() - t0
    print(f"  (16c) sentinel (from_flags anchor, for_engine), gpt3_1p3b at "
          f"full width and {ANCHOR_LAYERS} layers (depth cut for the "
          f"anchor's disk and time): losses {[round(v, 4) for v in seen.values()]}"
          f"; verdict (step, action, anchor) {rolled}; the replayed step "
          f"{rolled[2] + 1 if rolled else None}: {replay} against "
          f"{seen.get(rolled[2] + 1) if rolled else None}, bit-equal with "
          f"its parameters {rolled is not None and same}; {wall:.2f} s")
    if rolled is None or rolled[:2] != (SENTINEL_SPIKE, "rollback") \
            or not same:
        fail(f"sentinel: verdict {rolled}, replay {replay}")
    return {"layers": ANCHOR_LAYERS, "verdict": list(rolled),
            "replayed_loss": replay, "continuation_bit_equal": same,
            "losses": list(seen.values()), "s": wall}


def launch_worker_train(out, steps=LAUNCH_STEPS):
    """16d's worker body: GPT at full width and ``ANCHOR_LAYERS`` layers
    through the engine with an ``AutoCheckpoint`` and a
    ``PreemptionGuard``, each step's loss appended to
    ``<out>/losses.txt`` (``float.hex``). A resumed run first notes the
    phase of this rank's last progress record and the time."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.distributed.checkpoint import (AutoCheckpoint,
                                                         engine_apply_state,
                                                         engine_state_dict)
    from paddle_tpu_torch.fault.preemption import PreemptionGuard

    model = train_model(ANCHOR_LAYERS)
    cfg = model.config
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.named_parameters())
    eng = HybridParallelEngine(model, opt, lambda m, i, l: m.loss(i, l))
    ckpt = AutoCheckpoint(str(out / "ck"), interval_steps=LAUNCH_SAVE_EVERY,
                          keep_last=2)
    state = engine_state_dict(eng)
    start = ckpt.resume(state)
    if start >= 0:
        engine_apply_state(eng, state)
        pdir = os.environ.get("PADDLE_TPU_PROGRESS_DIR")
        rec = Path(pdir or "") / "rank_0.json"
        phase = json.loads(rec.read_text()).get("phase") \
            if pdir and rec.exists() else None
        (out / "resumed.json").write_text(json.dumps(
            {"step": start, "phase": phase, "t": time.time()}))
    with PreemptionGuard(checkpoint=ckpt) as guard:
        for k in range(max(start, 0) + 1, steps + 1):
            loss = eng.train_step(*train_batch(cfg, seed=300 + k)).item()
            with open(out / "losses.txt", "a") as f:
                f.write(float(loss).hex() + "\n")
            st = engine_state_dict(eng)
            ckpt.maybe_save(k, st)
            if guard.preempted or k == LAUNCH_PREEMPT:
                (out / "drained.json").write_text(json.dumps(
                    {"step": k, "t": time.time()}))
            guard.check(k, st)


def launch_worker(out_dir):
    """``chip_smoke.py --launch-worker <dir>``: the process ``launch``
    starts in 16d (one a card): joins the NCCL world and trains."""
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch import distributed as dist

    dist.init_parallel_env()
    try:
        launch_worker_train(Path(out_dir))
    finally:
        dist.destroy_process_group()


def launch_check(d):
    """16d: ``launch(nproc_per_node=1, elastic=True)`` of this script's
    worker with ``PADDLE_FAULT_INJECT=preempt.sigterm:step=3``: the worker
    drains (a ``preempt_drain`` progress record) and exits 75, the
    launcher relaunches it, it resumes, and its losses equal an
    uninterrupted run's (here, in this process) bit for bit."""
    from paddle_tpu_torch.distributed import launch

    ref = d / "uninterrupted"
    ref.mkdir()
    launch_worker_train(ref)
    want = (ref / "losses.txt").read_text().split()
    torch.cuda.empty_cache()
    run = d / "launched"
    run.mkdir()
    env = {"PADDLE_FAULT_INJECT": f"preempt.sigterm:step={LAUNCH_PREEMPT}"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.monotonic()
    try:
        rc = launch(str(Path(__file__).resolve()),
                    ["--launch-worker", str(run)], nproc_per_node=1,
                    coordinator_port=free_port(), elastic=True,
                    log_dir=str(run / "logs"))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.monotonic() - t0
    got = (run / "losses.txt").read_text().split() \
        if (run / "losses.txt").exists() else []
    drained = json.loads((run / "drained.json").read_text()) \
        if (run / "drained.json").exists() else {}
    resumed = json.loads((run / "resumed.json").read_text()) \
        if (run / "resumed.json").exists() else {}
    relaunch_s = resumed.get("t", 0.0) - drained.get("t", 0.0)
    same = got == want
    print(f"  (16d) launch(elastic=True, nproc_per_node=1): rc {rc} in "
          f"{wall:.2f} s; drained at step {drained.get('step')}, relaunched "
          f"and resumed step {resumed.get('step')} (last progress phase "
          f"{resumed.get('phase')!r}) {relaunch_s:.2f} s after the drain; "
          f"losses {[float.fromhex(x) for x in got]} against the "
          f"uninterrupted {[float.fromhex(x) for x in want]}: bit-equal "
          f"{same}")
    if rc != 0 or not same or resumed.get("step") != LAUNCH_PREEMPT \
            or resumed.get("phase") != "preempt_drain":
        fail(f"launch: rc {rc}, losses {got} against {want}, resumed "
             f"{resumed}")
    return {"layers": ANCHOR_LAYERS, "rc": rc, "wall_s": wall,
            "drained_step": drained.get("step"),
            "resumed_step": resumed.get("step"),
            "resumed_phase": resumed.get("phase"), "relaunch_s": relaunch_s,
            "losses": [float.fromhex(x) for x in got],
            "bit_equal_uninterrupted": same}


def auto_parallel_ckpt_phase(ids, labels, l_eng, p_eng):
    """Phase 16 on phase 13's NCCL group of one rank (after phase 15)."""
    t0 = time.monotonic()
    d = Path(tempfile.mkdtemp(prefix="paddle_tpu_torch_phase16_"))
    try:
        out, model, eng = auto_parallel_check(ids, labels, l_eng, p_eng)
        out["checkpoint"] = coordinated_check(model, eng, ids, labels, d)
        del model, eng
        torch.cuda.empty_cache()
        out["sentinel"] = sentinel_check(d)
        torch.cuda.empty_cache()
        out["launch"] = launch_check(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["wall_s"] = time.monotonic() - t0
    print(f"  phase 16: {out['wall_s']:.1f} s")
    return out


def llama_oom_phase(model, opt, cfg):
    """13c, run at the end of phase 8 on its model and optimizer: Llama-7B
    at b4 x s2048 through the engine meets a real torch.OutOfMemoryError;
    the ladder must absorb it by a degrade rung."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.fault import memory
    from paddle_tpu_torch.framework.flags import set_flags

    ids, labels = train_batch(cfg, LLAMA_OOM_B, LLAMA_TRAIN_T, seed=1)
    eng = HybridParallelEngine(model, opt, lambda m, i, l: m.loss(i, l))
    c0 = profiler.counters()
    t0 = time.monotonic()
    loss = eng.train_step(ids, labels).item()
    torch.cuda.synchronize()
    rec_s = time.monotonic() - t0
    att = eng.last_oom_attempts or []
    actions = [(a["action"], a.get("ok")) for a in att]
    fp = next((a for a in att if a["action"] == "free_pressure"), {})
    real = bool(att) and att[0].get("type") == "OutOfMemoryError" \
        and "injected" not in att[0].get("message", "")
    print(f"  (13c) llama_7b b{LLAMA_OOM_B} x s{LLAMA_TRAIN_T}: attempts "
          f"{actions}; first: {att[0].get('message', '')[:160] if att else ''}"
          f"; free_pressure released {fp.get('released_bytes')} bytes "
          f"(gradients {fp.get('freed_grad_bytes')}); rung x"
          f"{eng.grad_accumulate} ({eng._dispatch_op}), loss {loss:.4f}, "
          f"the step with its recovery {rec_s * 1e3:.1f} ms")
    degraded = [a for a in att if a["action"].startswith("degrade")
                and a.get("ok")]
    retry_failed = ("retry", False) in actions
    if not real or not retry_failed or not degraded \
            or not np.isfinite(loss):
        fail(f"llama oom: attempts {att}")
    # the next 3 steps under enforce at the card's budget: the first two
    # are measured, the third must be admitted
    set_flags({"FLAGS_hbm_admission": "enforce", "FLAGS_hbm_budget_bytes": 0})
    ms = []
    try:
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            eng.train_step(ids, labels).item()
            ms.append((time.monotonic() - t0) * 1e3)
    except memory.HbmBudgetExceeded as e:
        fail(f"llama oom: the degraded step was not admitted: {e}")
    finally:
        set_flags({"FLAGS_hbm_admission": "off"})
    peak = torch.cuda.max_memory_allocated()  # the admitted third step's
    pred = memory.last_prediction()
    drift = (pred["hbm_predicted_peak_bytes"] - peak) / peak
    c1 = profiler.counters()
    trips = c1.get("hbm_oom_trips", 0) - c0.get("hbm_oom_trips", 0)
    print(f"  (13c) next 3 steps on {eng._dispatch_op} x"
          f"{eng.grad_accumulate}: {[round(x, 2) for x in ms]} ms, peak "
          f"{peak / 2**30:.2f} GiB, out-of-memory trips {trips} in all; "
          f"under enforce the third admitted at budget "
          f"{pred['hbm_budget_bytes']}: predicted "
          f"{pred['hbm_predicted_peak_bytes']}, realized {peak}, drift "
          f"{drift:+.6f}")
    if trips != 1 or eng._dispatch_op != "engine.accum":
        fail(f"llama oom: {trips} trips, dispatch {eng._dispatch_op}")
    return {"batch": [LLAMA_OOM_B, LLAMA_TRAIN_T], "attempts": [
        {k: v for k, v in a.items() if k != "handlers"} for a in att],
        "rung": eng.grad_accumulate, "recovery_step_ms": rec_s * 1e3,
        "next_steps_ms": ms, "degraded_peak_gib": peak / 2**30,
        "admitted_predicted_bytes": pred["hbm_predicted_peak_bytes"],
        "admitted_realized_bytes": peak, "admitted_drift": drift,
        "budget_bytes": pred["hbm_budget_bytes"]}


# -- phase 18: the op surface -------------------------------------------------

OP_SURFACE = {}  # phase 18's results: the {"op_surface": ...} line
OP_TABLE_SHAPE = (4096, 2048)  # b2 x s2048 tokens by GPT-3 1.3B's hidden
OP_TABLE_LARGE = {  # outputs of (4096, 2048)^2 elements or worse
    "diag_embed", "diagflat", "histogramdd", "cartesian_prod"}
OP_TABLE_LINALG = {  # factorizations: held at the model's width in 18c
    "svd", "qr", "eig", "eigh", "eigvals", "eigvalsh", "pinv", "cond",
    "matrix_rank", "cholesky", "inv", "inverse", "det", "slogdet", "lu",
    "matrix_exp", "matrix_norm", "householder_product"}
SURFACE_RESIDUAL = 1e-4  # 18c: ||identity residual|| / ||operand||
AUDIO = (8, 30 * 16000, 400, 160)  # 18d: clips, samples, n_fft, hop
ROUND_TRIP_REL = 1e-5
SPARSE_KEEP = 0.05  # 18f: the FFN weight's largest entries kept
SURFACE_GREEDY = (64, 8)  # 18e: generate's new tokens, while_loop steps


def surface_model(device="cuda", cfg=None):
    """GPT-3 1.3B at full width (bf16, seed 0, dropout 0, flash attention)
    for phase 18 (or ``cfg`` for a rehearsal)."""
    from paddle_tpu_torch.models import GPTForPretraining, gpt3_1p3b

    cfg = cfg or gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0,
                           attention_impl="flash")
    return GPTForPretraining(cfg, device=device, dtype=torch.bfloat16,
                             seed=0).eval()


def surface_sweep(dev="cuda"):
    """(18a) every op of ``all_ops()`` that the spec table or the sweep's
    case list feeds, on ``dev`` in float32 against the CPU, its backward,
    and a bfloat16 run (``paddle_tpu_torch.ops.sweep.run``)."""
    from paddle_tpu_torch.ops import sweep
    from paddle_tpu_torch.ops.registry import all_ops

    t0 = time.monotonic()
    ops = all_ops()
    rep = sweep.run(ops, dev, "cpu")
    reasons = {}
    for name, why in rep["skipped"].items():
        reasons.setdefault(why, []).append(name)
    out = {"registry": len(ops), "ops_run": rep["ops"],
           "grads_held": rep["grads"], "bf16_run": rep["bf16"],
           "mismatches": len(rep["mismatches"]),
           "bf16_nonfinite": rep["bf16_nonfinite"],
           "bf16_unsupported": rep["bf16_unsupported"],
           "grad_unsupported": rep["grad_unsupported"],
           "held_by_identity": rep["nonunique"],
           "skipped": {k: sorted(v) for k, v in reasons.items()},
           "slowest": sorted(rep["seconds"].items(),
                             key=lambda kv: -kv[1])[:8],
           "seconds": time.monotonic() - t0}
    print(f"  (18a) {out['ops_run']} of {len(ops)} registry ops on {dev} "
          f"against the CPU, {out['grads_held']} gradients held, "
          f"{out['bf16_run']} run in bf16, mismatches "
          f"{out['mismatches']}, bf16 non-finite {len(rep['bf16_nonfinite'])}"
          f" ({out['seconds']:.1f} s; slowest " + ", ".join(
              f"{k} {v:.2f}" for k, v in out["slowest"]) + ")")
    for name, why in sorted(rep["mismatches"].items()):
        print(f"    MISMATCH {name}: {why}")
    if rep["mismatches"] or rep["bf16_nonfinite"]:
        fail(f"18a: mismatches {sorted(rep['mismatches'])}, bf16 non-finite "
             f"{rep['bf16_nonfinite']}")
    return out


def op_table(shape=OP_TABLE_SHAPE, platform="cuda"):
    """(18b) ``cost_model.get_static_op_time`` for every one-input op of the
    registry at ``shape``, bf16 and f32, forward and forward + backward,
    each beside its bytes bound at ``cost_model.H100``'s rate (each input
    read and each output written once; the backward adds the output's
    gradient read and the input's gradient written)."""
    from paddle_tpu_torch import cost_model
    from paddle_tpu_torch.ops import inplace, sweep
    from paddle_tpu_torch.ops.registry import all_ops

    t0 = time.monotonic()
    cm = cost_model.CostModel(platform)
    bw = cost_model.H100["peak_bw"]
    rows, skipped = [], {}
    if platform == "cuda":  # the clocks up before the first entry
        time_ms(lambda: torch.ones(4096, 4096, device="cuda").sum(), 50)
    for name, fn in sorted(all_ops().items()):
        why = ("random" if name in sweep.RANDOM else
               "host query" if name in sweep.HOST else
               "CUDA kernel (phase 2)" if name in sweep.KERNELS else
               "in-place" if name in inplace.INPLACE_OPS else
               "linalg (18c)" if name in OP_TABLE_LINALG else
               "output too large" if name in OP_TABLE_LARGE else
               None if sweep.one_input(name, fn) else "needs more inputs")
        if why is not None:
            skipped.setdefault(why, []).append(name)
            continue
        for dtype in ("bfloat16", "float32"):
            for forward in (True, False):
                try:
                    c = cm.get_static_op_time(name, forward, dtype, shape)
                except (RuntimeError, TypeError, ValueError,
                        NotImplementedError, IndexError) as e:
                    mode = "fwd" if forward else "fwd+bwd"
                    skipped.setdefault(f"raised ({mode})", []).append(
                        f"{name} {dtype}: {type(e).__name__}")
                    continue
                nbytes = c["bytes_in"] + c["bytes_out"]
                if not forward:
                    nbytes += c["bytes_in"] + c["bytes_out"] + c["bytes_in"]
                rows.append({"op": name, "dtype": dtype, "forward": forward,
                             "ms": c["op_time"],
                             "bound_ms": nbytes / bw * 1e3})
    for r in rows:
        r["x_bound"] = r["ms"] / max(r["bound_ms"], 1e-12)
        print(f"    {r['op']} {r['dtype']} {'fwd' if r['forward'] else 'fwd+bwd'}"
              f": {r['ms']:.4f} ms, bytes bound {r['bound_ms']:.4f} ms "
              f"({r['x_bound']:.1f}x)")
    far = sorted(rows, key=lambda r: -r["x_bound"])[:10]
    med = sorted(r["x_bound"] for r in rows)[len(rows) // 2] if rows else 0
    out = {"shape": list(shape), "entries": len(cm.static_cost_data()),
           "ops": len({r["op"] for r in rows}), "median_x_bound": med,
           "farthest": [{k: r[k] for k in ("op", "dtype", "forward", "ms",
                                           "bound_ms", "x_bound")}
                        for r in far],
           "skipped": {k: sorted(v) for k, v in skipped.items()},
           "seconds": time.monotonic() - t0}
    print(f"  (18b) per-op table at {tuple(shape)}: {out['entries']} entries "
          f"over {out['ops']} ops, median {med:.1f}x the bytes bound; "
          "farthest: " + ", ".join(
              f"{r['op']} {r['dtype']} {'fwd' if r['forward'] else 'bwd'} "
              f"{r['x_bound']:.0f}x" for r in far)
          + f" ({out['seconds']:.1f} s)")
    if not rows:
        fail("18b: the per-op table is empty")
    return out


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def surface_linalg(model, dev="cuda"):
    """(18c) linalg at the model's width on layer 0's attention output
    weight W (f32) and on A = Wᵀ W / n + I: each result held by its
    identity (relative residual <= SURFACE_RESIDUAL) and against the CPU in
    float64 (within 10 x cond x float32's epsilon, cond the operand's;
    ``det`` and ``slogdet`` within 10 x n x epsilon)."""
    import paddle_tpu_torch.linalg as L

    t0 = time.monotonic()
    w = model.gpt.layers[0].attn.proj.weight.detach().float().to(dev)
    n = w.shape[0]
    a = w.T @ w / n + torch.eye(n, device=dev)
    b = torch.randn(n, 16, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    w64, a64, b64 = w.double().cpu(), a.double().cpu(), b.double().cpu()
    u64, s64, vh64 = torch.linalg.svd(w64)  # one SVD serves svd, pinv, cond
    kw = float(s64[0] / s64[-1])
    e64 = torch.linalg.eigvalsh(a64)
    ka = float(e64[-1] / e64[0])
    eps = torch.finfo(torch.float32).eps
    tol_w, tol_a = 10 * kw * eps, 10 * ka * eps
    eye = torch.eye(n, device=dev)
    res, ref = {}, {}

    def ident(name, num, den):
        res[name] = float(num.norm() / den.norm())

    q, r = L.qr(w)
    ident("qr", q @ r - w, w)
    ref["qr"] = _rel(r.diagonal().abs(), torch.linalg.qr(w64)[1]
                     .diagonal().abs())
    u, s, v = L.svd(w)
    ident("svd", u @ torch.diag(s) @ v.T - w, w)
    ref["svd"] = _rel(s, s64)
    p = L.pinv(w)
    ident("pinv", w @ p @ w - w, w)
    ref["pinv"] = _rel(p, vh64.T @ torch.diag(1 / s64) @ u64.T)
    rank = int(L.matrix_rank(w))
    ref["matrix_rank"] = float(rank != int((s64 > s64[0] * n * torch.finfo(
        torch.float64).eps).sum()))
    ref["norm"] = _rel(L.norm(w), torch.linalg.norm(w64))
    ref["cond"] = _rel(L.cond(w), torch.tensor(kw))
    wv, vv = L.eigh(a)
    ident("eigh", a @ vv - vv * wv, a)
    ref["eigh"] = _rel(wv, e64)
    c = L.cholesky(a)
    ident("cholesky", c @ c.T - a, a)
    ref["cholesky"] = _rel(c, torch.linalg.cholesky(a64))
    xs = L.cholesky_solve(b, c)
    ident("cholesky_solve", a @ xs - b, b)
    ref["cholesky_solve"] = _rel(xs, torch.cholesky_solve(
        b64, torch.linalg.cholesky(a64)))
    xs = L.solve(a, b)
    ident("solve", a @ xs - b, b)
    ref["solve"] = _rel(xs, torch.linalg.solve(a64, b64))
    ai = L.inv(a)
    ident("inv", a @ ai - eye, eye)
    ref["inv"] = _rel(ai, torch.linalg.inv(a64))
    ref["det"] = _rel(L.det(a), torch.linalg.det(a64))
    ref["slogdet"] = _rel(L.slogdet(a), torch.stack(torch.linalg.slogdet(
        a64)))
    lu, piv = L.lu(w)
    pl, lo, up = torch.lu_unpack(lu, piv)
    ident("lu", pl @ lo @ up - w, w)
    lu64, piv64 = torch.linalg.lu_factor(w64)
    pivots_equal = bool(torch.equal(piv.cpu(), piv64))
    # the same pivots give the same factors; else the same product
    ref["lu"] = _rel(lu, lu64) if pivots_equal else _rel(pl @ lo @ up, w64)
    tall = w[:, : n // 2]
    xs, _, _, _ = L.lstsq(tall, b)
    rr = tall @ xs - b
    res["lstsq"] = float((tall.T @ rr).norm() / (tall.norm() * rr.norm()))
    ref["lstsq"] = _rel(xs, torch.linalg.lstsq(tall.double().cpu(), b64,
                                               driver="gelsd").solution)
    xs = L.triangular_solve(c, b, upper=False)
    ident("triangular_solve", c @ xs - b, b)
    ref["triangular_solve"] = _rel(xs, torch.linalg.solve_triangular(
        torch.linalg.cholesky(a64), b64, upper=False))
    tol = {k: (tol_w if k in ("qr", "svd", "pinv", "cond", "lu", "lstsq",
                              "norm", "matrix_rank") else tol_a)
           for k in ref}
    # a determinant sums n rounding errors in its logarithm
    tol["det"] = tol["slogdet"] = 10 * n * eps
    out = {"n": n, "cond_w": kw, "cond_a": ka, "rank": rank,
           "lu_pivots_equal": pivots_equal,
           "residual": res, "vs_cpu_f64": ref,
           "tol_vs_cpu": {"w": tol_w, "a": tol_a, "det": tol["det"]},
           "seconds": time.monotonic() - t0}
    print(f"  (18c) linalg at {n} x {n}: cond(W) {kw:.1f}, cond(A) {ka:.3f}, "
          f"rank {rank}; residuals " + ", ".join(
              f"{k} {v:.1e}" for k, v in res.items()) + "; against f64 "
          + ", ".join(f"{k} {v:.1e}" for k, v in ref.items())
          + f" ({out['seconds']:.1f} s)")
    bad = [k for k, v in res.items() if not v <= SURFACE_RESIDUAL] + \
        [k for k, v in ref.items() if not v <= tol[k]]
    if bad:
        fail(f"18c: {bad} outside their bounds")
    return out


def surface_audio(dev="cuda", audio=AUDIO):
    """(18d) Whisper's log-mel front end: ``audio`` = (clips, samples, n_fft,
    hop) of synthetic audio from a seed through ``signal.stft`` (Hann
    window) and back through ``istft``, ``fft.rfft``/``irfft`` and
    ``fft2``/``ifft2`` on the same data, each against the CPU."""
    from paddle_tpu_torch import fft, signal

    t0 = time.monotonic()
    clips, n, n_fft, hop = audio
    g = torch.Generator().manual_seed(0)
    tt = torch.arange(n) / 16000.0
    f0 = 100 + 900 * torch.rand(clips, 1, generator=g)
    x = (0.5 * torch.sin(2 * np.pi * f0 * tt)
         + 0.1 * torch.randn(clips, n, generator=g)).float()
    win = torch.hann_window(n_fft, periodic=True)
    xd, wd = x.to(dev), win.to(dev)
    spec = signal.stft(xd, n_fft, hop_length=hop, window=wd)
    back = signal.istft(spec, n_fft, hop_length=hop, window=wd, length=n)
    spec_cpu = signal.stft(x, n_fft, hop_length=hop, window=win)
    r = fft.irfft(fft.rfft(xd), n=n)
    frames = xd[:, : (n // hop) * hop].reshape(clips, -1, hop)
    f2 = fft.ifft2(fft.fft2(frames)).real
    out = {"shape": list(spec.shape), "round_trip": _rel(back, x),
           "stft_vs_cpu": _rel(torch.view_as_real(spec),
                               torch.view_as_real(spec_cpu)),
           "rfft_vs_cpu": _rel(torch.view_as_real(fft.rfft(xd)),
                               torch.view_as_real(fft.rfft(x))),
           "rfft_round_trip": _rel(r, x),
           "fft2_round_trip": _rel(f2, frames),
           "fft2_vs_cpu": _rel(torch.view_as_real(fft.fft2(frames)),
                               torch.view_as_real(fft.fft2(frames.cpu())))}
    out["seconds"] = time.monotonic() - t0
    print(f"  (18d) stft {tuple(spec.shape)} {spec.dtype}: round trip "
          f"{out['round_trip']:.2e}, against the CPU {out['stft_vs_cpu']:.2e}"
          f"; rfft {out['rfft_round_trip']:.2e} / {out['rfft_vs_cpu']:.2e}; "
          f"fft2 {out['fft2_round_trip']:.2e} / {out['fft2_vs_cpu']:.2e} "
          f"({out['seconds']:.1f} s)")
    bad = [k for k in out if k.endswith(("round_trip", "vs_cpu"))
           and not out[k] <= ROUND_TRIP_REL]
    if bad:
        fail(f"18d: {bad} above {ROUND_TRIP_REL}")
    return out


def surface_outputs(model, dev="cuda", B=2, T=2048, greedy=SURFACE_GREEDY):
    """(18e) the model's outputs through the surface: its logits (f32) into
    ``distribution.Categorical`` (entropy, log_prob, samples from an
    explicit CUDA generator held by their frequencies and their mean
    log-probability), ragged lengths over its hidden states into
    ``logsumexp``, ``sequence_softmax`` and ``sequence_pool``, the argmax
    against the shifted tokens into ``precision_recall``, ``mean_iou`` and
    ``auc``, two greedy continuations into ``edit_distance``, and a greedy
    ``while_loop``; each held against the port's CPU run of the same
    function on the same tensors (the loop against a plain loop)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distribution
    from paddle_tpu_torch.ops import control_flow, metrics_ops, sequence

    t0 = time.monotonic()
    V = model.config.vocab_size
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, V, (B, T))).to(dev)
    with torch.no_grad():
        logits = model(ids).float().reshape(B * T, V)
        hidden = model.gpt(ids).float()
    errs = {}

    def held(name, fn, *args, tol=1e-4):
        got = fn(*args)
        want = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args])
        got, want = (list(got), list(want)) if isinstance(got, tuple) \
            else ([got], [want])
        errs[name] = max(_rel(g, w) for g, w in zip(got, want))
        if not errs[name] <= tol:
            fail(f"18e: {name} {errs[name]:.2e} from the CPU (> {tol})")

    cat = lambda lg: distribution.Categorical(lg)  # noqa: E731
    held("entropy", lambda lg: cat(lg).entropy(), logits)
    pred = torch.argmax(logits, -1)
    held("log_prob", lambda lg, v: cat(lg).log_prob(v), logits, pred)
    rows = logits[:8]
    gen = torch.Generator(dev).manual_seed(0)
    draws = cat(rows).sample([4000], generator=gen)  # (4000, 8)
    p = torch.softmax(rows.double(), -1)
    freq = torch.stack([torch.bincount(draws[:, r], minlength=V) / 4000.0
                        for r in range(8)])
    lp = torch.log(p).gather(1, draws.T).mean(1)
    ent = -(p * torch.log(p)).sum(1)
    sd = (torch.log(p) ** 2 * p).sum(1).sub(ent ** 2).clamp_min(0).sqrt()
    errs["sample_freq"] = float((freq - p).abs().max())
    errs["sample_logp_z"] = float(((lp + ent) / (sd / 4000 ** 0.5)).abs()
                                  .max())
    if errs["sample_freq"] > 5 * (0.25 / 4000) ** 0.5 or \
            errs["sample_logp_z"] > 5:
        fail(f"18e: samples off their distribution ({errs})")
    held("logsumexp", lambda h: paddle.logsumexp(h, axis=-1),
         hidden.reshape(B * T, -1))
    rows_h = hidden.reshape(16, (B * T) // 16, -1)
    lens = torch.from_numpy(rng.randint(0, rows_h.shape[1] + 1, 16)).to(dev)
    held("sequence_softmax", sequence.sequence_softmax, rows_h, lens)
    held("sequence_pool", lambda h, n: sequence.sequence_pool(h, n,
                                                               "AVERAGE"),
         rows_h, lens)
    held("sequence_pool_max", lambda h, n: sequence.sequence_pool(h, n,
                                                                   "MAX"),
         rows_h, lens)
    labels = ids.reshape(-1).roll(-1)
    held("precision_recall", lambda a, b: metrics_ops.precision_recall(
        a, b, V), pred, labels)
    held("mean_iou", lambda a, b: metrics_ops.mean_iou(a, b, V), pred,
         labels)
    score = torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]
    held("auc", metrics_ops.auc, score, (labels < V // 2).long())
    new, steps = greedy
    prompts = ids[:, :128]
    cont = model.generate(prompts, max_new_tokens=new, do_sample=False)[
        :, 128:]
    n = torch.full((1,), new, dtype=torch.int64, device=dev)
    held("edit_distance", lambda a, b, m: metrics_ops.edit_distance(
        a, m, b, m, normalized=False), cont[:1], cont[1:], n, tol=0.0)

    def step(toks):
        with torch.no_grad():
            nxt = torch.argmax(model(toks)[:, -1], -1)
        return torch.cat([toks, nxt[:, None]], 1)

    _, looped = control_flow.while_loop(
        lambda i, t: i < steps, lambda i, t: [i + 1, step(t)],
        [torch.zeros((), dtype=torch.int64, device=dev), prompts])
    plain = prompts
    for _ in range(steps):
        plain = step(plain)
    errs["while_loop"] = float((looped != plain).sum())
    if errs["while_loop"]:
        fail("18e: the while_loop's tokens differ from a plain loop's")
    out = {"logits": [B * T, V], "errors": errs,
           "edit_distance": float(metrics_ops.edit_distance(
               cont[:1], n, cont[1:], n, normalized=False)[0]),
           "entropy_mean": float(cat(logits).entropy().mean()),
           "seconds": time.monotonic() - t0}
    print(f"  (18e) logits {B * T} x {V}: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items())
        + f"; edit distance {out['edit_distance']:.0f} of {new} "
        f"({out['seconds']:.1f} s)")
    return out


def surface_sparse(model, dev="cuda", T=4096):
    """(18f) layer 0's FFN up-projection (H x 4H, f32) pruned to its top
    ``SPARSE_KEEP`` by magnitude, as COO and CSR: ``sparse.matmul`` against
    the dense product with T activation rows, ``masked_matmul`` under a
    causal mask, and ``add``, ``multiply``, ``softmax`` and the unary ops
    against their dense forms."""
    from paddle_tpu_torch import sparse

    t0 = time.monotonic()
    w = model.gpt.layers[0].mlp.up.weight.detach().float().to(dev)
    k = int(w.numel() * SPARSE_KEEP)
    thr = w.abs().flatten().kthvalue(w.numel() - k).values
    wp = torch.where(w.abs() > thr, w, torch.zeros_like(w))
    g = torch.Generator(dev).manual_seed(0)
    act = torch.randn(T, w.shape[0], generator=g, device=dev)
    errs = {}
    dense = act @ wp
    for fmt in ("coo", "csr"):
        sp = getattr(sparse, f"to_sparse_{fmt}")(wp.T.contiguous())
        errs[f"matmul_{fmt}"] = _rel(sparse.matmul(sp, act.T).T, dense)
    h = w.shape[0]
    x, y = act[:h], act[h:2 * h].T.contiguous()
    mask = torch.tril(torch.ones(h, h, device=dev))
    mm = sparse.masked_matmul(x, y, sparse.to_sparse_coo(mask))
    errs["masked_matmul"] = _rel(mm.to_dense(), (x @ y) * mask)
    coo, csr = sparse.to_sparse_coo(wp), sparse.to_sparse_csr(wp)
    errs["add"] = _rel(sparse.add(coo, csr).to_dense(), 2 * wp)
    errs["multiply"] = _rel(sparse.multiply(csr, w).to_dense(), wp * w)
    on = wp != 0
    for name, fn in (("relu", torch.relu), ("sin", torch.sin),
                     ("tanh", torch.tanh), ("abs", torch.abs),
                     ("neg", torch.neg)):
        errs[name] = _rel(getattr(sparse, name)(coo).to_dense(), fn(wp))
    errs["pow"] = _rel(sparse.pow(coo, 2.0).to_dense(), wp ** 2)
    errs["sqrt"] = _rel(sparse.sqrt(sparse.abs(coo)).to_dense(),
                        wp.abs().sqrt())
    sm = torch.softmax(torch.where(on, wp, -torch.inf), -1).nan_to_num(0.0)
    errs["softmax"] = _rel(sparse.softmax(coo).to_dense(), sm)
    out = {"shape": list(w.shape), "nnz": coo.nnz(), "errors": errs,
           "seconds": time.monotonic() - t0}
    print(f"  (18f) {tuple(w.shape)} at {SPARSE_KEEP:.0%} ({coo.nnz()} nnz): "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
          + f" ({out['seconds']:.1f} s)")
    bad = [k for k, v in errs.items() if not v <= 1e-5]
    if bad:
        fail(f"18f: {bad} above 1e-5 from their dense forms")
    return out


def op_surface_phase(card):
    """Phase 18: 18a-f; the results go on the ``op_surface`` line."""
    import gc

    t0 = time.monotonic()
    OP_SURFACE["card"] = card
    OP_SURFACE["18a"] = surface_sweep()
    OP_SURFACE["18b"] = op_table()
    model = surface_model()
    OP_SURFACE["18c"] = surface_linalg(model)
    OP_SURFACE["18d"] = surface_audio()
    OP_SURFACE["18e"] = surface_outputs(model)
    OP_SURFACE["18f"] = surface_sparse(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    OP_SURFACE["seconds"] = time.monotonic() - t0
    print(f"  (18) {OP_SURFACE['seconds']:.1f} s")


# -- phase 19: the nn layer library ---------------------------------------------
NN = {}  # phase 19's results: the {"nn": ...} line
# 19a: the Transformer base (Vaswani et al. 2017, Table 3, "base"), which is
# nn.Transformer's defaults, on the paper's shared 37000-token vocabulary
NN_TRANSFORMER = {"vocab": 37000, "d": 512, "heads": 8, "layers": 6,
                  "ffn": 2048, "dropout": 0.1, "batch": 32, "seq": 128,
                  "steps": 10, "warmup": 2, "parity_rows": 4,
                  "decode": (8, 32)}
# 19b: ResNet-50's stem and conv2_x (He et al. 2016, Table 1) at ImageNet size
NN_RESNET = {"batch": 32, "size": 224, "classes": 1000, "timed": 5,
             "warmup": 2, "parity_rows": 4}
# 19c: the medium PTB LSTM (Zaremba et al. 2014): 2 x 650, 35 steps, batch 20
NN_PTB = {"vocab": 10000, "hidden": 650, "layers": 2, "steps": 35,
          "batch": 20, "dropout": 0.5, "timed": 4}
NN_LOSS_REL = 1e-5  # a loss against the CPU
NN_GRAD_REL = 1e-4  # every gradient together, by relative norm
# 19b's gradients, card against CPU: a pre-activation within a float32
# rounding of 0 takes the other ReLU branch in another summation order, and
# in a train-mode BatchNorm network that moves the channel's, and every
# earlier layer's, gradients. Measured (NVIDIA H100 80GB HBM3, 700 W): 14
# branches flipped against a float64 run, the card 9.7e-5 and the CPU
# 1.5e-4 from float64, the two 1.3e-4 apart; on float64's branches 4.0e-7
# apart, held at NN_GRAD_REL (``_arbitrated_parity``)
NN_BN_GRAD_REL = 1e-3
NN_OUT_REL = 1e-4   # outputs, states and buffers against the CPU
NN_OP_REL = 1e-5    # 19d's ops against the CPU


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _worst_grad(a, b):
    """The parameter whose gradient differs most between two copies of a
    model, by relative norm: (name, error)."""
    pb = dict(b.named_parameters())
    return max(((n, _rel(p.grad, pb[n].grad)) for n, p in a.named_parameters()
                if p.grad is not None), key=lambda t: t[1])


def _grad_vec(model):
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .detach().double().cpu().reshape(-1)
                      for p in model.parameters()])


def _cpu_copy(model):
    import copy

    return copy.deepcopy(model).to("cpu")


def nn_seq2seq(cfg, dev, seed=0):
    """The Transformer base as a translation model: one embedding table
    shared by source, target and the output projection (scaled by
    sqrt(d)), sinusoidal positions and dropout on the embedded sums; the
    body is ``nn.Transformer``."""
    import math

    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    V, d = cfg["vocab"], cfg["d"]

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            g = torch.Generator(dev).manual_seed(seed)
            kw = {"device": dev, "generator": g}
            self.emb = nn.Embedding(V, d, **kw)
            self.body = nn.Transformer(d, cfg["heads"], cfg["layers"],
                                       cfg["layers"], cfg["ffn"],
                                       dropout=cfg["dropout"], **kw)
            self.drop = nn.Dropout(cfg["dropout"])
            pos = torch.arange(cfg["seq"] + 64, dtype=torch.float64)[:, None]
            div = torch.pow(10000.0, torch.arange(0, d, 2,
                                                  dtype=torch.float64) / d)
            pe = torch.zeros(len(pos), d, dtype=torch.float64)
            pe[:, 0::2], pe[:, 1::2] = torch.sin(pos / div), torch.cos(
                pos / div)
            self.register_buffer("pe", pe.float().to(dev), persistable=False)

        def embed(self, ids, start=0):
            x = self.emb(ids) * math.sqrt(d) + \
                self.pe[start: start + ids.shape[1]]
            return self.drop(x)

        def logits(self, h):
            return F.linear(h, self.emb.weight.T)

        def forward(self, src, tgt):
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1]).to(src.device)
            return self.logits(self.body(self.embed(src), self.embed(tgt),
                                         tgt_mask=mask))

        def loss(self, src, tgt_in, tgt_out):
            soft = F.label_smooth(F.one_hot(tgt_out, V), epsilon=0.1)
            return F.cross_entropy(self(src, tgt_in), soft, soft_label=True)

    return Seq2Seq()


def nn_transformer_phase(cfg=NN_TRANSFORMER, dev="cuda"):
    """(19a) the Transformer base: its step 1 on ``parity_rows`` pairs with
    dropout off against the CPU (loss, every gradient), ``steps`` Adam
    steps (0.9, 0.98, 1e-9) under NoamDecay(d, 4000) on one batch of
    synthetic pairs with dropout on (the loss must be finite and fall),
    then greedy incremental decoding through ``gen_cache`` (``Cache`` for
    self-attention, ``StaticCache`` for cross-attention) against full
    recomputation under the causal mask at every step. Returns the
    results and the encoder's memory of the batch."""
    from paddle_tpu_torch import optimizer

    t0 = time.monotonic()
    V, B, T = cfg["vocab"], cfg["batch"], cfg["seq"]
    g = torch.Generator().manual_seed(1)
    src = torch.randint(1, V, (B, T), generator=g).to(dev)
    tgt = torch.randint(1, V, (B, T + 1), generator=g).to(dev)
    tgt[:, 0] = 0  # the start token
    batch = (src, tgt[:, :-1], tgt[:, 1:])
    model = nn_seq2seq(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    # parity: step 1 on the first rows, dropout off, card against CPU
    model.eval()
    rows = tuple(t[: cfg["parity_rows"]] for t in batch)
    card_loss = model.loss(*rows)
    card_loss.backward()
    cpu = _cpu_copy(model)
    cpu_loss = cpu.loss(*(t.cpu() for t in rows))
    cpu_loss.backward()
    parity = {"loss": _rel(card_loss, cpu_loss),
              "grads": _rel(_grad_vec(model), _grad_vec(cpu))}
    del cpu
    model.clear_gradients()
    model.train()
    sched = optimizer.lr.NoamDecay(cfg["d"], 4000)
    opt = optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                         epsilon=1e-9, parameters=model.parameters())
    losses = []
    for step in range(cfg["steps"]):
        if step == cfg["warmup"]:
            _sync(dev)
            t_start = time.perf_counter()
        loss = model.loss(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss.detach())
    _sync(dev)
    timed = cfg["steps"] - cfg["warmup"]
    step_ms = (time.perf_counter() - t_start) * 1e3 / timed
    losses = [float(v) for v in losses]
    # incremental decoding against full recomputation
    model.eval()
    n_src, n_new = cfg["decode"]
    with torch.no_grad():
        memory = model.body.encoder(model.embed(src))
        mem = memory[:n_src]
        cache = model.body.decoder.gen_cache(mem)
        toks = torch.zeros(n_src, 1, dtype=torch.long, device=dev)
        logit_err, equal = 0.0, 0
        t_inc = t_full = 0.0
        from paddle_tpu_torch import nn

        for t in range(n_new):
            a = time.perf_counter()
            h, cache = model.body.decoder(model.embed(toks[:, -1:], start=t),
                                          mem, cache=cache)
            inc = model.logits(h[:, -1])
            inc_tok = inc.argmax(-1)
            b = time.perf_counter()
            mask = nn.Transformer.generate_square_subsequent_mask(
                t + 1).to(dev)
            full = model.logits(model.body.decoder(model.embed(toks), mem,
                                                   tgt_mask=mask)[:, -1])
            full_tok = full.argmax(-1)
            equal += int((inc_tok == full_tok).sum())
            c = time.perf_counter()
            t_inc, t_full = t_inc + b - a, t_full + c - b
            logit_err = max(logit_err, float((inc - full).abs().max()
                                             / full.abs().max()))
            toks = torch.cat([toks, full_tok[:, None]], 1)
    out = {"params": n_params, "tokens_a_side": B * T,
           "parity_rows": cfg["parity_rows"], "parity": parity,
           "losses": losses, "step_ms": step_ms,
           "tokens_per_s": 2 * B * T / (step_ms / 1e3),
           "decode": {"sources": n_src, "new": n_new,
                      "tokens_equal": equal, "tokens": n_src * n_new,
                      "logits_rel": logit_err,
                      "incremental_ms_a_token": t_inc * 1e3 / n_new,
                      "full_ms_a_token": t_full * 1e3 / n_new},
           "seconds": time.monotonic() - t0}
    print(f"  (19a) Transformer base ({n_params / 1e6:.1f}M parameters), "
          f"b{B} x s{T}: step 1 against the CPU on {cfg['parity_rows']} "
          f"pairs: loss {parity['loss']:.1e}, gradients {parity['grads']:.1e}"
          f"; losses {losses[0]:.4f} -> {losses[-1]:.4f}; {step_ms:.2f} ms a "
          f"step, {out['tokens_per_s']:.0f} tokens/s (source + target); "
          f"decode {equal}/{n_src * n_new} tokens equal, logits "
          f"{logit_err:.1e} ({out['seconds']:.1f} s)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"19a: the losses {losses} are not finite and falling")
    if parity["loss"] > NN_LOSS_REL or parity["grads"] > NN_GRAD_REL:
        fail(f"19a: step 1 differs from the CPU's: {parity}")
    if equal != n_src * n_new or logit_err > NN_OUT_REL:
        fail(f"19a: incremental decoding differs from full recomputation "
             f"({equal} of {n_src * n_new} tokens, logits {logit_err:.1e})")
    return out, memory


def nn_resnet(fmt, dev, cfg=NN_RESNET, seed=0):
    """ResNet-50's stem and conv2_x: 7x7/2 Conv2D 64, BatchNorm2D, ReLU,
    3x3/2 MaxPool2D, three bottlenecks 64-64-256 (the first with the
    projection shortcut), then AdaptiveAvgPool2D(1) and a Linear head."""
    from paddle_tpu_torch import nn

    g = torch.Generator(dev).manual_seed(seed)
    kw = {"device": dev, "generator": g}

    def conv(ci, co, k, s=1, p=0):
        return nn.Conv2D(ci, co, k, stride=s, padding=p, bias_attr=False,
                         data_format=fmt, **kw)

    def bn(c):
        return nn.BatchNorm2D(c, data_format=fmt, **kw)

    class Bottleneck(nn.Layer):
        def __init__(self, cin, width, proj):
            super().__init__()
            self.conv1, self.bn1 = conv(cin, width, 1), bn(width)
            self.conv2, self.bn2 = conv(width, width, 3, 1, 1), bn(width)
            self.conv3, self.bn3 = conv(width, width * 4, 1), bn(width * 4)
            self.relu = nn.ReLU()
            self.downsample = nn.Sequential(conv(cin, width * 4, 1),
                                            bn(width * 4)) if proj else None

        def forward(self, x):
            out = self.relu(self.bn1(self.conv1(x)))
            out = self.relu(self.bn2(self.conv2(out)))
            out = self.bn3(self.conv3(out))
            idn = x if self.downsample is None else self.downsample(x)
            return self.relu(out + idn)

    class Stage1(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv1, self.bn1 = conv(3, 64, 7, 2, 3), bn(64)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2D(3, 2, 1, data_format=fmt)
            self.layer1 = nn.Sequential(Bottleneck(64, 64, True),
                                        Bottleneck(256, 64, False),
                                        Bottleneck(256, 64, False))
            self.avgpool = nn.AdaptiveAvgPool2D(1, data_format=fmt)
            self.flatten = nn.Flatten()
            self.fc = nn.Linear(256, cfg["classes"], **kw)

        def features(self, x):
            return self.layer1(self.maxpool(self.relu(self.bn1(
                self.conv1(x)))))

        def forward(self, x):
            return self.fc(self.flatten(self.avgpool(self.features(x))))

    return Stage1()


def _resnet_step(net, x, y, lr=0.1):
    """One train-mode step with Momentum(lr, 0.9, weight decay 1e-4):
    (logits, loss); the gradients stay on the parameters."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.nn import functional as F

    opt = optimizer.Momentum(lr, momentum=0.9, weight_decay=1e-4,
                             parameters=net.parameters())
    logits = net(x)
    loss = F.cross_entropy(logits, y)
    loss.backward()
    grads = _grad_vec(net)
    opt.step()
    return logits.detach(), loss.detach(), grads, opt


def nn_resnet_phase(cfg=NN_RESNET, dev="cuda"):
    """(19b) the stage at ImageNet size, f32: the NHWC network built from
    the same weights agrees with NCHW (train-mode logits, loss and
    gradients); one Momentum step, whose first BatchNorm's buffers must
    move by Paddle's rule (``running * 0.9 + batch * 0.1``, the unbiased
    variance); eval on the running statistics; the same step on the first
    ``parity_rows`` images against the CPU (outputs, gradients, every
    BatchNorm buffer after the step); then ms a step and images/s. Returns
    the results and the stage's activations of the batch (eval)."""
    t0 = time.monotonic()
    B, S = cfg["batch"], cfg["size"]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, 3, S, S, generator=g).to(dev)
    y = torch.randint(0, cfg["classes"], (B,), generator=g).to(dev)
    net = nn_resnet("NCHW", dev)
    nhwc = nn_resnet("NHWC", dev, seed=1)
    nhwc.set_state_dict(net.state_dict())
    init = _cpu_copy(net)
    with torch.no_grad():
        stem = net.conv1(x)
        mean = stem.mean((0, 2, 3))
        var = stem.var((0, 2, 3), unbiased=True)
    lg_h, loss_h, grads_h, _ = _resnet_step(
        nhwc, x.permute(0, 2, 3, 1).contiguous(), y)
    logits, loss, grads, opt = _resnet_step(net, x, y)
    layout = {"logits": _rel(lg_h, logits), "loss": _rel(loss_h, loss),
              "grads": _rel(grads_h, grads)}
    worst_layout = _worst_grad(nhwc, net)
    momentum = {"mean": _rel(net.bn1._mean, 0.1 * mean),
                "variance": _rel(net.bn1._variance, 0.9 + 0.1 * var)}
    net.eval()
    with torch.no_grad():
        eval_logits = net(x)
        act = net.features(x)
    finite = bool(torch.isfinite(eval_logits).all())
    # the same step on the first rows, card against CPU (C1's arbiter)
    n = cfg["parity_rows"]
    parity = _arbitrated_parity(init, x[:n], y[:n], dev)
    del init, nhwc
    # throughput: train-mode steps on the batch
    net.train()
    from paddle_tpu_torch.nn import functional as F

    for step in range(cfg["warmup"] + cfg["timed"]):
        if step == cfg["warmup"]:
            _sync(dev)
            t_start = time.perf_counter()
        F.cross_entropy(net(x), y).backward()
        opt.step()
        opt.clear_grad()
    _sync(dev)
    step_ms = (time.perf_counter() - t_start) * 1e3 / cfg["timed"]
    out = {"batch": B, "size": S, "loss": float(loss), "nhwc": layout,
           "nhwc_worst_grad": worst_layout,
           "momentum_rule": momentum, "eval_finite": finite,
           "parity_rows": n, "parity": parity, "step_ms": step_ms,
           "images_per_s": B / (step_ms / 1e3),
           "seconds": time.monotonic() - t0}
    print(f"  (19b) ResNet-50 stem + conv2_x, b{B} x {S}²: NHWC against "
          f"NCHW logits {layout['logits']:.1e}, gradients "
          f"{layout['grads']:.1e}; bn1 against Paddle's momentum rule "
          f"{momentum['mean']:.1e} / {momentum['variance']:.1e}; the CPU on "
          f"{n} images: logits {parity['logits']:.1e}, gradients "
          f"{parity['grads']:.1e} (worst {parity['worst_grad'][0]} "
          f"{parity['worst_grad'][1]:.1e}), {parity['buffers_held']} buffers "
          f"{parity['buffers']:.1e}; from float64: the card "
          f"{parity['arbiter']['card_f64']:.1e}, the CPU "
          f"{parity['arbiter']['cpu_f64']:.1e}, {parity['branch_flips']} "
          f"branches (ReLU, max pool) flipped; on float64's the CPU "
          f"{parity['grads_replayed']:.1e}; {step_ms:.2f} ms a step, "
          f"{out['images_per_s']:.0f} images/s ({out['seconds']:.1f} s)")
    tol = {"grads": NN_BN_GRAD_REL}
    bad = [f"nhwc {k}" for k, v in layout.items()
           if not v <= tol.get(k, NN_OUT_REL)] + \
        [f"momentum {k}" for k, v in momentum.items()
         if not v <= NN_OUT_REL] + \
        [f"cpu {k}" for k in ("logits", "loss", "grads", "buffers")
         if not parity[k] <= tol.get(k, NN_OUT_REL)] + \
        (["cpu grads on float64's branches"]
         if not parity["grads_replayed"] <= NN_GRAD_REL else [])
    if bad or not finite:
        fail(f"19b: {bad} outside their bounds (outputs {NN_OUT_REL}, "
             f"gradients {NN_BN_GRAD_REL}; finite eval: {finite})")
    return out, act


def nn_ptb(kind, cfg, dev, seed=0):
    """The PTB language model: embedding, dropout, the recurrent body
    (``nn.LSTM``/``nn.GRU`` of ``layers``, or one ``BiRNN`` of two
    ``LSTMCell``), dropout, the head."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    V, H = cfg["vocab"], cfg["hidden"]
    g = torch.Generator(dev).manual_seed(seed)
    kw = {"device": dev, "generator": g}

    class PTBModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(V, H, **kw)
            self.drop_in = nn.Dropout(cfg["dropout"])
            self.drop_out = nn.Dropout(cfg["dropout"])
            if kind == "lstm":
                self.rnn = nn.LSTM(H, H, cfg["layers"], **kw)
            elif kind == "gru":
                self.rnn = nn.GRU(H, H, cfg["layers"], **kw)
            else:
                self.rnn = nn.BiRNN(nn.LSTMCell(H, H, **kw),
                                    nn.LSTMCell(H, H, **kw))
            self.head = nn.Linear(H * (2 if kind == "birnn" else 1), V, **kw)

        def forward(self, ids, states=None):
            y, states = self.rnn(self.drop_in(self.emb(ids)), states)
            return self.head(self.drop_out(y)), states

        def loss(self, ids, labels, states=None):
            logits, states = self(ids, states)
            return F.cross_entropy(logits.reshape(-1, V),
                                   labels.reshape(-1)), states, logits

    return PTBModel()


def _detach(states):
    if isinstance(states, (tuple, list)):
        return type(states)(_detach(s) for s in states)
    return states.detach()


def _flat(states):
    if isinstance(states, (tuple, list)):
        return [t for s in states for t in _flat(s)]
    return [states]


def _ptb_run(model, data, cfg):
    """Two truncated-BPTT batches, the final states carried and detached,
    ``SGD(1.0)`` with ``ClipGradByGlobalNorm(5.0)``: the losses, each
    batch's gradients and the final states."""
    from paddle_tpu_torch import nn, optimizer

    opt = optimizer.SGD(1.0, parameters=model.parameters(),
                        grad_clip=nn.ClipGradByGlobalNorm(5.0))
    T, states, losses, grads = cfg["steps"], None, [], []
    for k in range(2):
        ids = data[:, k * T: (k + 1) * T]
        labels = data[:, k * T + 1: (k + 1) * T + 1]
        loss, states, _ = model.loss(ids, labels, states)
        loss.backward()
        grads.append(_grad_vec(model))
        opt.step()
        opt.clear_grad()
        states = _detach(states)
        losses.append(loss.detach())
    return losses, grads, _flat(states), opt


def nn_ptb_phase(cfg=NN_PTB, dev="cuda"):
    """(19c) the medium PTB LSTM, then ``nn.GRU`` at the same width and one
    ``BiRNN(LSTMCell, LSTMCell)`` layer: two truncated-BPTT batches with
    dropout off against the CPU (losses, gradients, final states), then
    ms a train step with dropout on. Returns the results and the LSTM's
    logits of the first batch (eval)."""
    t0 = time.monotonic()
    B, T, V = cfg["batch"], cfg["steps"], cfg["vocab"]
    g = torch.Generator().manual_seed(3)
    data = torch.randint(0, V, (B, 2 * T + 1), generator=g).to(dev)
    out, logits = {}, None
    for kind in ("lstm", "gru", "birnn"):
        model = nn_ptb(kind, cfg, dev)
        cpu = _cpu_copy(model)
        model.eval()
        cpu.eval()
        c_l, c_g, c_s, _ = _ptb_run(model, data, cfg)
        p_l, p_g, p_s, _ = _ptb_run(cpu, data.cpu(), cfg)
        parity = {"losses": max(_rel(a, b) for a, b in zip(c_l, p_l)),
                  "grads": max(_rel(a, b) for a, b in zip(c_g, p_g)),
                  "states": max(_rel(a, b) for a, b in zip(c_s, p_s))}
        del cpu
        model.train()
        from paddle_tpu_torch import nn, optimizer

        opt = optimizer.SGD(1.0, parameters=model.parameters(),
                            grad_clip=nn.ClipGradByGlobalNorm(5.0))
        states = None
        for step in range(1 + cfg["timed"]):
            if step == 1:
                _sync(dev)
                t_start = time.perf_counter()
            k = step % 2
            loss, states, _ = model.loss(
                data[:, k * T: (k + 1) * T],
                data[:, k * T + 1: (k + 1) * T + 1], states)
            loss.backward()
            opt.step()
            opt.clear_grad()
            states = _detach(states)
        _sync(dev)
        step_ms = (time.perf_counter() - t_start) * 1e3 / cfg["timed"]
        out[kind] = {"losses": [float(v) for v in c_l], "parity": parity,
                     "step_ms": step_ms,
                     "params": sum(p.numel() for p in model.parameters())}
        print(f"  (19c) {kind} ({out[kind]['params'] / 1e6:.1f}M parameters)"
              f", b{B} x {T} steps: the CPU's losses {parity['losses']:.1e},"
              f" gradients {parity['grads']:.1e}, states "
              f"{parity['states']:.1e}; {step_ms:.2f} ms a step")
        bad = [k for k, v in parity.items() if not v <= NN_OUT_REL]
        if bad or not all(np.isfinite(out[kind]["losses"])):
            fail(f"19c {kind}: {bad} outside {NN_OUT_REL}: {parity}")
        if kind == "lstm":
            model.eval()
            with torch.no_grad():
                logits = model(data[:, :T])[0]
    out["seconds"] = time.monotonic() - t0
    return out, logits


def _banded_csr(B, H, T, w, dev):
    """Per (batch, head), each row attends to itself and the ``w`` rows
    before it, as CSR offsets (B, H, T + 1) and columns (B, H, nnz)."""
    cols, offs = [], [0]
    for r in range(T):
        cols += range(max(0, r - w), r + 1)
        offs.append(len(cols))
    off = torch.tensor(offs, device=dev).expand(B, H, T + 1).contiguous()
    col = torch.tensor(cols, device=dev).expand(B, H, len(cols)).contiguous()
    return off, col


def nn_rest_phase(act, lm_logits, memory, dev="cuda"):
    """(19d) the rest of the layer library at those widths, each on the
    card over the whole batch and held against the port's CPU run on its
    first rows (every op here is per sample): on 19b's stage activations
    GroupNorm(32), InstanceNorm2D, LocalResponseNorm, Conv2DTranspose 2x,
    ``interpolate`` in every 2-D mode down and up, PixelShuffle and
    PixelUnshuffle, ``grid_sample`` under an ``affine_grid``,
    ``Unfold``/``Fold``, ``max_pool2d(return_mask)`` then
    ``max_unpool2d``; ``ctc_loss`` (and its gradient) on 19c's logits
    against synthetic label lengths; ``sparse_attention`` under a banded
    CSR pattern on 19a's memory."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    t0 = time.monotonic()
    n = 4
    N, C, H, W = act.shape
    g = torch.Generator(dev).manual_seed(4)
    kw = {"device": dev, "generator": g}
    layers = {"group_norm": nn.GroupNorm(32, C, **kw),
              "instance_norm": nn.InstanceNorm2D(C, **kw),
              "local_response_norm": nn.LocalResponseNorm(5),
              "conv2d_transpose": nn.Conv2DTranspose(C, 64, 2, stride=2,
                                                     **kw),
              "pixel_shuffle": nn.PixelShuffle(2),
              "pixel_unshuffle": nn.PixelUnshuffle(2),
              "unfold_fold": nn.Sequential(
                  nn.Unfold(3, paddings=1),
                  nn.Fold([H, W], 3, paddings=1))}
    ang = torch.rand(N, generator=torch.Generator().manual_seed(5)) - 0.5
    theta = torch.stack([torch.stack([ang.cos() * 1.1, -ang.sin(),
                                      ang * 0.2], 1),
                         torch.stack([ang.sin(), ang.cos() * 0.9,
                                      -ang * 0.1], 1)], 1).to(dev)
    fns = {"grid_sample": lambda x, th: F.grid_sample(
               x, F.affine_grid(th, list(x.shape))),
           "max_unpool2d": lambda x: F.max_unpool2d(
               *F.max_pool2d(x, 2, 2, return_mask=True), 2, 2)}
    for mode in ("nearest", "bilinear", "bicubic", "area"):
        for name, size in (("down", [H // 2, W // 2]),
                           ("up", [H * 2, W * 2])):
            fns[f"interpolate_{mode}_{name}"] = (
                lambda x, m=mode, s=size: F.interpolate(x, s, mode=m))
    errs, times = {}, {}
    with torch.no_grad():
        for name, layer in layers.items():
            a = time.perf_counter()
            got = layer(act)
            _sync(dev)
            times[name] = (time.perf_counter() - a) * 1e3
            errs[name] = _rel(got[:n], _cpu_copy(layer)(act[:n].cpu()))
        for name, fn in fns.items():
            args = (act, theta) if name == "grid_sample" else (act,)
            a = time.perf_counter()
            got = fn(*args)
            _sync(dev)
            times[name] = (time.perf_counter() - a) * 1e3
            errs[name] = _rel(got[:n], fn(*[t[:n].cpu() for t in args]))
        qkv = memory.reshape(memory.shape[0], memory.shape[1], 8,
                             -1).transpose(1, 2).contiguous()
        off, cols = _banded_csr(qkv.shape[0], 8, qkv.shape[2], 16, dev)
        got = F.sparse_attention(qkv, qkv, qkv, off, cols)
        errs["sparse_attention"] = _rel(got[:n], F.sparse_attention(
            *(t[:n].cpu() for t in (qkv, qkv, qkv, off, cols))))
    # CTC on the LM's logits: (T, N, C) with synthetic label lengths
    gl = torch.Generator().manual_seed(6)
    Bc, Tc, Vc = lm_logits.shape
    S = Tc // 3
    labels = torch.randint(1, Vc, (Bc, S), generator=gl)
    lab_len = torch.randint(0, S + 1, (Bc,), generator=gl)
    in_len = torch.randint(2 * S + 1, Tc + 1, (Bc,), generator=gl)
    res = []
    for d in (dev, "cpu"):
        lg = lm_logits.transpose(0, 1).to(d).clone().requires_grad_(True)
        loss = F.ctc_loss(lg, labels.to(d), in_len.to(d), lab_len.to(d),
                          reduction="none")
        loss.sum().backward()
        res.append((loss.detach(), lg.grad))
    errs["ctc_loss"] = _rel(res[0][0], res[1][0])
    errs["ctc_loss_grad"] = _rel(res[0][1], res[1][1])
    out = {"activations": list(act.shape), "held_rows": n, "errors": errs,
           "card_ms": times, "seconds": time.monotonic() - t0}
    print(f"  (19d) on {tuple(act.shape)}, the CPU on {n} rows: " + ", ".join(
        f"{k} {v:.1e}" for k, v in errs.items())
        + f" ({out['seconds']:.1f} s)")
    bad = [k for k, v in errs.items() if not v <= NN_OP_REL]
    if bad:
        fail(f"19d: {bad} above {NN_OP_REL} from the CPU")
    return out


def nn_phase(card, dev="cuda", cfgs=None):
    """Phase 19: 19a-d; the results go on the ``nn`` line. ``cfgs``
    (transformer, resnet, ptb) cut the sizes for a rehearsal."""
    import gc

    t0 = time.monotonic()
    tr, rn, ptb = cfgs or (NN_TRANSFORMER, NN_RESNET, NN_PTB)
    if dev != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    NN["card"] = card
    NN["19a"], memory = nn_transformer_phase(tr, dev)
    NN["19b"], act = nn_resnet_phase(rn, dev)
    NN["19c"], lm_logits = nn_ptb_phase(ptb, dev)
    NN["19d"] = nn_rest_phase(act, lm_logits, memory, dev)
    del memory, act, lm_logits
    gc.collect()
    if dev != "cpu":
        NN["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        torch.cuda.empty_cache()
    NN["seconds"] = time.monotonic() - t0
    print(f"  (19) {NN['seconds']:.1f} s, peak "
          f"{NN.get('peak_gib', 0.0):.2f} GiB")


HV = {}  # phase 20's results: the {"hapi_vision": ...} line
# 20a: ResNet-50 (He et al. 2016, Table 1) at 19b's ImageNet batch, through
# Model.fit with Momentum(0.1, 0.9, L2 1e-4), CrossEntropyLoss and
# Accuracy(topk=(1, 5)); beside it the same network's hand-written loop
HV_RESNET = {"batch": 32, "size": 224, "classes": 1000, "warmup": 2,
             "timed": 8, "parity_rows": 4, "eval_images": 256}
# He et al. 2016, Table 1: ResNet-50's multiply-adds a 224² image
RESNET50_MULT_ADDS = 3.8e9
# 20d: YOLOv3-DarkNet53 at YOLOv3Postprocess's default 416², COCO's classes
HV_YOLO = {"batch": 8, "size": 416, "classes": 80, "boxes": 6, "timed": 3}
# 20e: detection-size ops (a Mask R-CNN FPN level at 800 x 1088, stride 4)
HV_OPS = {"rois": 512, "feat": (256, 200, 272), "scale": 0.25,
          "nms_boxes": 1000, "deform": (64, 128, 128)}
# 20e: the other 12 families, one step each at batch 8, at full width
HV_FAMILIES = {
    "lenet": ("LeNet", {}, (1, 28, 28)),
    "vgg": ("vgg11", {}, (3, 224, 224)),
    "alexnet": ("alexnet", {}, (3, 224, 224)),
    "mobilenetv1": ("mobilenet_v1", {}, (3, 224, 224)),
    "mobilenetv2": ("mobilenet_v2", {}, (3, 224, 224)),
    "squeezenet": ("squeezenet1_1", {}, (3, 224, 224)),
    "shufflenetv2": ("shufflenet_v2_x1_0", {}, (3, 224, 224)),
    "densenet": ("densenet121", {}, (3, 224, 224)),
    "googlenet": ("googlenet", {}, (3, 224, 224)),
    "inceptionv3": ("inception_v3", {}, (3, 299, 299)),
    "resnext": ("resnext50_32x4d", {}, (3, 224, 224)),
    "vit": ("vit_b_16", {}, (3, 224, 224)),
}
HV_FAMILY_BATCH = 8
HV_DET_SCORE = 1e-3  # 20d's detection scores against the CPU (decay-amplified)
HV_DET_ROWS = 0.95   # and the share of detection rows that must agree


class _ImageSet:
    """A synthetic in-memory image set (CHW in [0, 1), ImageNet's channel
    normalization applied by ``vision.transforms.Normalize`` a sample)."""

    def __init__(self, n, size, classes, seed=3):
        from paddle_tpu_torch.vision import transforms as T

        rng = np.random.default_rng(seed)
        self.x = rng.random((n, 3, size, size), dtype=np.float32)
        self.y = rng.integers(0, classes, n).astype(np.int64)
        self.norm = T.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.norm(self.x[i]), self.y[i]


class _Inputs:
    """A labelled set's inputs alone (``predict`` feeds every column)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return (self.ds[i][0],)


def _conv_linear_flops(net, shape, dev):
    """2 x multiply-adds of every convolution and linear layer of one
    forward at ``shape``, from their output shapes (hooks)."""
    from paddle_tpu_torch import nn

    total = []

    def conv(m, i, o):
        k = int(np.prod(m.weight.shape[2:]))
        total.append(2 * o.numel() * m.weight.shape[1] * k)

    def lin(m, i, o):
        total.append(2 * o.numel() * m.weight.shape[0])

    hooks = [m.register_forward_hook(conv if isinstance(m, nn.Conv2D)
                                     else lin)
             for m in net.modules() if isinstance(m, (nn.Conv2D, nn.Linear))]
    net.eval()
    with torch.no_grad():
        net(torch.zeros(shape, device=dev))
    for h in hooks:
        h.remove()
    return int(sum(total))


def _arbiter(card_g, cpu_g, f64_g, model):
    """C1's float64 arbiter: the card's and the CPU's float32 gradients
    each against the CPU's float64 ones (all together by relative norm, and
    the worst parameter of each)."""
    names = [n for n, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]

    def worst(g):
        out, at = ("", 0.0), 0
        for n, k in zip(names, sizes):
            e = _rel(g[at:at + k], f64_g[at:at + k])
            if e > out[1]:
                out = (n, e)
            at += k
        return out

    return {"card_f64": _rel(card_g, f64_g), "cpu_f64": _rel(cpu_g, f64_g),
            "card_f64_worst": worst(card_g), "cpu_f64_worst": worst(cpu_g)}


class _Branches:
    """Every ``F.relu``, ``F.relu6`` and ``F.leaky_relu`` call's branch (the
    layers call them) and every 2-D max pool's argmax, in call order:
    recorded in one run, then imposed on another, so two runs whose
    pre-activations straddle a kink, or whose window maxima tie, by a
    rounding take the same branches (and the same gradients' paths)."""

    def __init__(self):
        self.masks, self.mode, self.i = [], None, 0

    def __call__(self, mode):
        self.mode, self.i = mode, 0
        return self

    def _take(self, *conds):
        if self.mode == "record":
            self.masks.append([c.detach().cpu() for c in conds])
            return conds
        ms = self.masks[self.i]
        self.i += 1
        return [m.to(c.device) for m, c in zip(ms, conds)]

    def __enter__(self):
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.nn.functional import pooling as P

        self._saved = (F.relu, F.relu6, F.leaky_relu, P._MAX[2])
        max2d = P._MAX[2]

        def max_pool(v, kernel, stride, padding=0):
            # the window's argmax: recorded, or imposed by a gather
            if self.mode == "record":
                out, idx = max2d(v, kernel, stride, padding,
                                 return_indices=True)
                self.masks.append([idx.detach().cpu()])
                return out
            (idx,) = self.masks[self.i]
            self.i += 1
            idx = idx.to(v.device)
            return v.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        def relu(v, name=None):
            (pos,) = self._take(v > 0)
            return v * pos.to(v.dtype)

        def relu6(v, name=None):
            lo, hi = self._take(v > 0, v < 6)
            return torch.where(lo & hi, v, torch.where(lo, 6.0, 0.0).to(
                v.dtype))

        def leaky_relu(v, negative_slope=0.01, name=None):
            (pos,) = self._take(v >= 0)
            return torch.where(pos, v, negative_slope * v)

        F.relu, F.relu6, F.leaky_relu = relu, relu6, leaky_relu
        P._MAX[2] = max_pool
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.nn import functional as F
        from paddle_tpu_torch.nn.functional import pooling as P

        F.relu, F.relu6, F.leaky_relu, P._MAX[2] = self._saved
        return False

    def flips(self, other):
        """Branches taken differently than in ``other`` (a recording)."""
        return sum(int((a != b).sum()) for ma, mb in zip(self.masks,
                                                          other.masks)
                   for a, b in zip(ma, mb))


def _arbitrated_parity(init, x, y, dev):
    """One ``_resnet_step`` of copies of ``init`` on the card and on the
    CPU (float32) against each other (logits, loss, gradients, every
    BatchNorm buffer), each against the CPU in float64 (C1's arbiter), then
    both again on the float64 run's ReLU branches: a pre-activation within
    a rounding of 0 takes another branch in another precision or order,
    which moves a train-mode BatchNorm network's earlier gradients."""
    branches = _Branches()
    runs = {}
    for tag, d, dt, mode in (("f64", "cpu", torch.float64, "record"),
                             ("card", dev, torch.float32, None),
                             ("cpu", "cpu", torch.float32, None),
                             ("card_r", dev, torch.float32, "replay"),
                             ("cpu_r", "cpu", torch.float32, "replay")):
        m = _cpu_copy(init).to(d, dt)
        if mode is None:
            runs[tag] = _resnet_step(m, x.to(d, dt), y.to(d))[:3] + (m,)
        else:
            with branches(mode):
                runs[tag] = _resnet_step(m, x.to(d, dt), y.to(d))[:3] + (m,)
    (c_lg, c_loss, c_g, card), (p_lg, p_loss, p_g, cpu) = runs["card"], \
        runs["cpu"]
    bufs = {k: v for k, v in cpu.state_dict().items()
            if k.endswith(("_mean", "_variance"))}
    card_bufs = card.state_dict()
    own = _Branches()
    with own("record"):  # the float32 CPU run's own branches
        _resnet_step(_cpu_copy(init), x.cpu(), y.cpu())
    return {"logits": _rel(c_lg, p_lg), "loss": _rel(c_loss, p_loss),
            "grads": _rel(c_g, p_g),
            "buffers": max(_rel(card_bufs[k], v) for k, v in bufs.items()),
            "buffers_held": len(bufs),
            "worst_grad": _worst_grad(card, cpu),
            "arbiter": _arbiter(c_g, p_g, runs["f64"][2], cpu),
            "branch_flips": own.flips(branches),
            "branch_elements": sum(m[0].numel() for m in branches.masks),
            "grads_replayed": _rel(runs["card_r"][2], runs["cpu_r"][2]),
            "worst_grad_replayed": _worst_grad(runs["card_r"][3],
                                               runs["cpu_r"][3]),
            "replayed_f64": {"card": _rel(runs["card_r"][2],
                                          runs["f64"][2]),
                             "cpu": _rel(runs["cpu_r"][2], runs["f64"][2])}}


def hv_resnet_phase(cfg=HV_RESNET, dev="cuda"):
    """(20a) ResNet-50 trained through ``Model.fit`` beside its own hand
    loop from the same weights over the same batches (cuDNN deterministic:
    the losses must be bit-equal), ms a step, images/s, the host ms a step
    ``Model`` adds, ``flops()`` against the layer shapes, then one step on
    the first images card against CPU with the float64 arbiter. (20b)
    ``evaluate`` and ``predict`` over ``eval_images``; the metrics on the
    card against the CPU's accumulation. Returns (20a, 20b)."""
    import copy

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import metric, nn, optimizer, profiler
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.vision.models import resnet50

    t0 = time.monotonic()
    B, S, C = cfg["batch"], cfg["size"], cfg["classes"]
    steps = cfg["warmup"] + cfg["timed"]
    data = _ImageSet(B * steps, S, C)
    g = torch.Generator(dev).manual_seed(0)
    net = resnet50(num_classes=C, device=dev, generator=g)
    init = _cpu_copy(net)
    hand = copy.deepcopy(net)
    n_params = sum(p.numel() for p in net.parameters())
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats(dev)

    def opt_of(m):
        return optimizer.Momentum(0.1, momentum=0.9, weight_decay=1e-4,
                                  parameters=m.parameters())

    losses, clock = [], {}

    class Clock(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"])
            if step == cfg["warmup"] - 1:
                _sync(dev)
                clock["t0"] = time.perf_counter()

        def on_end(self, mode, logs=None):
            _sync(dev)
            clock["t1"] = time.perf_counter()

    model = paddle.Model(net)
    model.prepare(opt_of(net), nn.CrossEntropyLoss(),
                  metric.Accuracy(topk=(1, 5)))
    model.fit(DataLoader(data, batch_size=B, places=dev), epochs=1,
              verbose=0, callbacks=[Clock()])
    fit_ms = (clock["t1"] - clock["t0"]) * 1e3 / cfg["timed"]
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 \
        if dev != "cpu" else 0.0
    # the hand loop: the same network, batches, optimizer and loss
    loss_fn, hopt, hand_losses = nn.CrossEntropyLoss(), opt_of(hand), []
    hand.train()
    for step, (x, y) in enumerate(DataLoader(data, batch_size=B,
                                             places=dev)):
        loss = loss_fn(hand(x), y)
        loss.backward()
        hopt.step()
        hopt.clear_grad()
        hand_losses.append(float(loss))
        if step == cfg["warmup"] - 1:
            _sync(dev)
            h0 = time.perf_counter()
    _sync(dev)
    hand_ms = (time.perf_counter() - h0) * 1e3 / cfg["timed"]
    same_params = all(torch.equal(a, b) for a, b in zip(
        net.state_dict().values(), hand.state_dict().values()))
    del hand, hopt
    counted = paddle.flops(net, [1, 3, S, S])
    shapes = _conv_linear_flops(copy.deepcopy(net), (1, 3, S, S), dev)
    # one step on the first images, card against CPU, float64 arbiter
    n = cfg["parity_rows"]
    x4 = torch.stack([torch.from_numpy(data[i][0]) for i in range(n)])
    y4 = torch.from_numpy(data.y[:n])
    parity = _arbitrated_parity(init, x4, y4, dev)
    del init
    out = {"params": n_params, "batch": B, "size": S,
           "steps": len(losses), "losses": losses,
           "bit_equal_losses": losses == hand_losses,
           "bit_equal_params": same_params,
           "cudnn_deterministic": True,
           "step_ms": fit_ms, "images_per_s": B / (fit_ms / 1e3),
           "hand_step_ms": hand_ms, "model_host_ms": fit_ms - hand_ms,
           "peak_gib": peak, "flops": counted, "layer_shape_flops": shapes,
           "he2016_mult_adds": RESNET50_MULT_ADDS,
           "parity_rows": n, "parity": parity}
    print(f"  (20a) ResNet-50 ({n_params / 1e6:.1f}M) b{B} x {S}² through "
          f"Model.fit: {fit_ms:.2f} ms a step ({out['images_per_s']:.0f} "
          f"images/s), the hand loop {hand_ms:.2f} ms (Model adds "
          f"{out['model_host_ms']:.2f} ms); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, bit-equal "
          f"{out['bit_equal_losses']} (parameters {same_params}); peak "
          f"{peak:.2f} GiB; flops() {counted:.4g}, the layer shapes "
          f"{shapes:.4g}; the CPU on {n} images: logits "
          f"{parity['logits']:.1e}, loss {parity['loss']:.1e}, "
          f"{parity['buffers_held']} buffers {parity['buffers']:.1e}, "
          f"gradients "
          f"{parity['grads']:.1e} (worst {parity['worst_grad'][0]} "
          f"{parity['worst_grad'][1]:.1e}); from float64: the card "
          f"{parity['arbiter']['card_f64']:.1e} (worst "
          f"{parity['arbiter']['card_f64_worst'][0]} "
          f"{parity['arbiter']['card_f64_worst'][1]:.1e}), the CPU "
          f"{parity['arbiter']['cpu_f64']:.1e} (worst "
          f"{parity['arbiter']['cpu_f64_worst'][0]} "
          f"{parity['arbiter']['cpu_f64_worst'][1]:.1e}); "
          f"{parity['branch_flips']} branches (ReLU, max pool) flipped, on "
          f"float64's the CPU {parity['grads_replayed']:.1e} (worst "
          f"{parity['worst_grad_replayed'][0]} "
          f"{parity['worst_grad_replayed'][1]:.1e})")
    # (20b) evaluate and predict; the metrics on the card and on the CPU
    n_eval = cfg["eval_images"]
    evalset = _ImageSet(n_eval, S, C, seed=4)
    logs = model.evaluate(evalset, batch_size=B)
    pred = model.predict(_Inputs(evalset), batch_size=B,
                         stack_outputs=True)[0]
    acc = metric.Accuracy(topk=(1, 5))
    for i in range(0, n_eval, B):
        acc.update(acc.compute(torch.from_numpy(pred[i:i + B]),
                               torch.from_numpy(evalset.y[i:i + B])))
    card_m = [metric.Precision(), metric.Recall(), metric.Auc()]
    cpu_m = [metric.Precision(), metric.Recall(), metric.Auc()]
    reads0 = profiler.counters().get("metric_host_reads", 0)
    upd_ms, updates = [], 0
    net.eval()
    with torch.no_grad():
        for x, y in DataLoader(evalset, batch_size=B, places=dev):
            lg = net(x)
            p = torch.sigmoid(lg[:, 0] - lg[:, 1])
            lab = y % 2
            _sync(dev)
            for m in card_m:
                t1 = time.perf_counter()
                m.update(p, lab)
                upd_ms.append((time.perf_counter() - t1) * 1e3)
                updates += 1
            for m in cpu_m:
                m.update(p.cpu(), lab.cpu())
    reads = profiler.counters()["metric_host_reads"] - reads0 - len(cpu_m) \
        * (n_eval // B)
    ev = {"images": n_eval, "loss": logs["loss"],
          "acc_top1": logs["acc_top1"], "acc_top5": logs["acc_top5"],
          "cpu_acc": acc.accumulate(),
          "acc_equal": [logs["acc_top1"], logs["acc_top5"]]
          == acc.accumulate(),
          "binary": {m.name()[0]: [a.accumulate(), b.accumulate()]
                     for m, a, b in zip(card_m, card_m, cpu_m)},
          "host_reads_per_update": reads / max(updates, 1),
          "host_ms_per_update": float(np.mean(upd_ms))}
    ev["binary_equal"] = all(a == b for a, b in ev["binary"].values())
    torch.backends.cudnn.deterministic = det
    print(f"  (20b) evaluate/predict over {n_eval} images: acc "
          f"{logs['acc_top1']:.4f} / {logs['acc_top5']:.4f} (the CPU's "
          f"accumulation equal: {ev['acc_equal']}); precision, recall, auc "
          f"{[round(v[0], 6) for v in ev['binary'].values()]} (equal: "
          f"{ev['binary_equal']}); {ev['host_reads_per_update']:.2f} host "
          f"reads an update, {ev['host_ms_per_update']:.3f} ms")
    out["seconds"] = time.monotonic() - t0
    bad = [k for k in ("logits", "loss", "buffers")
           if not parity[k] <= NN_OUT_REL]
    if not parity["grads_replayed"] <= NN_BN_GRAD_REL:
        bad.append("grads on float64's branches")
    if not (out["bit_equal_losses"] and out["bit_equal_params"]):
        bad.append("Model.fit against the hand loop")
    if counted != shapes:
        bad.append("flops")
    if not (ev["acc_equal"] and ev["binary_equal"]
            and ev["host_reads_per_update"] == 1.0):
        bad.append("20b metrics")
    if not all(np.isfinite(v) for v in losses):
        bad.append("non-finite loss")
    if bad:
        fail(f"20a/b: {bad} (outputs {NN_OUT_REL}, gradients "
             f"{NN_BN_GRAD_REL})")
    del model, net
    return out, ev


class _XY:
    """20c's regression set: 256 samples of 64 features."""

    def __init__(self, n=256, d=64):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, d).astype(np.float32)
        self.y = (self.x[:, :8].sum(1, keepdims=True) / 4).astype(np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def hv_sentinel_phase(dev="cuda"):
    """(20c) ``fit`` with the stability sentinel (an anchor every step, no
    skips allowed) on a small network with dropout on the card: an
    injected ``loss.spike`` at batch 5 is rolled back, and the run's
    parameters must equal, bit for bit, those of a run that never saw the
    batch (the anchor restores the card's generator through
    ``program_rng``)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.fault import inject
    from paddle_tpu_torch.fault.sentinel import StabilitySentinel
    from paddle_tpu_torch.io import DataLoader

    t0 = time.monotonic()
    root = Path(tempfile.mkdtemp(prefix="hv_sentinel_"))

    def run(tag, spike=None, pre_q=()):
        inject.disarm()
        if spike:
            inject.arm(spike)
        prandom.seed(7)
        g = torch.Generator(dev).manual_seed(7)
        net = nn.Sequential(nn.Linear(64, 256, device=dev, generator=g),
                            nn.ReLU(), nn.Dropout(0.2),
                            nn.Linear(256, 1, device=dev, generator=g))
        model = paddle.Model(net)
        model.prepare(optimizer.Adam(0.01, parameters=net.parameters()),
                      nn.MSELoss())
        sent = StabilitySentinel(
            anchor=AutoCheckpoint(str(root / tag), interval_steps=1,
                                  keep_last=2),
            window=32, warmup=3, zmax=60, max_skips=0, max_rollbacks=2,
            cooldown=4)
        for pos in pre_q:
            sent.quarantine.add(-1, pos=pos, action="skip")
        t1 = time.perf_counter()
        try:
            model.fit(DataLoader(_XY(), batch_size=16, shuffle=True,
                                 seed=99, places=dev),
                      epochs=2, verbose=0, stability=sent)
        finally:
            sent.close()
            inject.disarm()
        ms = (time.perf_counter() - t1) * 1e3
        return sent, [p.detach().clone() for p in net.parameters()], ms

    s1, p1, ms1 = run("spiked", spike="loss.spike:step=5,scale=1000000")
    _, p2, ms2 = run("clean", pre_q=[(0, 5)])
    shutil.rmtree(root, ignore_errors=True)
    entries = s1.quarantine.entries()
    out = {"rollbacks": sum(e["action"] == "rollback" for e in entries),
           "quarantined": [e["pos"] for e in entries],
           "bit_equal": all(torch.equal(a, b) for a, b in zip(p1, p2)),
           "fit_ms": {"spiked": ms1, "clean": ms2},
           "seconds": time.monotonic() - t0}
    print(f"  (20c) the sentinel through fit: {out['rollbacks']} rollback "
          f"of {out['quarantined']}, bit-equal to the clean run "
          f"{out['bit_equal']} ({ms1:.0f} / {ms2:.0f} ms a fit)")
    if not (out["bit_equal"] and out["rollbacks"] == 1):
        fail(f"20c: {out}")
    return out


def _yolo_targets(b, cfg, seed=5):
    rng = np.random.RandomState(seed)
    G = cfg["boxes"]
    gt = np.concatenate([rng.rand(b, G, 2) * 0.8 + 0.1,
                         rng.rand(b, G, 2) * 0.3 + 0.05], -1)
    gl = rng.randint(0, cfg["classes"], (b, G))
    gl[:, G // 2 + 1:] = -1  # padding rows
    return (torch.from_numpy(gt.astype(np.float32)),
            torch.from_numpy(gl.astype(np.int64)))


def hv_yolo_phase(cfg=HV_YOLO, dev="cuda"):
    """(20d) YOLOv3-DarkNet53: one image in eval mode on the initial
    weights against the CPU (heads, the loss, every gradient, the
    detections), then at batch ``batch`` forward, the three scales'
    ``yolov3_loss`` on synthetic boxes, backward and a Momentum step (ms a
    step), then ``YOLOv3Postprocess`` (ms)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.vision.models import (YOLOv3Postprocess,
                                                yolov3_darknet53)

    t0 = time.monotonic()
    B, S, C = cfg["batch"], cfg["size"], cfg["classes"]
    g = torch.Generator(dev).manual_seed(0)
    model = yolov3_darknet53(num_classes=C, device=dev, generator=g)
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.randn(B, 3, S, S, generator=torch.Generator().manual_seed(6))
    gt, gl = _yolo_targets(B, cfg)
    xd, gtd, gld = x.to(dev), gt.to(dev), gl.to(dev)
    # one image against the CPU, eval mode, on the initial weights: the
    # card on its own branches, then on the CPU's (held)
    def one(m, d, branches, mode):
        m.eval()
        with branches(mode):
            heads = m(x[:1].to(d))
            loss1 = m.loss(x[:1].to(d), gt[:1].to(d), gl[:1].to(d))
            loss1.backward()
        with torch.no_grad():
            d1 = YOLOv3Postprocess(m, img_hw=(S, S))(x[:1].to(d))
        r = ([h.detach() for h in heads], loss1.detach(), _grad_vec(m),
             d1[0].cpu())
        m.clear_gradients()
        return r

    b_cpu, b_card = _Branches(), _Branches()
    res = [one(model, dev, b_card, "record"),
           one(_cpu_copy(model), "cpu", b_cpu, "record")]
    replayed = one(model, dev, b_cpu, "replay")[2]
    opt = optimizer.Momentum(1e-3, momentum=0.9, parameters=model.parameters())
    model.train()
    losses = []
    for step in range(1 + cfg["timed"]):
        if step == 1:
            _sync(dev)
            t1 = time.perf_counter()
        loss = model.loss(xd, gtd, gld)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    step_ms = (time.perf_counter() - t1) * 1e3 / cfg["timed"]
    model.eval()
    post = YOLOv3Postprocess(model, img_hw=(S, S))
    with torch.no_grad():
        post(xd)
        _sync(dev)
        t1 = time.perf_counter()
        dets = post(xd)
        _sync(dev)
    post_ms = (time.perf_counter() - t1) * 1e3
    (ch, cl, cg, cd), (ph, pl, pg, pd) = res
    kept_c, kept_p = int((cd[:, 1] > 0).sum()), int((pd[:, 1] > 0).sum())
    rows = ((cd[:, 0] == pd[:, 0])
            & ((cd[:, 2:] - pd[:, 2:]).abs().amax(1) <= 1e-2)
            & ((cd[:, 1] - pd[:, 1]).abs() <= HV_DET_SCORE))
    out = {"params": n_params, "batch": B, "size": S,
           "losses": losses, "step_ms": step_ms,
           "images_per_s": B / (step_ms / 1e3),
           "postprocess_ms": post_ms, "detections": list(dets.shape),
           "kept": int((dets[..., 1] > 0).sum()),
           "parity": {"heads": max(_rel(a, b) for a, b in zip(ch, ph)),
                      "loss": _rel(cl, pl), "grads": _rel(replayed, pg),
                      "grads_own_branches": _rel(cg, pg),
                      "branch_flips": b_card.flips(b_cpu),
                      "kept": [kept_c, kept_p],
                      "score_max_abs": float((cd[:, 1] - pd[:, 1]).abs()
                                             .max()),
                      "rows_equal": float(rows.float().mean())},
           "seconds": time.monotonic() - t0}
    par = out["parity"]
    print(f"  (20d) YOLOv3-DarkNet53 ({n_params / 1e6:.1f}M, {C} classes) "
          f"b{B} x {S}²: {step_ms:.2f} ms a step ({out['images_per_s']:.1f} "
          f"images/s), losses {losses[0]:.2f} -> {losses[-1]:.2f}; "
          f"postprocess {post_ms:.2f} ms -> {out['detections']}, "
          f"{out['kept']} kept; the CPU on 1 image: heads "
          f"{par['heads']:.1e}, loss {par['loss']:.1e}, gradients "
          f"{par['grads_own_branches']:.1e} ({par['branch_flips']} branches "
          f"flipped; on the CPU's "
          f"{par['grads']:.1e}), kept {par['kept']}, scores "
          f"{par['score_max_abs']:.1e}, rows {par['rows_equal']:.3f} "
          f"({out['seconds']:.1f} s)")
    bad = [k for k in ("heads", "loss") if not par[k] <= NN_OUT_REL]
    if not par["grads"] <= NN_GRAD_REL:
        bad.append("grads")
    if kept_c != kept_p or par["score_max_abs"] > HV_DET_SCORE \
            or par["rows_equal"] < HV_DET_ROWS:
        bad.append("detections")
    if not all(np.isfinite(v) for v in losses):
        bad.append("non-finite loss")
    if bad:
        fail(f"20d: {bad} outside their bounds")
    del model, opt
    return out


def hv_ops_phase(cfg=HV_OPS, dev="cuda"):
    """(20e, ops) ``roi_align`` with ``rois`` RoIs on an FPN level, ``nms``
    over ``nms_boxes`` boxes and a 3 x 3 ``deform_conv2d``, each against
    the CPU, with its card time."""
    from paddle_tpu_torch.vision import ops as V

    gen = torch.Generator().manual_seed(8)
    C, H, W = cfg["feat"]
    feat = torch.randn(1, C, H, W, generator=gen)
    lo = torch.rand(cfg["rois"], 2, generator=gen) * torch.tensor(
        [W, H]) / cfg["scale"] * 0.8
    wh = torch.rand(cfg["rois"], 2, generator=gen) * 200 + 16
    rois = torch.cat([lo, lo + wh], 1)
    num = torch.tensor([cfg["rois"]], dtype=torch.int32)
    nb = cfg["nms_boxes"]
    b0 = torch.rand(nb, 2, generator=gen) * 600
    boxes = torch.cat([b0, b0 + 20 + torch.rand(nb, 2, generator=gen) * 80],
                      1)
    scores = torch.rand(nb, generator=gen)
    DC, DH, DW = cfg["deform"]
    dx = torch.randn(1, DC, DH, DW, generator=gen)
    off = torch.randn(1, 18, DH, DW, generator=gen) * 2
    dw = torch.randn(DC, DC, 3, 3, generator=gen) * 0.05

    def on(d):
        return {
            "roi_align": lambda: V.roi_align(feat.to(d), rois.to(d),
                                             num.to(d), 7,
                                             spatial_scale=cfg["scale"]),
            "nms": lambda: V.nms(boxes.to(d), 0.5, scores=scores.to(d)),
            "deform_conv2d": lambda: V.deform_conv2d(dx.to(d), off.to(d),
                                                     dw.to(d), padding=1),
        }

    card, cpu = on(dev), on("cpu")
    out = {}
    for name in card:
        a, b = card[name](), cpu[name]()
        if name == "nms":
            err = 0.0 if torch.equal(a.cpu(), b) else 1.0
        else:
            err = _rel(a, b)
        args = [t.to(dev) for t in {"roi_align": (feat, rois, num),
                                    "nms": (boxes, scores),
                                    "deform_conv2d": (dx, off, dw)}[name]]
        if name == "roi_align":
            fn = lambda: V.roi_align(*args, 7, spatial_scale=cfg["scale"])
        elif name == "nms":
            fn = lambda: V.nms(args[0], 0.5, scores=args[1])
        else:
            fn = lambda: V.deform_conv2d(*args, padding=1)
        if dev == "cpu" or name == "nms":  # nms works on the host
            t1 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t1) * 1e3
        else:
            ms = time_ms(fn, iters=5)
        out[name] = {"err": err, "ms": ms, "shape": list(a.shape)}
    print("  (20e) ops against the CPU: " + ", ".join(
        f"{k} {v['err']:.1e} ({v['ms']:.3f} ms, {v['shape']})"
        for k, v in out.items()))
    bad = [k for k, v in out.items() if not v["err"] <= NN_OP_REL]
    if bad:
        fail(f"20e: {bad} above {NN_OP_REL} from the CPU")
    return out


def hv_families_phase(families=HV_FAMILIES, batch=HV_FAMILY_BATCH,
                      dev="cuda"):
    """(20e, families) each family at full width: one image in eval mode
    on the initial weights against the CPU (the logits, and every gradient
    of a fixed weighted sum of them, all together by relative norm, on the
    card's own ReLU branches and, held, on the CPU's), then one Momentum
    training step at ``batch`` (loss finite, ms)."""
    from paddle_tpu_torch import optimizer, vision
    from paddle_tpu_torch.nn import functional as F

    out = {}
    for fam, (builder, kw, shape) in families.items():
        t1 = time.monotonic()
        g = torch.Generator(dev).manual_seed(0)
        net = getattr(vision.models, builder)(device=dev, generator=g, **kw)
        classes = kw.get("num_classes", 10 if builder == "LeNet" else 1000)
        gen = torch.Generator().manual_seed(9)
        x = torch.randn(batch, *shape, generator=gen)
        y = torch.randint(0, classes, (batch,), generator=gen)
        w = torch.randn(1, classes, generator=gen)
        # the initial weights, eval mode, against the CPU: the card on its
        # own branches, then on the CPU's (held)
        def one(m, d, branches, mode):
            m.eval()
            with branches(mode):
                lg = m(x[:1].to(d))
                (lg * w.to(d)).sum().backward()
            r = (lg.detach(), _grad_vec(m))
            m.clear_gradients()
            return r

        b_cpu, b_card = _Branches(), _Branches()
        res = [one(net, dev, b_card, "record"),
               one(_cpu_copy(net), "cpu", b_cpu, "record")]
        replayed = one(net, dev, b_cpu, "replay")[1]
        opt = optimizer.Momentum(0.01, momentum=0.9,
                                 parameters=net.parameters())
        net.train()
        _sync(dev)
        t2 = time.perf_counter()
        loss = F.cross_entropy(net(x.to(dev)), y.to(dev))
        loss.backward()
        opt.step()
        opt.clear_grad()
        _sync(dev)
        step_ms = (time.perf_counter() - t2) * 1e3
        out[fam] = {"builder": builder,
                    "params": sum(p.numel() for p in net.parameters()),
                    "input": [batch, *shape], "loss": float(loss),
                    "first_step_ms": step_ms,
                    "logits": _rel(res[0][0], res[1][0]),
                    "grads": _rel(replayed, res[1][1]),
                    "grads_own_branches": _rel(res[0][1], res[1][1]),
                    "branch_flips": b_card.flips(b_cpu),
                    "seconds": time.monotonic() - t1}
        del net, opt, res
    print("  (20e) families, one step at b"
          f"{batch} then one image against the CPU: " + "; ".join(
              f"{k} {v['first_step_ms']:.0f} ms, {v['logits']:.1e} / "
              f"{v['grads_own_branches']:.1e} ({v['branch_flips']} flips) / "
              f"{v['grads']:.1e}" for k, v in out.items()))
    bad = [k for k, v in out.items()
           if not (np.isfinite(v["loss"]) and v["logits"] <= NN_OUT_REL
                   and v["grads"] <= NN_GRAD_REL)]
    if bad:
        fail(f"20e: {bad} outside their bounds (logits {NN_OUT_REL}, "
             f"gradients {NN_GRAD_REL})")
    return out


def hapi_vision_phase(card, dev="cuda", cfgs=None):
    """Phase 20: 20a-e; the results go on the ``hapi_vision`` line.
    ``cfgs`` (resnet, yolo, ops, families, family batch) cut the sizes for
    a rehearsal."""
    import gc

    t0 = time.monotonic()
    rn, yo, ops, fams, fb = cfgs or (HV_RESNET, HV_YOLO, HV_OPS,
                                     HV_FAMILIES, HV_FAMILY_BATCH)
    if dev != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    HV["card"] = card
    HV["20a"], HV["20b"] = hv_resnet_phase(rn, dev)
    gc.collect()
    HV["20c"] = hv_sentinel_phase(dev)
    HV["20d"] = hv_yolo_phase(yo, dev)
    gc.collect()
    if dev != "cpu":
        torch.cuda.empty_cache()
    HV["20e"] = {"ops": hv_ops_phase(ops, dev),
                 "families": hv_families_phase(fams, fb, dev)}
    gc.collect()
    if dev != "cpu":
        HV["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        torch.cuda.empty_cache()
    HV["seconds"] = time.monotonic() - t0
    print(f"  (20) {HV['seconds']:.1f} s, peak "
          f"{HV.get('peak_gib', 0.0):.2f} GiB")


# -- phase 21: export and deployment -----------------------------------------

EXPORT = {}  # phase 21's results: the {"export": ...} line
# 21a/21b: GPT-3 1.3B's export at the training length, the Predictor's
# batch, its timed runs, 21b's SGD steps and learning rate
EXPORT_T, EXPORT_B, EXPORT_RUNS = 2048, 2, 5
EXPORT_STEPS, EXPORT_LR = 3, 1e-3
# 21a: ||predictor - eager|| / ||eager|| of the logits that fails the
# phase (the same ATen ops and kernels: expected bit-equal, and the line
# says whether they were); 21b: the losses' relative difference that fails
EXPORT_LOGITS_REL_TOL = 1e-3
EXPORT_LOSS_REL_TOL = 1e-3
# 21b: each step's loss drop from the first loss (loss_0 - loss_k) against
# eager's, relative: a program that does not train (parameters unchanged,
# zero gradients) is 1 off. At lr 1e-3 eager's drops are ~7e-4 on a loss
# of ~11.2, where one f32 ulp is ~1e-6 (1.4e-3 of the drop). On the card
# the losses must also be bit-equal: the same ATen ops and kernels run.
EXPORT_DROP_REL_TOL = 1e-2
# 21c: ResNet-50 at b8 x 224², f32, through the C API, 4 cloned predictors
EXPORT_RESNET = {"batch": 8, "size": 224, "classes": 1000, "threads": 4}
EXPORT_RESNET_TOL = 1e-5
# 21c's capi_demo, a process of its own: |demo - eager| over the largest
# |logit|
EXPORT_DEMO_REL_TOL = 1e-5
# 21e: the card's f32 flash kernels against the CPU's plain versions
# through a 4-layer tiny GPT's logits (the kernels alone hold 1e-5)
EXPORT_CPU_TOL = 1e-4
FLASH_OP = "paddle_tpu_torch.flash_attention_fwd.default"


def _op_count(ep, name) -> int:
    return sum(1 for n in ep.graph.nodes
               if n.op == "call_function" and str(n.target) == name)


def _rel_norm(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _artifact_bytes(prefix):
    return {s: os.path.getsize(prefix + s)
            for s in (".pdmodel", ".pdiparams", ".pdtrain", ".pdtrain.json")
            if os.path.exists(prefix + s)}


def _predictor_config(prefix, dev):
    from paddle_tpu_torch import inference

    cfg = inference.Config(prefix)
    if torch.device(dev).type == "cpu":
        cfg.disable_gpu()
    else:
        cfg.enable_use_gpu(device_id=torch.device(dev).index or 0)
    return cfg


def export_gpt_phase(cfg, dev, tmp, B=EXPORT_B, T=EXPORT_T, runs=EXPORT_RUNS):
    """(21a) ``jit.save`` of GPT with a symbolic batch, one flash forward
    node a layer, the Predictor's logits against the eager model's at B and
    at 1 (through the symbolic batch), launches a run, ms a run beside the
    eager forward's. Returns (results, model, prefix)."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.static import InputSpec

    card = torch.device(dev).type == "cuda"
    L = cfg.num_layers
    model = GPTForPretraining(cfg, device=dev, seed=0,
                              dtype=torch.bfloat16 if card else None).eval()
    prefix = os.path.join(tmp, "gpt")
    t0 = time.monotonic()
    jit.save(model, prefix, input_spec=[InputSpec([None, T], "int64",
                                                  "input_ids")])
    out = {"save_s": time.monotonic() - t0, "bytes": _artifact_bytes(prefix)}
    ep, meta = jit.read_program(prefix + ".pdmodel")
    out["flash_nodes"] = _op_count(ep, FLASH_OP)
    out["dynamic_batch"] = meta["dynamic"]
    if out["flash_nodes"] != L or not meta["dynamic"]:
        fail(f"21a: the saved program holds {out['flash_nodes']} "
             f"{FLASH_OP} nodes (want {L}), dynamic={meta['dynamic']}")
    del ep
    t0 = time.monotonic()
    pred = inference.create_predictor(_predictor_config(prefix, dev))
    out["load_s"] = time.monotonic() - t0
    g = torch.Generator().manual_seed(21)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=g).to(dev)
    h = pred.get_input_handle("input_ids")
    for b in (B, 1):
        x = ids[:b]
        with torch.inference_mode():
            want = model(x)
        h.share_external_data(x)
        K.reset_launch_counts()
        pred.run()
        got = pred.output_tensors()[0]
        launches = K.launch_counts()["flash_attention_fwd"]
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"21a B={b}: predictor logits {tuple(got.shape)} against "
                 f"{tuple(want.shape)} or non-finite")
        rel = _rel_norm(got, want)
        row = {"max_abs_err": float((got.float() - want.float()).abs().max()),
               "rel_norm": rel, "bit_equal": bool(torch.equal(got, want)),
               "launches_flash_fwd": launches}
        out[f"b{b}"] = row
        print(f"  21a B={b}: logits {row['max_abs_err']:.3e} max abs, "
              f"{rel:.3e} rel norm, bit-equal {row['bit_equal']}; "
              f"flash forward launches {launches}")
        if rel > EXPORT_LOGITS_REL_TOL:
            fail(f"21a B={b}: predictor logits {rel:.3e} from eager")
        if card and launches != L:
            fail(f"21a B={b}: {launches} flash forward launches a run "
                 f"(want {L})")
    if card:
        h.share_external_data(ids)
        K.reset_launch_counts()
        out["predictor_ms"] = time_ms(pred.run, iters=runs)
        out["launches_flash_fwd_timed"] = K.launch_counts()[
            "flash_attention_fwd"]
        if out["launches_flash_fwd_timed"] != L * (runs + 3):
            fail(f"21a: {out['launches_flash_fwd_timed']} flash forward "
                 f"launches over {runs + 3} timed runs (want {L} each)")

        def eager():
            with torch.inference_mode():
                model(ids)

        out["eager_ms"] = time_ms(eager, iters=runs)

        def wall_ms(fn):  # a caller's wait: launch to result, host included
            ts = []
            for _ in range(runs):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(dev)
                ts.append((time.perf_counter() - t0) * 1e3)
            return sorted(ts)[len(ts) // 2]

        out["predictor_wall_ms"] = wall_ms(pred.run)
        out["eager_wall_ms"] = wall_ms(eager)
        print(f"  21a: predictor {out['predictor_ms']:.2f} ms a run "
              f"(median {out['predictor_wall_ms']:.2f} ms launch to result), "
              f"eager forward {out['eager_ms']:.2f} ms (median "
              f"{out['eager_wall_ms']:.2f}) (B={B}, T={T}); save "
              f"{out['save_s']:.1f} s, load {out['load_s']:.1f} s; bytes "
              f"{out['bytes']}")
    del pred
    return out, model, prefix


def _export_ce(outs, labels):
    """The next-token cross-entropy of 21b, on the logits in f32."""
    from paddle_tpu_torch.nn import functional as F

    logits = outs[0].float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def export_train_phase(model, prefix, dev, T=EXPORT_T, steps=EXPORT_STEPS,
                       lr=EXPORT_LR):
    """(21b) ``static.load_program`` on 21a's artifact, cross-entropy
    appended, ``steps`` plain-SGD ``train_step``s at B=1 against the eager
    model's steps on the same weights and batch; dQ and dK/dV launches a
    step."""
    import gc

    from paddle_tpu_torch import static
    from paddle_tpu_torch.ops import kernels as K

    card = torch.device(dev).type == "cuda"
    L = model.config.num_layers
    t0 = time.monotonic()
    prog = static.load_program(prefix, device=dev)
    out = {"load_s": time.monotonic() - t0, "steps": steps, "lr": lr}
    prog.append_backward(_export_ce)
    g = torch.Generator().manual_seed(22)
    ids = torch.randint(0, model.config.vocab_size, (1, T), generator=g)
    labels = torch.randint(0, model.config.vocab_size, (1, T), generator=g)
    ids, labels = ids.to(dev), labels.to(dev)
    losses, per_step, ms = [], [], []
    K.reset_launch_counts()
    for _ in range(steps):
        c0 = dict(K.launch_counts())
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(float(prog.train_step([ids], [labels], lr=lr)))
        ms.append((time.perf_counter() - t0) * 1e3)
        c = K.launch_counts()
        per_step.append({k: c[k] - c0[k] for k in FLASH_REPLACES})
    out["launches"] = {k: K.launch_counts()[k] for k in FLASH_REPLACES}
    if card and any(s["flash_attention_dq"] != L
                    or s["flash_attention_dkv"] != L
                    or s["flash_attention_fwd"] != L for s in per_step):
        fail(f"21b: flash launches a step {per_step} (want {L} of each)")
    del prog
    gc.collect()
    params = [p for _, p in model.named_parameters()]
    eager, eager_ms = [], []
    for _ in range(steps):
        _sync(dev)
        t0 = time.perf_counter()
        loss = _export_ce([model(ids)], labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, gr in zip(params, grads):
                p.copy_(p - lr * gr)
        eager.append(float(loss.detach()))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, eager))
    drops = [losses[0] - x for x in losses[1:]]
    eager_drops = [eager[0] - x for x in eager[1:]]
    drop_rel = max(abs(a - b) / abs(b) if b else math.inf
                   for a, b in zip(drops, eager_drops))
    out.update(losses=losses, eager_losses=eager, rel_diff=rel,
               bit_equal=losses == eager, drops=drops,
               eager_drops=eager_drops, drop_rel_diff=drop_rel, step_ms=ms,
               eager_step_ms=eager_ms)
    print(f"  21b: TrainableProgram losses {losses}, eager {eager} (max rel "
          f"{rel:.3e}, bit-equal {losses == eager}); drops {drops} against "
          f"eager's {eager_drops} (max rel {drop_rel:.3e}); launches a step "
          f"{per_step[-1]}; step ms {[round(x, 1) for x in ms]} against "
          f"eager {[round(x, 1) for x in eager_ms]}")
    if not all(math.isfinite(x) for x in losses) or rel > EXPORT_LOSS_REL_TOL:
        fail(f"21b: losses {losses} against eager {eager}")
    if not all(d > 0 for d in eager_drops) or drop_rel > EXPORT_DROP_REL_TOL:
        fail(f"21b: loss drops {drops} against eager's {eager_drops} "
             f"(max rel {drop_rel:.3e}, limit {EXPORT_DROP_REL_TOL})")
    if card and losses != eager:
        fail(f"21b: losses {losses} not bit-equal to eager's {eager}")
    return out


def export_resnet_phase(dev, tmp, cfg=EXPORT_RESNET):
    """(21c) ResNet-50 through ``static.save_inference_model``, then the C
    API through ctypes and ``threads`` cloned Predictors on threads, each
    against eager (cuDNN deterministic), while the ``capi_demo`` host runs
    as a subprocess. Returns (results, the demo's check: call it to wait
    for the host and hold its output against eager)."""
    import ctypes

    from paddle_tpu_torch import inference, static
    from paddle_tpu_torch.inference import capi
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50

    B, S, C = cfg["batch"], cfg["size"], cfg["classes"]
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    g = torch.Generator(dev).manual_seed(0)
    net = resnet50(num_classes=C, device=dev, generator=g).eval()
    prefix = os.path.join(tmp, "resnet50")
    t0 = time.monotonic()
    static.save_inference_model(
        prefix, [InputSpec([B, 3, S, S], "float32", "image")], net)
    out = {"save_s": time.monotonic() - t0, "bytes": _artifact_bytes(prefix)}

    def eager(x):
        with torch.no_grad():
            return net(torch.from_numpy(x).to(dev)).cpu().numpy()

    rng = np.random.RandomState(23)
    xs = [rng.randn(B, 3, S, S).astype(np.float32)
          for _ in range(cfg["threads"] + 1)]
    wants = [eager(x) for x in xs]
    ramp = ((np.arange(B * 3 * S * S) % 17).astype(np.float32) * 0.25
            - 2.0).reshape(B, 3, S, S)
    want_demo = eager(ramp).astype(np.float64)
    t0 = time.monotonic()
    L = capi.lib()
    demo = capi.build_demo()
    out["capi_build_s"] = time.monotonic() - t0
    # the host is a new process with PyTorch's defaults, which let cuDNN
    # take TF32; NVIDIA's override keeps its convolutions in f32 as here
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0")
    t_demo = time.monotonic()
    proc = subprocess.Popen([str(demo), "--device", str(dev), prefix,
                             str(ROOT), str(B), "3", str(S), str(S)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    # on the card the reference's create (its default device, cuda:0)
    d = torch.device(dev)
    p = L.PD_PredictorCreate(prefix.encode()) \
        if d.type == "cuda" and not d.index else \
        L.PD_PredictorCreateOnDevice(prefix.encode(), str(dev).encode())
    if not p:
        fail(f"21c: PD_PredictorCreate: {L.PD_LastError().decode()}")
    name_in = L.PD_PredictorInputName(p, 0)
    name_out = L.PD_PredictorOutputName(p, 0)
    shape = (ctypes.c_int64 * 4)(B, 3, S, S)
    fp = ctypes.POINTER(ctypes.c_float)
    run_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        if L.PD_PredictorSetInputFloat(p, name_in, xs[0].ctypes.data_as(fp),
                                       shape, 4) or L.PD_PredictorRun(p):
            fail(f"21c: C API run: {L.PD_LastError().decode()}")
        n = L.PD_PredictorOutputNumel(p, name_out)
        buf = (ctypes.c_float * max(n, 1))()
        if n != B * C or L.PD_PredictorGetOutputFloat(p, name_out, buf, n):
            fail(f"21c: C API output ({n} elements): "
                 f"{L.PD_LastError().decode()}")
        run_ms.append((time.perf_counter() - t0) * 1e3)
    L.PD_PredictorDestroy(p)
    got = np.frombuffer(buf, np.float32).reshape(B, C)
    out["capi_max_abs_err"] = float(np.abs(got - wants[0]).max())
    out["capi_ms"] = run_ms
    if out["capi_max_abs_err"] > EXPORT_RESNET_TOL:
        fail(f"21c: C API output {out['capi_max_abs_err']:.3e} from eager")
    pred = inference.create_predictor(_predictor_config(prefix, dev))
    clones = [pred.clone() for _ in range(cfg["threads"])]
    if any(c._call is not pred._call for c in clones):
        fail("21c: a clone does not share the loaded program")
    errs = [None] * len(clones)

    def work(i):
        try:
            errs[i] = float(np.abs(clones[i].run([xs[i + 1]])[0]
                                   - wants[i + 1]).max())
        except Exception as e:  # reported below
            errs[i] = repr(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(clones))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["clone_max_abs_err"] = errs
    if not all(isinstance(e, float) and e <= EXPORT_RESNET_TOL for e in errs):
        fail(f"21c: cloned predictors on threads: {errs}")
    torch.backends.cudnn.deterministic = det
    torch.backends.cudnn.benchmark = bench
    print(f"  21c: ResNet-50 b{B}x{S}²: C API {out['capi_max_abs_err']:.3e} "
          f"from eager, {[round(x, 1) for x in run_ms]} ms a call (set, run, "
          f"get); {len(errs)} cloned predictors on threads {errs}")

    def demo_check():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            fail("21c: capi_demo did not finish in 600 s")
        out["demo_s"] = time.monotonic() - t_demo
        if proc.returncode:
            fail(f"21c: capi_demo exited {proc.returncode}: {stderr[-2000:]}")
        res = json.loads(stdout.strip().splitlines()[-1])
        out["demo"] = res
        # another process may pick other cuDNN algorithms: held relative to
        # the logits' scale (f32 sums in another order)
        scale = float(np.abs(want_demo).max())
        head = float(np.abs(np.asarray(res["head"])
                            - want_demo.ravel()[:4]).max())
        out["demo_head_rel"] = head / scale
        if res["numel"] != want_demo.size \
                or head > EXPORT_DEMO_REL_TOL * scale \
                or abs(res["sum"] - want_demo.sum()) \
                > EXPORT_DEMO_REL_TOL * scale * want_demo.size:
            fail(f"21c: capi_demo {res} against eager sum "
                 f"{want_demo.sum():.6f}, head {want_demo.ravel()[:4]}")
        print(f"  21c: capi_demo {out['demo_s']:.1f} s (beside 21c-e), head "
              f"within {out['demo_head_rel']:.1e} of the largest logit")

    return out, demo_check


def _export_loop_fn(x):
    """21d's function: a tensor ``while`` and a tensor ``if``."""
    s = x * 0.0
    i = x.sum() * 0.0
    while i < 3.0:
        s = s + x
        i = i + 1.0
    if s.mean() > 0:
        y = s * 2.0
    else:
        y = s - 1.0
    return y


def export_control_flow_phase(dev, tmp):
    """(21d) ``to_static`` of ``_export_loop_fn``: its export holds
    ``while_loop`` and ``cond`` nodes, and the exported program, saved and
    loaded, gives eager's outputs on inputs that take each branch."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec

    st = jit.to_static(_export_loop_fn)
    spec = InputSpec([None, 64], "float32", "x")
    ep = st.concrete_program(spec)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    if not {"cond", "while_loop"} <= targets:
        fail(f"21d: the export holds no cond/while_loop node: {targets}")
    prefix = os.path.join(tmp, "loop")
    jit.save(st, prefix, input_spec=[spec], device=dev)
    layer = jit.load(prefix, device=dev)
    g = torch.Generator().manual_seed(24)
    cases = []
    for b, sign in ((4, 1.0), (3, -1.0)):
        x = (torch.rand(b, 64, generator=g) * sign).to(dev)
        want = _export_loop_fn(x)
        for tag, got in (("export", ep.module()(x)), ("load", layer(x))):
            cases.append((tag, b, bool(torch.equal(got, want))))
    if not all(c[2] for c in cases):
        fail(f"21d: exported outputs differ from eager: {cases}")
    print(f"  21d: to_static while + if exported with {sorted(targets & {'cond', 'while_loop'})}"
          f", saved and loaded on {dev}: outputs equal to eager at both "
          "branches")
    return {"nodes": sorted(targets & {"cond", "while_loop"}),
            "equal": cases}


def export_cpu_phase(dev, tmp):
    """(21e) a 4-layer tiny GPT, f32, ``attention_impl="flash"``, saved on
    ``dev`` and run by a ``Config.disable_gpu()`` Predictor (the flash
    operator's CPU implementation, no launch) against ``dev``'s logits."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.static import InputSpec

    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                   attention_impl="flash")
    m = GPTForPretraining(cfg, device=dev, seed=0).eval()
    prefix = os.path.join(tmp, "gpt_tiny")
    jit.save(m, prefix, input_spec=[InputSpec([None, 64], "int64",
                                              "input_ids")])
    g = torch.Generator().manual_seed(25)
    ids = torch.randint(0, cfg.vocab_size, (3, 64), generator=g)
    with torch.inference_mode():
        want = m(ids.to(dev)).cpu()
    cpu = inference.Config(prefix)
    cpu.disable_gpu()
    pred = inference.create_predictor(cpu)
    K.reset_launch_counts()
    got = torch.from_numpy(pred.run([ids.numpy()])[0])
    launches = sum(K.launch_counts().values())
    err = float((got - want).abs().max())
    print(f"  21e: tiny GPT saved on {dev}, run on the CPU: "
          f"{err:.3e} max abs from {dev}'s logits, {launches} launches")
    if pred.device.type != "cpu" or launches or err > EXPORT_CPU_TOL:
        fail(f"21e: CPU predictor on {pred.device}: {err:.3e} from "
             f"{dev}'s logits, {launches} kernel launches")
    return {"max_abs_err": err, "launches": launches}


def export_phase(card, dev="cuda", cfgs=None):
    """Phase 21: 21a-e; the results go on the ``export`` line. ``cfgs``
    (GPT config, batch, length, runs, ResNet dict) cut the sizes for a
    rehearsal on the CPU."""
    import gc

    from paddle_tpu_torch.models import gpt3_1p3b

    t0 = time.monotonic()
    gpt, B, T, runs, rn = cfgs or (
        gpt3_1p3b(hidden_dropout=0.0, attention_dropout=0.0), EXPORT_B,
        EXPORT_T, EXPORT_RUNS, EXPORT_RESNET)
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_export_")
    try:
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        EXPORT["card"] = card
        EXPORT["21a"], model, prefix = export_gpt_phase(gpt, dev, tmp, B, T,
                                                        runs)
        EXPORT["21b"] = export_train_phase(model, prefix, dev, T)
        del model
        gc.collect()
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()
        EXPORT["21c"], demo_check = export_resnet_phase(dev, tmp, rn)
        EXPORT["21d"] = export_control_flow_phase(dev, tmp)
        EXPORT["21e"] = export_cpu_phase(dev, tmp)
        demo_check()
        if torch.device(dev).type == "cuda":
            EXPORT["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    EXPORT["seconds"] = time.monotonic() - t0
    print(f"  (21) {EXPORT['seconds']:.1f} s, peak "
          f"{EXPORT.get('peak_gib', 0.0):.2f} GiB")



# -- phase 22: quantization and incubate --------------------------------------

QI = {}  # phase 22's results: the {"quant_incubate": ...} line
QAT_TYPES = ["ColumnParallelLinear", "RowParallelLinear"]
QAT_COMPILED, QAT_EAGER, QAT_LR = 5, 2, 1e-4
QAT_WARMUP, QAT_TIMED = 3, 5  # the unquantized and quantized steps timed
# 22a's 2-layer check, card against the CPU: B, T, the data seeds and the
# failure bounds (bf16 both sides; a value a rounding moves across a grid
# boundary moves a whole level, scale / 127). Each bound is 3-5x the worst
# reading over the seeds on an H100 (4.6e-5 and 3.5e-2; PERF.md)
QAT_CHECK = {"layers": 2, "batch": 1, "seq": 256, "seeds": (7, 8, 9)}
QAT_LOSS_REL_TOL, QAT_GRAD_REL_TOL = 2e-4, 0.12
INT8_RESNET = {"batch": 32, "size": 224, "classes": 1000, "calib": 4,
               "runs": 5}
INT8_DRIFT_TOL = 0.12  # tests/test_int8_inference.py:50
INT8_BYTES_RATIO = 0.3
INT8_EXPORT_REL_TOL = 1e-6  # of the largest logit; bit-equal expected
HOST_EMB = {"rows": 5_242_880, "dim": 1024, "cache_rows": 65536,
            "steps": 30, "micro": 4, "shape": (16, 64), "zipf": 1.2,
            "lr": 0.05, "head_lr": 0.01}
DFL_STEPS, DFL_LR, DFL_REL_TOL = 5, 1e-3, 1e-5  # tests/test_optimizers.py:233


def _count_types(model, name):
    return sum(1 for m in model.modules() if type(m).__name__ == name)


def _grid_hook(param, bad, calls):
    """A forward pre-hook on a ``QuantedLayer``'s inner layer: the weight
    the forward reads must be ``k * s * r`` in its dtype for an integer
    ``|k| <= 127``, with ``s`` the parameter's abs-max and ``r`` the dtype's
    1/127 (the STE's own operations, so the check is exact). Misses
    accumulate on the device in ``bad`` (no host sync); ``calls`` counts the
    forwards that read the fake-quantized weight and those that read the
    parameter itself."""
    def hook(layer, inputs):
        w = layer.weight
        if w is param:
            calls["raw"] += 1
            return
        calls["quantized"] += 1
        with torch.no_grad():
            s = param.detach().abs().amax().clamp_min(1e-8)
            r = torch.full((), 1.0 / 127.0, dtype=w.dtype, device=w.device)
            k = torch.round(w.float() / s.float() * 127.0)
            ok = torch.zeros(w.shape, dtype=torch.bool, device=w.device)
            for d in (-1.0, 0.0, 1.0):
                kk = torch.clamp(k + d, -127, 127).to(w.dtype)
                ok |= (kk * s * r) == w
            bad.add_((~ok).sum())
    return hook


def _levels_hooks(model, store):
    """Forward hooks recording each quantizer's int8 levels (its input over
    the scale it used, times 127, rounded) into ``store`` on the CPU."""
    from paddle_tpu_torch.quantization import (FakeQuantAbsMax,
                                               FakeQuantMovingAverageAbsMax)

    handles = []
    for name, m in model.named_sublayers():
        if isinstance(m, (FakeQuantAbsMax, FakeQuantMovingAverageAbsMax)):
            def hook(layer, inputs, out, name=name):
                x = inputs[0].detach()
                s = (layer.scale.clamp_min(1e-8)
                     if isinstance(layer, FakeQuantMovingAverageAbsMax)
                     else x.abs().amax().clamp_min(1e-8)).to(x.dtype)
                store[name] = torch.clamp(torch.round(x / s * 127.0),
                                          -127, 127).float().cpu()
            handles.append(m.register_forward_post_hook(hook))
    return handles


def qat_check_phase(dev, cfg=QAT_CHECK):
    """(22a) A ``layers``-deep GPT-3 1.3B at full width, bf16, QAT-wrapped,
    one train-mode forward and backward a data seed on the card and on a
    CPU copy (the plain flash versions): the loss, every gradient by
    relative norm and the quantizers' level flips, the worst over the
    seeds held against the bounds."""
    import copy

    from paddle_tpu_torch.quantization import ImperativeQuantAware

    model = train_model(layers=cfg["layers"])
    ImperativeQuantAware(quantizable_layer_type=QAT_TYPES).quantize(model)
    cpu = copy.deepcopy(model).to(device="cpu")
    by_seed = []
    flips = {"act": [0, 0, 0.0], "weight": [0, 0, 0.0]}
    for seed in cfg["seeds"]:
        ids, labels = train_arrays(model.config, cfg["batch"], cfg["seq"],
                                   seed)
        levels, losses, grads = {}, {}, {}
        for tag, m, d in (("card", model, dev), ("cpu", cpu, "cpu")):
            store = levels.setdefault(tag, {})
            handles = _levels_hooks(m, store)
            for p in m.parameters():
                p.grad = None
            loss = m.loss(torch.from_numpy(ids).to(d),
                          torch.from_numpy(labels).to(d))
            loss.backward()
            for h in handles:
                h.remove()
            losses[tag] = loss.item()
            grads[tag] = {n: p.grad.detach().float().cpu()
                          for n, p in m.named_parameters()}
        for name, a in levels["card"].items():
            b = levels["cpu"][name]
            kind = "weight" if name.endswith("weight_quantizer") else "act"
            diff = (a - b).abs()
            flips[kind][0] += int((diff > 0).sum())
            flips[kind][1] += a.numel()
            flips[kind][2] = max(flips[kind][2], float(diff.max()))
        worst = max(_rel_norm(grads["card"][n], grads["cpu"][n])
                    for n in grads["cpu"])
        rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
        by_seed.append({"seed": seed, "loss_card": losses["card"],
                        "loss_cpu": losses["cpu"], "loss_rel": rel,
                        "grad_worst_rel_norm": worst})
    rel = max(r["loss_rel"] for r in by_seed)
    worst = max(r["grad_worst_rel_norm"] for r in by_seed)
    out = {"layers": cfg["layers"], "batch": cfg["batch"], "seq": cfg["seq"],
           "by_seed": by_seed, "loss_rel": rel, "grad_worst_rel_norm": worst,
           "loss_rel_tol": QAT_LOSS_REL_TOL,
           "grad_rel_tol": QAT_GRAD_REL_TOL,
           "act_level_flips": flips["act"][:2],
           "act_level_max_step": flips["act"][2],
           "weight_level_flips": flips["weight"][:2]}
    rels = ", ".join(f"{r['loss_rel']:.3e}" for r in by_seed)
    worsts = ", ".join(f"{r['grad_worst_rel_norm']:.3e}" for r in by_seed)
    print(f"  22a check ({cfg['layers']} layers, b{cfg['batch']}x"
          f"s{cfg['seq']}, card against the CPU, data seeds "
          f"{list(cfg['seeds'])}): loss rel {rels} (bound "
          f"{QAT_LOSS_REL_TOL:.0e}), worst gradient by relative norm "
          f"{worsts} (bound {QAT_GRAD_REL_TOL}); activation level flips "
          f"{flips['act'][0]} of {flips['act'][1]} (at most "
          f"{flips['act'][2]:.0f} level), weight level flips "
          f"{flips['weight'][0]} of {flips['weight'][1]}")
    if flips["weight"][0] or rel > QAT_LOSS_REL_TOL \
            or worst > QAT_GRAD_REL_TOL or not math.isfinite(worst):
        fail(f"22a check: {out}")
    del model, cpu
    return out


def qat_phase(dev="cuda", cfg=None, B=2, T=2048):
    """(22a) GPT-3 1.3B bf16 at full width: the unquantized step timed,
    then the 96 mp linears wrapped by ``ImperativeQuantAware``, 5 steps
    through ``compile_train_step`` (the traced branch: every moving
    average untouched), 2 eager steps (the moving-average branch), every
    read weight on its int8 grid, the flash launches a step, then the
    quantized step timed."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import kernels as K
    from paddle_tpu_torch.quantization import (FakeQuantMovingAverageAbsMax,
                                               ImperativeQuantAware,
                                               QuantedLayer)

    card = torch.device(dev).type == "cuda"
    t0 = time.monotonic()
    if cfg is None:
        model = train_model()
    else:
        from paddle_tpu_torch.models import GPTForPretraining

        model = GPTForPretraining(cfg, device=dev, seed=0).train()
    cfg = model.config
    L = cfg.num_layers
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=g).to(dev)
    labels = torch.randint(0, cfg.vocab_size, (B, T), generator=g).to(dev)
    loss_fn = lambda m, i, l: m.loss(i, l)  # noqa: E731

    def timed(step, n):
        _sync(dev)
        t = time.perf_counter()
        for _ in range(n):
            step(ids, labels)
        _sync(dev)
        return (time.perf_counter() - t) / n * 1e3

    opt = pt.optimizer.AdamW(learning_rate=QAT_LR,
                             parameters=model.named_parameters())
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    timed(step, QAT_WARMUP)
    out = {"plain_step_ms": timed(step, QAT_TIMED)}
    del step, opt
    ImperativeQuantAware(quantizable_layer_type=QAT_TYPES).quantize(model)
    out["wrapped"] = _count_types(model, "QuantedLayer")
    if out["wrapped"] != 4 * L:
        fail(f"22a: {out['wrapped']} QuantedLayers, want {4 * L}")
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    calls = {"quantized": 0, "raw": 0}
    hooks = [m.inner.register_forward_pre_hook(
        _grid_hook(m.inner.weight, bad, calls))
        for m in model.modules() if isinstance(m, QuantedLayer)]
    opt = pt.optimizer.AdamW(learning_rate=QAT_LR,
                             parameters=model.named_parameters())
    step = pt.jit.compile_train_step(model, loss_fn, opt)
    acts = [m for m in model.modules()
            if isinstance(m, FakeQuantMovingAverageAbsMax)]
    flash = ("flash_attention_fwd", "flash_attention_dq",
             "flash_attention_dkv")
    K.reset_launch_counts()
    losses = [step(ids, labels) for _ in range(QAT_COMPILED)]
    counts = K.launch_counts()
    out["launches"] = {k: {"compiled": counts.get(k, 0)} for k in flash}
    untouched = all(float(a.scale) == 1.0 and not a._initialized
                    for a in acts)
    K.reset_launch_counts()
    for _ in range(QAT_EAGER):
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    counts = K.launch_counts()
    for k in flash:
        out["launches"][k]["eager"] = counts.get(k, 0)
    scales = [float(a.scale) for a in acts]
    for h in hooks:
        h.remove()
    vals = [x.item() for x in losses]
    out.update(losses=vals, grid_misses=int(bad), grid_calls=dict(calls),
               ema_untouched_by_compiled=untouched,
               ema_scales=[min(scales), max(scales)],
               qat_step_ms=timed(step, QAT_TIMED))
    if card:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    n_fwd = (QAT_COMPILED + QAT_EAGER) * 4 * L
    print(f"  22a: GPT-3 1.3B QAT ({out['wrapped']} QuantedLayers), "
          f"{QAT_COMPILED} compiled + {QAT_EAGER} eager steps at b{B}xs{T}: "
          f"losses {[round(v, 4) for v in vals]}; grid misses "
          f"{out['grid_misses']} over {calls['quantized']} reads "
          f"({calls['raw']} unquantized); moving averages untouched by the "
          f"compiled steps {untouched}, after the eager steps "
          f"{min(scales):.4f}..{max(scales):.4f}; flash launches "
          f"{out['launches']}; step {out['qat_step_ms']:.2f} ms against "
          f"{out['plain_step_ms']:.2f} ms unquantized (host clock, "
          f"{QAT_TIMED} steps each)"
          + (f", phase 5's {QI['phase5_step_ms']:.2f} ms" if
             "phase5_step_ms" in QI else "")
          + f" in {time.monotonic() - t0:.1f} s")
    if out["grid_misses"] or calls["raw"] or calls["quantized"] != n_fwd:
        fail(f"22a: grid misses {out['grid_misses']}, reads {calls} "
             f"(want {n_fwd} quantized)")
    if not untouched or not all(math.isfinite(s) and s > 0 and s != 1.0
                                for s in scales):
        fail(f"22a: moving averages: untouched {untouched}, scales "
             f"{scales[:4]}...")
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        fail(f"22a: losses {vals}")
    want = {"compiled": L * QAT_COMPILED, "eager": L * QAT_EAGER}
    if card and any(v != want for v in out["launches"].values()):
        fail(f"22a: flash launches {out['launches']}, want {want} each")
    del step, opt, model, hooks
    return out


def int8_cpu_saved_check(dev, tmp):
    """(22b) An int8 net with ResNet-50's stem (a 7x7 stride-2 convolution
    of 3 channels: K = 147) and a 10-class head (N = 10), calibrated,
    converted and saved on the CPU with a None batch, run by the card's
    Predictor at batches 3 and 40 (M off the card's rules) against the
    CPU's eager int8 model."""
    from paddle_tpu_torch import inference, nn, static
    from paddle_tpu_torch.quantization import (PostTrainingQuantization,
                                               convert_to_int8_inference)
    from paddle_tpu_torch.static import InputSpec

    g = torch.Generator().manual_seed(5)
    kw = {"device": "cpu", "generator": g}
    net = nn.Sequential(
        nn.Conv2D(3, 64, 7, stride=2, padding=3, **kw), nn.ReLU(),
        nn.AdaptiveAvgPool2D(1), nn.Flatten(), nn.Linear(64, 10, **kw)).eval()
    calib = [(torch.randn(4, 3, 32, 32, generator=g),) for _ in range(2)]
    ptq = PostTrainingQuantization(net, data_loader=calib, batch_nums=2,
                                   algo="abs_max")
    ptq.quantize()
    convert_to_int8_inference(net, ptq)
    prefix = os.path.join(tmp, "int8_cpu_saved")
    static.save_inference_model(
        prefix, [InputSpec([None, 3, 32, 32], "float32", "image")], net)
    pred = inference.create_predictor(_predictor_config(prefix, dev))
    errs = {}
    for b in (3, 40):
        x = torch.randn(b, 3, 32, 32, generator=g)
        with torch.no_grad():
            want = net(x)
        h = pred.get_input_handle(pred.get_input_names()[0])
        h.share_external_data(x.to(dev))
        pred.run()
        got = pred.output_tensors()[0].cpu()
        errs[b] = float((got - want).abs().max()) / float(want.abs().max())
    print(f"  22b: an int8 net with ResNet-50's stem saved on the CPU, run "
          f"by the {dev} Predictor: {errs} of the largest logit from the "
          f"CPU's eager int8 model")
    if any(not e <= INT8_EXPORT_REL_TOL for e in errs.values()):
        fail(f"22b: the CPU-saved int8 program on {dev}: {errs}")
    return {"rel_err_by_batch": errs}


def int8_resnet_phase(dev, tmp, cfg=INT8_RESNET):
    """(22b) ResNet-50 f32: PTQ (abs_max) over ``calib`` synthetic
    batches, ``convert_to_int8_inference``, the float and int8 artifacts
    through ``static.save_inference_model`` with a None batch, the int8
    one through the Predictor and the C API against the eager int8 model,
    the drift from the float model and the artifacts' bytes."""
    import ctypes

    from paddle_tpu_torch import inference, jit, static
    from paddle_tpu_torch.framework import io as fio
    from paddle_tpu_torch.inference import capi
    from paddle_tpu_torch.quantization import (PostTrainingQuantization,
                                               convert_to_int8_inference)
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.vision.models import resnet50

    card = torch.device(dev).type == "cuda"
    B, S, C = cfg["batch"], cfg["size"], cfg["classes"]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    g = torch.Generator(dev).manual_seed(0)
    net = resnet50(num_classes=C, device=dev, generator=g).eval()
    spec = [InputSpec([None, 3, S, S], "float32", "image")]
    gx = torch.Generator(dev).manual_seed(22)
    calib = [(torch.randn(B, 3, S, S, generator=gx, device=dev),)
             for _ in range(cfg["calib"])]
    x = torch.randn(B, 3, S, S, generator=gx, device=dev)
    out = {}

    def forward():
        with torch.no_grad():
            return net(x)

    with torch.no_grad():
        float_logits = net(x)
    if card:
        out["float_ms"] = time_ms(forward, iters=cfg["runs"])
    # the float artifact's weights file, written as jit.save writes
    # .pdiparams (its program export is phase 21c's and is not repeated)
    prefix_f = os.path.join(tmp, "resnet50_f32")
    fio.save({"state": net.state_dict(),
              "specs": [([None, 3, S, S], "float32", "image")]},
             prefix_f + ".pdiparams")
    out["float_bytes"] = _artifact_bytes(prefix_f)
    ptq = PostTrainingQuantization(net, data_loader=calib,
                                   batch_nums=cfg["calib"], algo="abs_max")
    ptq.quantize()
    with torch.no_grad():
        ptq_logits = net(x)
    convert_to_int8_inference(net, ptq)
    out["int8_conv"] = _count_types(net, "Int8Conv2D")
    out["int8_linear"] = _count_types(net, "Int8Linear")
    with torch.no_grad():
        int8_logits = net(x)
    scale = float(ptq_logits.abs().max())
    out["drift"] = float((int8_logits - ptq_logits).abs().max()) / scale
    out["drift_from_float"] = float(
        (int8_logits - float_logits).abs().max()) / float(
        float_logits.abs().max())
    if card:
        out["int8_ms"] = time_ms(forward, iters=cfg["runs"])
    prefix = os.path.join(tmp, "resnet50_int8")
    t0 = time.monotonic()
    static.save_inference_model(prefix, spec, net)
    out["save_s"] = time.monotonic() - t0
    out["bytes"] = _artifact_bytes(prefix)
    _, meta = jit.read_program(prefix + ".pdmodel")
    out["dynamic_batch"] = meta["dynamic"]
    if not meta["dynamic"]:
        fail("22b: the int8 artifact's batch is not symbolic")
    params = fio.load(prefix + ".pdiparams", return_numpy=True)
    int8_leaves = sum(1 for k, v in params["state"].items()
                      if k.endswith("weight_q") and v.dtype == np.int8)
    out["pdiparams_ratio"] = (out["bytes"][".pdiparams"]
                              / out["float_bytes"][".pdiparams"])
    pred = inference.create_predictor(_predictor_config(prefix, dev))
    h = pred.get_input_handle(pred.get_input_names()[0])
    h.share_external_data(x)
    pred.run()
    got = pred.output_tensors()[0]
    out["predictor_max_abs_err"] = float((got - int8_logits).abs().max())
    out["predictor_bit_equal"] = bool(torch.equal(got, int8_logits))
    if card:
        out["predictor_ms"] = time_ms(pred.run, iters=cfg["runs"])
    L = capi.lib()
    d = torch.device(dev)
    p = L.PD_PredictorCreate(prefix.encode()) \
        if d.type == "cuda" and not d.index else \
        L.PD_PredictorCreateOnDevice(prefix.encode(), str(dev).encode())
    if not p:
        fail(f"22b: PD_PredictorCreate: {L.PD_LastError().decode()}")
    name_in = L.PD_PredictorInputName(p, 0)
    name_out = L.PD_PredictorOutputName(p, 0)
    xs = np.ascontiguousarray(x.cpu().numpy())
    shape = (ctypes.c_int64 * 4)(B, 3, S, S)
    n = B * C
    buf = (ctypes.c_float * n)()
    if L.PD_PredictorSetInputFloat(
            p, name_in, xs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            shape, 4) or L.PD_PredictorRun(p) \
            or L.PD_PredictorOutputNumel(p, name_out) != n \
            or L.PD_PredictorGetOutputFloat(p, name_out, buf, n):
        fail(f"22b: C API: {L.PD_LastError().decode()}")
    L.PD_PredictorDestroy(p)
    want = int8_logits.cpu().numpy()
    capi_out = np.frombuffer(buf, np.float32).reshape(B, C)
    out["capi_max_abs_err"] = float(np.abs(capi_out - want).max())
    out["capi_bit_equal"] = bool(np.array_equal(capi_out, want))
    torch.backends.cudnn.deterministic = det
    out["cpu_saved"] = int8_cpu_saved_check(dev, tmp)
    print(f"  22b: ResNet-50 b{B}x{S}² int8 ({out['int8_conv']} Int8Conv2D, "
          f"{out['int8_linear']} Int8Linear): drift {out['drift']:.4f} from "
          f"the PTQ float model ({out['drift_from_float']:.4f} from the "
          f"unquantized one); Predictor {out['predictor_max_abs_err']:.3e} "
          f"(bit-equal {out['predictor_bit_equal']}), C API "
          f"{out['capi_max_abs_err']:.3e} (bit-equal "
          f"{out['capi_bit_equal']}) from eager int8; .pdiparams "
          f"{out['bytes']['.pdiparams']} B = {out['pdiparams_ratio']:.3f} of "
          f"the float artifact's ({int8_leaves} int8 weights); "
          + (f"{out['float_ms']:.2f} ms a batch float, {out['int8_ms']:.2f} "
             f"int8 eager, {out['predictor_ms']:.2f} int8 Predictor; "
             if card else "") + f"save {out['save_s']:.1f} s")
    tol = INT8_EXPORT_REL_TOL * float(np.abs(want).max())
    if out["int8_conv"] != 53 or out["int8_linear"] != 1:
        fail(f"22b: swapped {out['int8_conv']} Int8Conv2D and "
             f"{out['int8_linear']} Int8Linear, want 53 and 1")
    if int8_leaves != out["int8_conv"] + out["int8_linear"] \
            or not out["dynamic_batch"]:
        fail(f"22b: {int8_leaves} int8 weights in .pdiparams, dynamic "
             f"{out['dynamic_batch']}")
    if out["drift"] > INT8_DRIFT_TOL \
            or out["pdiparams_ratio"] > INT8_BYTES_RATIO \
            or out["predictor_max_abs_err"] > tol \
            or out["capi_max_abs_err"] > tol:
        fail(f"22b: {out}")
    return out


def host_embedding_run(dev, tmp, cfg, batches, replay):
    """One 22c run over ``batches`` (steps of micro-batches): the cached,
    prefetched, async-push table, or (``replay``) the numpy path with no
    cache and no thread. Returns (layer, losses, ms a step)."""
    from paddle_tpu_torch import nn, optimizer, profiler
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.incubate import HostEmbedding

    set_flags({"FLAGS_host_emb_native": not replay,
               "FLAGS_host_emb_async_push": not replay})
    emb = HostEmbedding(cfg["rows"], cfg["dim"], optimizer="sgd", seed=1,
                        path=os.path.join(tmp, "replay.npy" if replay
                                          else "table.npy"),
                        cache_rows=0 if replay else cfg["cache_rows"],
                        device=dev)
    head = nn.Linear(cfg["dim"], 1, device=dev,
                     generator=torch.Generator(dev).manual_seed(3))
    opt = optimizer.SGD(cfg["head_lr"], parameters=head.parameters())
    target = torch.full(cfg["shape"] + (1,), 0.5, device=dev)
    losses = []
    c0 = profiler.counters().get("host_emb_prefetch_hits", 0)
    it = batches if replay else emb.prefetch_iter(batches)
    for k, step in enumerate(it):
        for mb in step:
            loss = ((head(emb(mb)) - target) ** 2).mean()
            loss.backward()
            losses.append(loss.detach())
        emb.apply_gradients(cfg["lr"])
        opt.step()
        opt.clear_grad()
        if k == 0:  # the first step's lazy set-up is not timed
            emb.sync()
            _sync(dev)
            t0 = time.perf_counter()
    emb.sync()
    _sync(dev)
    ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
    hits = profiler.counters().get("host_emb_prefetch_hits", 0) - c0
    set_flags({"FLAGS_host_emb_native": True,
               "FLAGS_host_emb_async_push": False})
    return emb, [v.item() for v in losses], ms, hits


def host_embedding_phase(dev, tmp, cfg=HOST_EMB):
    """(22c) The host embedding at the reference's 20 GiB logical size in a
    sparse memmap: ``steps`` steps of ``micro`` Zipf micro-batches into a
    Linear head, through the device hot-row cache, ``prefetch_iter`` and
    the async push; then a replay on the numpy path with no cache and no
    thread, whose touched rows must be bit-equal."""
    rng = np.random.RandomState(22)
    n, m, shape = cfg["steps"], cfg["micro"], cfg["shape"]
    ids = (rng.zipf(cfg["zipf"], (n, m) + shape) - 1) % cfg["rows"]
    batches = [[ids[s, k] for k in range(m)] for s in range(n)]
    emb, losses, ms, hits = host_embedding_run(dev, tmp, cfg, batches,
                                               False)
    stats = emb.cache.stats()
    touched = np.unique(ids)
    physical = emb.table.state_nbytes_physical()
    logical = emb.table.table.nbytes
    ref, ref_losses, ref_ms, _ = host_embedding_run(dev, tmp, cfg, batches,
                                                    True)
    got, want = emb.table.table[touched], ref.table.table[touched]
    equal = bool(np.array_equal(got, want))
    out = {"logical_gib": logical / 2**30, "physical_bytes": physical,
           "touched_rows": int(touched.size), "step_ms": ms,
           "replay_step_ms": ref_ms, "cache": stats,
           "prefetch_hits": hits, "forwards": n * m,
           "rows_bit_equal": equal,
           "rows_max_abs_diff": float(np.abs(got - want).max()),
           "losses_equal": losses == ref_losses,
           "loss_first_last": [losses[0], losses[-1]]}
    print(f"  22c: {logical / 2**30:.1f} GiB logical table, "
          f"{physical / 2**20:.1f} MiB physical, {touched.size} rows "
          f"touched; {ms:.2f} ms a step (steps 2-{n}; {m} micro-batches of "
          f"{shape[0]}x{shape[1]}) cached + prefetched + async push against "
          f"{ref_ms:.2f} ms on the numpy replay; cache hit rate "
          f"{stats['hit_rate']:.3f} ({stats['occupied_rows']} of "
          f"{stats['capacity_rows']} rows); prefetch hits {hits} of "
          f"{n * m}; touched rows bit-equal to the replay {equal} (max "
          f"{out['rows_max_abs_diff']:.3e}), losses equal "
          f"{out['losses_equal']}; loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    if not equal or hits != n * m or physical >= 2**30 \
            or not losses[-1] < losses[0]:
        fail(f"22c: {out}")
    del emb, ref
    return out


def dfl_phase(dev, ecfg=None, B=ERNIE_B, T=ERNIE_T, steps=DFL_STEPS):
    """(22d) ERNIE-3.0 base f32 (dropout 0), ``DistributedFusedLamb`` with
    ``max_global_grad_norm=0`` against the port's ``Lamb`` on the same
    weights and data: the losses, and the optimizer step's ms."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.incubate import DistributedFusedLamb
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base

    cfg = ecfg or ernie_3_base(hidden_dropout=0.0, attention_dropout=0.0)
    np_ids, np_labels, np_nsp = ernie_arrays(cfg.vocab_size, B, T)
    ids, labels, nsp = (torch.from_numpy(a).to(dev)
                        for a in (np_ids, np_labels, np_nsp))
    res = {}
    for tag in ("lamb", "dfl"):
        model = ErnieForPretraining(cfg, seed=0, device=dev).train()
        kw = dict(learning_rate=DFL_LR, lamb_weight_decay=0.01,
                  parameters=model.parameters(),
                  exclude_from_weight_decay_fn=ln_excluder(model))
        opt = optimizer.Lamb(**kw) if tag == "lamb" \
            else DistributedFusedLamb(max_global_grad_norm=0.0, **kw)
        losses, ms = [], []
        for _ in range(steps):
            loss = model.loss(ids, labels, nsp)
            loss.backward()
            losses.append(loss.detach())
            if torch.device(dev).type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                opt.step()
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            else:
                opt.step()
            opt.clear_grad()
        res[tag] = ([v.item() for v in losses],
                    sorted(ms[1:])[len(ms[1:]) // 2] if ms else None)
        del model, opt
    (l1, ms1), (l2, ms2) = res["lamb"], res["dfl"]
    rel = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
    out = {"losses_lamb": l1, "losses_dfl": l2, "max_rel": rel,
           "bit_equal": l1 == l2, "lamb_step_ms": ms1, "dfl_step_ms": ms2}
    print(f"  22d: ERNIE-3.0 base, {steps} steps: DistributedFusedLamb "
          f"{[round(v, 6) for v in l2]} against Lamb "
          f"{[round(v, 6) for v in l1]} ({rel:.3e} rel, bit-equal "
          f"{l1 == l2}); optimizer step "
          + (f"{ms2:.2f} ms against Lamb's {ms1:.2f} ms (median of steps "
             f"2-{steps})" if ms1 is not None else "not timed"))
    if rel > DFL_REL_TOL:
        fail(f"22d: {out}")
    return out


def incubate_rest_phase(dev, ecfg=None):
    """(22e) The rest at small sizes, the card against the CPU port on the
    same inputs: the fused softmaxes, ``graph_send_recv`` (4 pools),
    ``ResNetUnit``, the three fused layers, ASP 2:4 on ERNIE's Linears
    under a decorated SGD, a custom op with a vjp, and LookAhead and
    ModelAverage round trips."""
    import copy

    from paddle_tpu_torch import incubate, optimizer
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.incubate import nn as inn
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base
    from paddle_tpu_torch.nn import Linear

    rng = np.random.RandomState(5)
    errs = {}

    def both(name, fn, *arrays, grad=False):
        outs = []
        for d in ("cpu", dev):
            ts = [torch.tensor(a, device=d) for a in arrays]
            if grad:
                ts[0].requires_grad_(True)
            y = fn(*ts)
            row = [y.detach().float().cpu()]
            if grad:
                y.float().square().sum().backward()
                row.append(ts[0].grad.float().cpu())
            outs.append(row)
        errs[name] = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(outs[1], outs[0]))

    x = rng.randn(4, 8, 128, 128).astype(np.float32)
    both("softmax_mask_fuse", incubate.softmax_mask_fuse, x,
         (rng.rand(4, 1, 128, 128) < 0.2).astype(np.float32) * -1e4,
         grad=True)
    both("softmax_mask_fuse_upper_triangle",
         incubate.softmax_mask_fuse_upper_triangle, x, grad=True)
    feats = rng.randn(1000, 64).astype(np.float32)
    src = rng.randint(0, 1000, 5000)
    dst = rng.randint(0, 900, 5000)
    for pool in ("sum", "mean", "max", "min"):
        both(f"graph_send_recv_{pool}",
             lambda f, s, t, pool=pool: incubate.graph_send_recv(
                 f, s, t, pool), feats, src, dst,
             grad=pool in ("sum", "mean"))
    layers = {
        "ResNetUnit": (incubate.ResNetUnit(64, 64, 3, has_shortcut=True,
                                           num_channels_z=64, device="cpu"),
                       rng.randn(8, 64, 56, 56).astype(np.float32)),
        "FusedMultiHeadAttention": (inn.FusedMultiHeadAttention(
            768, 12, 0.0, 0.0, device="cpu"),
            rng.randn(4, 128, 768).astype(np.float32)),
        "FusedFeedForward": (inn.FusedFeedForward(
            768, 3072, 0.0, device="cpu"),
            rng.randn(4, 128, 768).astype(np.float32)),
        "FusedTransformerEncoderLayer": (inn.FusedTransformerEncoderLayer(
            768, 12, 3072, 0.0, device="cpu"),
            rng.randn(4, 128, 768).astype(np.float32)),
    }
    for name, (layer, inp) in layers.items():
        card_layer = copy.deepcopy(layer).to(device=dev)
        outs = []
        for m, d in ((layer, "cpu"), (card_layer, dev)):
            m.train()
            t = torch.tensor(inp, device=d, requires_grad=True)
            y = m(t, t) if name == "ResNetUnit" else m(t)
            # a fixed random projection: sum(y^2) would give a final
            # LayerNorm's input a gradient of 0 (rounding noise only)
            r = torch.tensor(np.random.RandomState(9).randn(*y.shape)
                             .astype(np.float32), device=d)
            (y * r).sum().backward()
            outs.append([y.detach().cpu(), t.grad.cpu()])
        errs[name] = max(float((a - b).abs().max() / b.abs().max())
                         for a, b in zip(outs[1], outs[0]))
    # ASP 2:4 on ERNIE's Linears (its mp linears too), three decorated SGD
    # steps
    ecfg = ecfg or ernie_3_base(hidden_dropout=0.0, attention_dropout=0.0)
    ernie = ErnieForPretraining(ecfg, seed=1, device=dev).train()
    kinds = ("Linear", "ColumnParallelLinear", "RowParallelLinear")
    asp.prune_model(ernie, n=2, m=4, supported_types=kinds)
    lin = [m.weight for m in ernie.modules() if type(m).__name__ in kinds]
    opt = asp.decorate(optimizer.SGD(0.1, parameters=ernie.parameters()))
    e_ids, e_labels, e_nsp = (torch.from_numpy(a).to(dev) for a in
                              ernie_arrays(ecfg.vocab_size, B=2, T=128))
    for _ in range(3):
        ernie.loss(e_ids, e_labels, e_nsp).backward()
        opt.step()
        opt.clear_grad()
    asp_ok = all(asp.check_mask_nm(w, 2, 4) for w in lin)
    asp_zero = float(np.mean([float((w == 0).float().mean()) for w in lin]))
    del ernie, opt
    # a custom op with a hand-written vjp (deliberately not the true one)
    op = incubate.register_custom_op(
        "qi_cube", lambda a: a * a * a,
        vjp=(lambda a: (a * a * a, a), lambda a, gr: (gr * 7.0,)))
    t = torch.full((16,), 2.0, device=dev, requires_grad=True)
    op(t).sum().backward()
    vjp_ok = bool(torch.equal(t.grad, torch.full_like(t, 7.0)))
    # LookAhead: the first sync lands at w0 + alpha (w_k - w0)
    X = torch.tensor(rng.randn(32, 6).astype(np.float32), device=dev)
    Y = X @ torch.tensor(rng.randn(6, 1).astype(np.float32), device=dev)

    def fit(make, steps):
        m = Linear(6, 1, device=dev,
                   generator=torch.Generator(dev).manual_seed(6))
        w0 = m.weight.detach().clone()
        o = make(m)
        for _ in range(steps):
            ((m(X) - Y) ** 2).mean().backward()
            o.step()
            o.clear_grad()
        return m, o, w0

    m_k, _, _ = fit(lambda m: optimizer.SGD(0.05,
                                            parameters=m.parameters()), 3)
    m_la, la, w0 = fit(lambda m: incubate.LookAhead(
        optimizer.SGD(0.05, parameters=m.parameters()), alpha=0.5, k=3), 3)
    want = w0 + 0.5 * (m_k.weight.detach() - w0)
    la_err = float((m_la.weight.detach() - want).abs().max())
    sd = la.state_dict()
    la2 = incubate.LookAhead(optimizer.SGD(0.05,
                                           parameters=m_la.parameters()),
                             alpha=0.5, k=3)
    la2.set_state_dict(sd)
    la_rt = la2._step_count == la._step_count and all(
        torch.equal(la2._slow[k], v) for k, v in la._slow.items())
    # ModelAverage: apply swaps the average in, restore the exact weights
    m_ma, o_ma, _ = fit(lambda m: optimizer.SGD(0.1,
                                                parameters=m.parameters()), 0)
    ma = incubate.ModelAverage(0.15, parameters=m_ma.parameters(),
                               min_average_window=10, max_average_window=10)
    seen = []
    for _ in range(4):
        ((m_ma(X) - Y) ** 2).mean().backward()
        o_ma.step()
        o_ma.clear_grad()
        ma.step()
        seen.append(m_ma.weight.detach().clone())
    before = m_ma.weight.detach().clone()
    ma.apply()
    avg_err = float((m_ma.weight.detach() - torch.stack(seen).mean(0))
                    .abs().max())
    ma.restore()
    ma_rt = bool(torch.equal(m_ma.weight.detach(), before))
    out = {"card_vs_cpu_rel": errs, "asp_mask_holds": asp_ok,
           "asp_zero_share": asp_zero, "custom_vjp": vjp_ok,
           "lookahead_sync_err": la_err, "lookahead_state_roundtrip": la_rt,
           "model_average_err": avg_err, "model_average_restored": ma_rt}
    print(f"  22e: card against the CPU (rel. to the largest value): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; ASP 2:4 on {len(lin)} ERNIE Linears holds after 3 steps "
          f"{asp_ok} ({asp_zero:.3f} zero); custom vjp {vjp_ok}; LookAhead "
          f"sync {la_err:.2e} from w0 + a(w_k - w0), state round trip "
          f"{la_rt}; ModelAverage {avg_err:.2e} from the mean, restored "
          f"{ma_rt}")
    if max(errs.values()) > 1e-4 or not (asp_ok and vjp_ok and la_rt
                                          and ma_rt) \
            or la_err > 1e-6 or avg_err > 1e-6:
        fail(f"22e: {out}")
    return out


def quant_incubate_phase(card, dev="cuda", cfgs=None):
    """Phase 22: 22a-e; the results go on the ``quant_incubate`` line.
    ``cfgs`` (GPT config, batch, length, check dict, ResNet dict, host
    embedding dict, (ERNIE config, batch, length)) cut the sizes for a
    rehearsal on the CPU."""
    import gc

    t0 = time.monotonic()
    gpt, B, T, check, rn, he, ernie = cfgs or (
        None, 2, 2048, QAT_CHECK, INT8_RESNET, HOST_EMB,
        (None, ERNIE_B, ERNIE_T))
    on_card = torch.device(dev).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_quant_")
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        QI["card"] = card
        QI["22a"] = qat_phase(dev, gpt, B, T)
        if on_card:
            QI["22a"]["check"] = qat_check_phase(dev, check)
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        QI["22b"] = int8_resnet_phase(dev, tmp, rn)
        gc.collect()
        QI["22c"] = host_embedding_phase(dev, tmp, he)
        shutil.rmtree(tmp)
        os.makedirs(tmp)
        QI["22d"] = dfl_phase(dev, *ernie)
        QI["22e"] = incubate_rest_phase(dev, ernie[0])
        if on_card:
            QI["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    QI["seconds"] = time.monotonic() - t0
    print(f"  (22) {QI['seconds']:.1f} s, peak "
          f"{QI.get('peak_gib', 0.0):.2f} GiB")


TEXT = {}  # phase 23's results: the {"text_data": ...} line
TEXT_VOCAB = 40000  # ERNIE-3.0 base's vocabulary
TEXT_DOCS, TEXT_T, TEXT_TAGS = 64, 512, 27
# the documents that carry the code points the reference's two tokenizer
# backends split differently (U+3000, U+2003, U+00A0, U+0085)
TEXT_DIVERGENT = tuple(range(3, TEXT_DOCS, 8))
TEXT_WS = ("\u3000", "\u2003", "\xa0", "\x85")
TEXT_SCORE_RTOL = 1e-6
V1_PAD, V1_BATCH, V1_LR = 160, 32, 5e-5
V1_LOADER_STEPS = 4


def _letters(rng, lo, hi):
    return "".join(chr(97 + c) for c in rng.randint(0, 26, rng.randint(lo,
                                                                      hi)))


def text_vocab(path, n=TEXT_VOCAB, seed=0):
    """A synthetic ``n``-line WordPiece vocab from ``seed``, written to
    ``path``: the special tokens, punctuation, 3000 CJK ideographs, ASCII
    words and ``##`` continuations (one token a line, ids dense)."""
    rng = np.random.RandomState(seed)
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    toks += list("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
    toks += ["\u3001", "\u3002", "\uff0c", "\uff01", "\u2014", "\u2026"]
    toks += [chr(0x4E00 + i) for i in range(3000)]
    toks += ["café", "naïve", "über", "señor"]
    seen = set(toks)
    while len(toks) < n:
        w = _letters(rng, 1, 9)
        if rng.rand() < 0.3:
            w = "##" + w[:4]
        if w not in seen:
            seen.add(w)
            toks.append(w)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(toks) + "\n")
    return toks


def text_docs(words, n=TEXT_DOCS, seed=1):
    """``n`` documents of 200-2000 characters from ``seed``: words (some
    upper case, some unknown), accented words, CJK runs, punctuation,
    control characters, tabs and newlines; the ``TEXT_DIVERGENT`` ones also
    carry ``TEXT_WS``' code points."""
    rng = np.random.RandomState(seed)
    accented = ["Café", "naïve", "ÜBER", "señor",
                "résumé"]
    punct = list(",.!?;:()\"'-") + ["\u3001", "\u3002", "\uff0c"]
    docs = []
    for d in range(n):
        want = int(rng.randint(200, 2001))
        parts, size = [], 0
        while size < want:
            k = rng.randint(0, 10)
            if k <= 4:
                w = words[rng.randint(len(words))]
                p = w.upper() if k == 0 else w.capitalize() if k == 1 else w
            elif k == 5:
                p = "".join(chr(0x4E00 + int(i))
                            for i in rng.randint(0, 3200, rng.randint(1, 6)))
            elif k == 6:
                p = accented[rng.randint(len(accented))]
            elif k == 7:
                p = punct[rng.randint(len(punct))]
            elif k == 8:
                p = str(rng.choice(["\t", "\n", "\x01x", "\x7f", "\r\n"]))
            else:
                p = _letters(rng, 2, 12)
            if d in TEXT_DIVERGENT and rng.rand() < 0.25:
                p += TEXT_WS[rng.randint(len(TEXT_WS))]
            parts.append(p)
            size += len(p) + 1
        docs.append(" ".join(parts)[:want])
    return docs


def _space_split_ids(tok, text):
    """The C++ backend's rule in Python: the twin's cleaning, then a split
    on the space alone (tab, newline and CR are spaces already); the only
    place the reference's two backends differ."""
    from paddle_tpu_torch.text.faster_tokenizer import (_is_cjk, _is_punct,
                                                        _wordpiece)

    text = text.split("\x00", 1)[0]
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or (
                (cp < 0x20 or cp == 0x7F) and ch not in "\t\n\r"):
            continue
        if ch in " \t\n\r":
            out.append(" ")
            continue
        if tok.do_lower_case and "A" <= ch <= "Z":
            ch = ch.lower()
            cp = ord(ch)
        out.append(f" {ch} " if _is_cjk(cp) or _is_punct(cp) else ch)
    return [i for w in "".join(out).split(" ") if w
            for i in _wordpiece(w, tok.vocab, tok._unk)]


def _events_ms(fn, dev, iters=5):
    """Device ms a call of ``fn`` by CUDA events (``time_ms``; the host
    clock on the CPU), and its output."""
    out = fn()
    if torch.device(dev).type == "cuda":
        return time_ms(fn, iters), out
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3, out


def text_tag_phase(model, dev, tmp, T=TEXT_T, docs_n=TEXT_DOCS):
    """(23a) Text to tags at full width: ``FasterTokenizer`` on a 40000-line
    vocab (native; the twin beside it), ERNIE-3.0 base's encoder and a
    768 -> 27 tag head, ``text.viterbi_decode`` on the card against the
    CPU."""
    from paddle_tpu_torch import text
    from paddle_tpu_torch.nn import Linear

    vocab_path = os.path.join(tmp, "vocab.txt")
    toks = text_vocab(vocab_path)
    words = [w for w in toks if w.isascii() and w.isalpha()]
    docs = text_docs(words, docs_n)
    tok = text.FasterTokenizer(vocab_path, device=dev)
    if not tok.is_native:
        fail("23a: FasterTokenizer took the twin on a dense vocab")
    twin = text.FasterTokenizer(vocab_path, device=dev)
    twin._handle = None  # the Python twin
    pairs = [docs[i ^ 1] for i in range(len(docs))]  # 32 pairs, both ways
    t0 = time.perf_counter()
    ids, seg = tok(docs, pairs, max_seq_len=T)
    _sync(dev)
    tok_s = time.perf_counter() - t0
    n_tok = int((ids != tok._pad).sum())
    ids_twin, _ = twin(docs, pairs, max_seq_len=T)
    native = [tok._encode_one(d) for d in docs]
    same, differ, where = [], [], []
    for i, d in enumerate(docs):
        (same if native[i] == twin._encode_one(d) else differ).append(i)
        if native[i] != _space_split_ids(tok, d):
            where.append(i)
    if tuple(differ) != TEXT_DIVERGENT or where:
        fail(f"23a: native and twin differ on documents {differ} (want "
             f"{list(TEXT_DIVERGENT)}); the native ids break the C++ rule "
             f"on {where}")
    rows_differ = [i for i in range(len(docs))
                   if not torch.equal(ids[i], ids_twin[i])]
    if set(rows_differ) - {j for i in TEXT_DIVERGENT for j in (i, i ^ 1)}:
        fail(f"23a: rows {rows_differ} differ outside the divergent pairs")
    g = torch.Generator(dev).manual_seed(0)
    head = Linear(model.config.hidden_size, TEXT_TAGS, device=dev,
                  generator=g)
    model.eval()

    def encode():
        with torch.no_grad():
            seq, _ = model.ernie(ids, seg)
            return head(seq)

    ernie_ms, emis = _events_ms(encode, dev)
    trans = torch.randn(TEXT_TAGS + 2, TEXT_TAGS + 2, generator=g,
                        device=dev)
    lens = (ids != tok._pad).sum(1)

    def decode():
        return text.viterbi_decode(emis, trans, lens)

    dec_ms, (score, path) = _events_ms(decode, dev)
    ev = device_timeline(decode, 1, "23a viterbi_decode") \
        if torch.device(dev).type == "cuda" else []
    cpu_score, cpu_path = text.viterbi_decode(emis.cpu(), trans.cpu(),
                                              lens.cpu())
    paths_equal = torch.equal(path.cpu(), cpu_path)
    rel = float(((score.cpu() - cpu_score).abs()
                 / cpu_score.abs().clamp_min(1e-30)).max())
    if tuple(emis.shape) != (len(docs), T, TEXT_TAGS) \
            or not torch.isfinite(emis).all() or not paths_equal \
            or rel > TEXT_SCORE_RTOL or path.dtype != torch.int64:
        fail(f"23a: emissions {tuple(emis.shape)}, paths equal "
             f"{paths_equal}, worst score rel {rel:.3e}")
    out = {"docs": len(docs), "shape": list(ids.shape),
           "native": tok.is_native, "docs_native_equal_twin": len(same),
           "docs_differing": len(differ), "rows_differing": len(rows_differ),
           "tokenizer_ms": tok_s * 1e3, "tokens": n_tok,
           "tokens_per_s": n_tok / tok_s,
           "ernie_forward_ms": ernie_ms, "viterbi_ms": dec_ms,
           "viterbi_launches_a_call": len(ev),
           "paths_equal_cpu": paths_equal, "worst_score_rel": rel,
           "mean_length": float(lens.float().mean())}
    print(f"  23a: {len(docs)} documents -> {tuple(ids.shape)} native ids "
          f"in {tok_s * 1e3:.1f} ms host ({n_tok / tok_s:.0f} tokens/s); "
          f"native = twin on {len(same)} documents, differ on "
          f"{len(differ)} ({differ}, the C++ split rule on all); ERNIE "
          f"forward {ernie_ms:.2f} ms, viterbi_decode {dec_ms:.2f} ms "
          f"({len(ev)} device ops a call), paths equal the CPU's "
          f"{paths_equal}, worst score {rel:.2e} relative")
    return out


def _pad_sample(sample, T=V1_PAD):
    """An (ids, label) sample with its ids cut or padded with 0 to ``T``."""
    doc, label = sample
    out = np.zeros(T, np.int64)
    out[:min(T, len(doc))] = doc[:T]
    return out, label


def _pad_batch(batch):
    """A batch of (ids, label) samples as (B, V1_PAD) int64 ids and (B,)
    labels."""
    rows = [_pad_sample(s) for s in batch]
    return (np.stack([r for r, _ in rows]),
            np.asarray([int(y) for _, y in rows], np.int64))


def v1_data_phase(model, dev):
    """(23b) ``dataset.imdb.train()`` -> ``reader.shuffle`` ->
    ``reader.xmap_readers`` (pad to 160, 4 threads, in order) ->
    ``batch(32, drop_last=True)`` trains ERNIE-3.0 base with a 2-class head
    on its pooled output (AdamW 5e-5) under ``FLAGS_thread_checks``; then
    ``io.DataLoader(text.Imdb)`` -> ``DevicePrefetcher`` for 4 steps, and a
    second consumer thread must raise ``OwnershipError``."""
    import random

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import dataset, io, reader, text
    from paddle_tpu_torch.analysis.thread_checks import OwnershipError
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.nn import Linear

    set_flags({"FLAGS_thread_checks": True})
    try:
        g = torch.Generator(dev).manual_seed(1)
        head = Linear(model.config.hidden_size, 2, device=dev, generator=g)
        model.train()
        params = list(model.ernie.parameters()) + list(head.parameters())
        opt = pt.optimizer.AdamW(learning_rate=V1_LR, parameters=params)

        def step(ids, labels):
            _, pooled = model.ernie(ids)
            loss = torch.nn.functional.cross_entropy(head(pooled), labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        random.seed(0)
        feed = pt.batch(reader.xmap_readers(
            _pad_sample, reader.shuffle(dataset.imdb.train(), buf_size=512),
            4, 64, order=True), V1_BATCH, drop_last=True)
        losses, ms, n = [], [], 0
        for batch in feed():
            ids = torch.from_numpy(np.stack([s[0] for s in batch])).to(dev)
            y = torch.tensor([int(s[1]) for s in batch], device=dev)
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(step(ids, y))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            n += 1
        vals = [float(v) for v in losses]
        if n != 512 // V1_BATCH or not all(np.isfinite(vals)):
            fail(f"23b: {n} v1 batches, losses {vals}")

        loader = io.DataLoader(text.Imdb(mode="train"), batch_size=V1_BATCH,
                               shuffle=False, drop_last=True,
                               collate_fn=_pad_batch)
        pre = io.DevicePrefetcher(loader, device=dev)
        pl = []
        for _ in range(V1_LOADER_STEPS):
            ids, y = next(pre)
            pl.append(float(step(ids, y)))
        caught = []

        def foreign():
            try:
                next(pre)
            except OwnershipError as e:
                caught.append(str(e))
            except Exception as e:  # any other outcome fails below
                caught.append(f"not an OwnershipError: {e!r}")

        th = threading.Thread(target=foreign, name="foreign-consumer")
        th.start()
        th.join()
        pre.close()
        if len(caught) != 1 or "owned by" not in caught[0] \
                or not all(np.isfinite(pl)):
            fail(f"23b: the second consumer gave {caught}; prefetched "
                 f"losses {pl}")
    finally:
        set_flags({"FLAGS_thread_checks": False})
    out = {"v1_steps": n, "step_ms_median": float(np.median(ms)),
           "loss_first": vals[0], "loss_last": vals[-1],
           "ownership_errors_on_the_v1_path": 0,
           "prefetcher_steps": len(pl), "prefetcher_losses": pl,
           "foreign_consumer": caught[0]}
    print(f"  23b: {n} v1 batches (b{V1_BATCH} x s{V1_PAD}), step "
          f"{out['step_ms_median']:.2f} ms (median), loss {vals[0]:.4f} -> "
          f"{vals[-1]:.4f}, no OwnershipError; {len(pl)} prefetched steps, "
          f"the foreign consumer raised: {caught[0][:80]}")
    return out, head


class TextClassifier(torch.nn.Module):
    """23b's classifier as one layer: ERNIE's pooled output through the
    2-class head (what 23c exports)."""

    def __init__(self, ernie, head):
        super().__init__()
        self.ernie, self.head = ernie, head

    def forward(self, ids):
        return self.head(self.ernie(ids)[1])


HUBCONF = '''"""A local model repository for chip_smoke.py's phase 23c."""
import torch

from paddle_tpu_torch.vision.models import resnet50 as _resnet50


def resnet50(seed=0, device="cuda"):
    """ResNet-50 (1000 classes) with random weights from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    return _resnet50(num_classes=1000, device=device, generator=g)
'''


def interop_phase(dev, tmp, classifier, B=8, S=224):
    """(23c) ``utils.dlpack`` both ways on the card, the ``device``
    functions, ``hub.load`` of ResNet-50 from a local ``hubconf.py``
    against the same model built directly, ``onnx.export`` of 23b's
    classifier (ids with a free batch, 160 positions) through ``jit.load``
    against eager, and ``format="onnx"`` raising."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import device as pdevice
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.utils import dlpack
    from paddle_tpu_torch.vision.models import resnet50

    t = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    u = dlpack.from_dlpack(dlpack.to_dlpack(t))
    w = torch.from_dlpack(dlpack.to_dlpack(u))
    u[7] = -1.0
    w[9] = -2.0
    dl_ok = (u.data_ptr() == t.data_ptr() == w.data_ptr()
             and float(t[7]) == -1.0 and float(u[9]) == -2.0
             and not u.requires_grad)
    avail = pdevice.get_available_device()
    pdevice.synchronize(dev)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        pdevice.cuda.synchronize()
    dev_ok = (pdevice.device_count("gpu") == torch.cuda.device_count()
              and ("gpu:0" if on_card else "cpu:0") in avail
              and pdevice.cuda.device_count() == torch.cuda.device_count())
    if not dl_ok or not dev_ok:
        fail(f"23c: dlpack shares {dl_ok}, device functions {dev_ok} "
             f"({avail})")
    repo = os.path.join(tmp, "hub")
    os.makedirs(repo)
    with open(os.path.join(repo, "hubconf.py"), "w") as f:
        f.write(HUBCONF)
    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        hub_net = pt.hub.load(repo, "resnet50", seed=5, device=str(dev))
        g = torch.Generator(dev).manual_seed(5)
        direct = resnet50(num_classes=1000, device=dev, generator=g)
        hub_net.eval()
        direct.eval()
        x = torch.from_numpy(np.random.RandomState(23).randn(
            B, 3, S, S).astype(np.float32)).to(dev)
        with torch.no_grad():
            a, b = hub_net(x), direct(x)
        hub_equal = torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    del hub_net, direct, x
    classifier.eval()
    prefix = os.path.join(tmp, "classifier.onnx")
    t0 = time.monotonic()
    got_prefix = pt.onnx.export(
        classifier, prefix, input_spec=[InputSpec([None, V1_PAD], "int64",
                                                  "ids")])
    export_s = time.monotonic() - t0
    loaded = pt.jit.load(got_prefix, device=dev)
    ids = torch.from_numpy(np.random.RandomState(24).randint(
        0, 5000, (B, V1_PAD))).to(dev)
    with torch.no_grad():
        want, got = classifier(ids), loaded(ids)
    export_equal = torch.equal(got, want)
    err = float((got - want).abs().max())
    try:
        pt.onnx.export(classifier, prefix, format="onnx")
        raised = False
    except NotImplementedError:
        raised = True
    names = sorted(os.listdir(tmp))
    if not hub_equal or not export_equal or not raised \
            or got_prefix != prefix[:-5]:
        fail(f"23c: hub bit-equal {hub_equal}, exported bit-equal "
             f"{export_equal} ({err:.3e}), format='onnx' raised {raised}, "
             f"files {names}")
    out = {"dlpack_zero_copy": dl_ok, "devices": avail,
           "hub_bit_equal": hub_equal, "export_bit_equal": export_equal,
           "export_s": export_s, "onnx_format_raised": raised,
           "artifact_bytes": _artifact_bytes(got_prefix)}
    print(f"  23c: dlpack zero-copy both ways, {avail}; hub ResNet-50 "
          f"bit-equal to the direct build; onnx.export of the classifier in "
          f"{export_s:.1f} s ({out['artifact_bytes']}), jit.load bit-equal "
          "to eager at b8; format='onnx' raised")
    return out


def analysis_phase():
    """(23d) ``analysis.run_all()`` over the installed port: no unsuppressed
    finding."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.analysis import lint

    t0 = time.monotonic()
    findings = analysis.run_all()
    secs = time.monotonic() - t0
    base = lint.load_baseline(analysis.baseline_path())
    if findings:
        fail("23d: " + "; ".join(map(repr, findings[:5])))
    print(f"  23d: analysis.run_all() over {analysis.package_root()}: 0 "
          f"findings in {secs:.2f} s ({len(base)} baseline entries)")
    return {"findings": 0, "seconds": secs, "baseline_entries": len(base)}


def text_data_phase(card, dev="cuda", cfgs=None):
    """Phase 23: 23a-d; the results go on the ``text_data`` line. ``cfgs``
    (ERNIE config, sequence length, 23c's image batch and size) cut the
    sizes for a rehearsal on the CPU."""
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base

    ecfg, T, B, S = cfgs or (ernie_3_base(), TEXT_T, 8, 224)
    on_card = torch.device(dev).type == "cuda"
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_text_")
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        TEXT["card"] = card
        model = ErnieForPretraining(ecfg, seed=0, device=dev)
        TEXT["23a"] = text_tag_phase(model, dev, tmp, T)
        TEXT["23b"], head = v1_data_phase(model, dev)
        TEXT["23c"] = interop_phase(dev, tmp, TextClassifier(model.ernie,
                                                             head), B, S)
        del model, head
        TEXT["23d"] = analysis_phase()
        if on_card:
            TEXT["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    TEXT["seconds"] = time.monotonic() - t0
    print(f"  (23) {TEXT['seconds']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace each engine's decode step and one train "
                         "step on the device")
    ap.add_argument("--launch-worker", metavar="DIR",
                    help="run 16d's worker (the process launch starts)")
    ap.add_argument("--phase17", action="store_true",
                    help="build the kernels and run phase 17 alone (17a-d, "
                         "then phase 12a's loop for 17e), print its "
                         "tp_native line and exit; no result line")
    ap.add_argument("--phase18", action="store_true",
                    help="build the kernels and run phase 18 alone (the op "
                         "surface, 18a-f), print its op_surface line and "
                         "exit; no result line")
    ap.add_argument("--phase19", action="store_true",
                    help="build the kernels and run phase 19 alone (the nn "
                         "layer library, 19a-d), print its nn line and "
                         "exit; no result line")
    ap.add_argument("--phase20", action="store_true",
                    help="build the kernels and run phase 20 alone (hapi "
                         "and vision, 20a-e), print its hapi_vision line "
                         "and exit; no result line")
    ap.add_argument("--phase21", action="store_true",
                    help="build the kernels and run phase 21 alone (export "
                         "and deployment, 21a-e), print its export line and "
                         "exit; no result line")
    ap.add_argument("--phase22", action="store_true",
                    help="build the kernels and run phase 22 alone "
                         "(quantization and incubate, 22a-e), print its "
                         "quant_incubate line and exit; no result line")
    ap.add_argument("--phase23", action="store_true",
                    help="build the kernels and run phase 23 alone (text "
                         "and the data modules, 23a-d), print its text_data "
                         "line and exit; no result line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not (ROOT / "paddle_tpu_torch" / "ops" / "kernels" / "csrc").is_dir():
        fail(f"paddle_tpu_torch is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.launch_worker:
        launch_worker(args.launch_worker)
        return 0
    global FLIGHT_DIR
    if os.environ.get("PADDLE_TPU_FLIGHT_DIR"):
        FLIGHT_DIR = Path(os.environ["PADDLE_TPU_FLIGHT_DIR"])
    else:
        FLIGHT_DIR = Path(tempfile.mkdtemp(prefix="paddle_tpu_torch_flight_"))
        atexit.register(shutil.rmtree, FLIGHT_DIR, True)
        os.environ["PADDLE_TPU_FLIGHT_DIR"] = str(FLIGHT_DIR)
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.framework.flags import set_flags
    from paddle_tpu_torch.ops import kernels as K

    # the registry phase's tuning DB: $FLAGS_kernel_tune_dir when the caller
    # sets it (kept; it must be empty at the start), else a fresh directory
    # removed at exit; the phases before it run with FLAGS_kernel_autotune
    # off and must leave it empty
    tune_dir = os.environ.get("FLAGS_kernel_tune_dir")
    if tune_dir:
        os.makedirs(tune_dir, exist_ok=True)
        if os.listdir(tune_dir):
            fail(f"FLAGS_kernel_tune_dir={tune_dir} is not empty")
    else:
        tune_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_tune_")
        atexit.register(shutil.rmtree, tune_dir, True)
    set_flags({"FLAGS_kernel_autotune": "off",
               "FLAGS_kernel_tune_dir": tune_dir})
    tune_c0 = profiler.counters()

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
    main_fn = f"{INT8_MMA}ILi4ELb1ELi2E"  # <NT = 4, trans, KR = 2>
    int8_fns = [f for f in ptxas_functions(log["int8_matmul"]["ptxas"])
                if INT8_MMA in f[0]]
    int8_ptxas = [f for f in int8_fns if main_fn in f[0]]
    print(f"  the decode batch runs {INT8_MMA}<4, trans, 2> (384 rows a "
          "block): " + (
              f"{int8_ptxas[0][2]} registers, {int8_ptxas[0][1]} spill-store "
              "bytes" if int8_ptxas else "no ptxas report (cached build)"))
    narrow = [f for f in int8_fns if "ELi1E" in f[0]]
    print(f"  {INT8_MMA} at 192 rows a block (KR = 1): {len(narrow)} "
          f"instantiations, registers "
          f"{sorted({r for _, _, r in narrow})}, spill-store bytes "
          f"{sum(st for _, st, _ in narrow)}")
    int8_sass_check()
    if args.phase17:
        import paddle_tpu_torch as paddle

        print(f"[17] tensor-parallel serving at tp={TP} alone")
        tp_phase()
        print("[17e] inside phase 12a")
        gpt_amp_phase(paddle, {"step_ms": 0.0, "tokens_per_s": 0.0,
                               "mfu": 0.0, "peak_gib": 0.0})
        print(json.dumps({"tp_native": {"card": card, **TP_NATIVE}}))
        return 0
    if args.phase18:
        print("[18] the op surface alone")
        op_surface_phase(card)
        print(json.dumps({"op_surface": OP_SURFACE}))
        return 0
    if args.phase19:
        print("[19] the nn layer library alone")
        nn_phase(card)
        print(json.dumps({"nn": NN}))
        return 0
    if args.phase20:
        print("[20] hapi and vision alone")
        hapi_vision_phase(card)
        print(json.dumps({"hapi_vision": HV}))
        return 0
    if args.phase21:
        print("[21] export and deployment alone")
        export_phase(card)
        print(json.dumps({"export": EXPORT}))
        return 0
    if args.phase22:
        print("[22] quantization and incubate alone")
        quant_incubate_phase(card)
        print(json.dumps({"quant_incubate": QI}))
        return 0
    if args.phase23:
        print("[23] text and the data modules alone")
        text_data_phase(card)
        print(json.dumps({"text_data": TEXT}))
        return 0

    print("[2] kernels against their plain versions")
    errs = kernel_phase()
    train_errs, long_errs, llama_errs = flash_phase()
    errs.update(train_errs)

    print("[3] engine: gpt3_1p3b (a, b, e, f, g, i), then llama_7b (c, d, "
          "h), through serving.Engine")
    launches, drives = engine_phase(profile=args.profile)

    print("[5] train: gpt3_1p3b through jit.compile_train_step")
    train_launches, train_tl, compiled = train_phase(profile=args.profile)
    launches.update(train_launches)
    QI["phase5_step_ms"] = compiled["step_ms"]  # 22a prints it beside

    print("[7] Paddle-API train: gpt3_1p3b through to_tensor, nn.Layer, "
          "AdamW with a warm-up/cosine schedule and global-norm clipping")
    api = paddle_api_phase(compiled)

    print("[8] Llama-7B train: llama_7b through jit.compile_train_step")
    llama = llama_train_phase(profile=args.profile)
    print("[9] ERNIE-3.0 base train (eager loop, Lamb), then the six new "
          "optimizers card against CPU")
    ernie = ernie_phase(profile=args.profile)
    print("[12] training runtime: gpt3_1p3b f32 parameters under amp O1 "
          "bf16 through io.DataLoader and DevicePrefetcher with the "
          "stability sentinel; ernie_3_base under O1 fp16 with GradScaler, "
          "preempted and resumed through save/load")
    runtime = runtime_phase(api, ernie, profile=args.profile)
    print("[10] dense generation: gpt3_1p3b greedy, beam 4, sampled, eos; "
          "llama_7b greedy")
    gen = generation_phase()
    print("[11] FLAGS_check_nan_inf on the card")
    naninf = naninf_phase()
    print("[13] engine train: gpt3_1p3b through HybridParallelEngine over "
          "NCCL (DataParallel, world 1), HBM admission, the OOM ladder by "
          "injection, the serving drift")
    engine, fleet, auto = engine_train_phase(llama.pop("oom"))
    part2 = fleet.pop("part2")
    print(f"[17] tensor-parallel serving at tp={TP}, both shards on one card: "
          "gpt3_1p3b (drive a, the e mix, the int8 wire, the tax with spans "
          "in the native ring), then llama_7b")
    tp_phase()
    print("[18] the op surface: the registry's ops on the card against the "
          "CPU, the per-op table at (4096, 2048), linalg, fft and signal, "
          "the model's outputs and sparse at gpt3_1p3b's width")
    op_surface_phase(card)
    print("[19] the nn layer library: the Transformer base trained, checked "
          "against the CPU and decoded incrementally; ResNet-50's stem and "
          "conv2_x at ImageNet size, NCHW and NHWC; the medium PTB LSTM, a "
          "GRU and a BiRNN; the rest of the layers at those widths")
    nn_phase(card)
    print("[20] hapi and vision: ResNet-50 trained through Model.fit beside "
          "its hand loop, evaluate/predict and the metrics, the sentinel's "
          "rollback through fit, YOLOv3-DarkNet53 at 416², vision.ops at "
          "detection sizes and the other 12 families")
    hapi_vision_phase(card)
    print("[21] export and deployment: gpt3_1p3b through jit.save, the "
          "Predictor and a TrainableProgram; ResNet-50 through the C API, "
          "cloned predictors and capi_demo; a to_static while/if; a tiny "
          "GPT saved on the card, run on the CPU")
    export_phase(card)
    print("[22] quantization and incubate: gpt3_1p3b QAT over its 96 mp "
          "linears (compiled, then eager), a 2-layer check against the "
          "CPU; ResNet-50 PTQ to the int8 artifact through the Predictor "
          "and the C API; the 20 GiB host embedding against its numpy "
          "replay; DistributedFusedLamb on ernie_3_base against Lamb; the "
          "incubate operators, fused layers, ASP, custom ops, LookAhead "
          "and ModelAverage")
    quant_incubate_phase(card)
    print("[23] text and the data modules: ernie_3_base tags 64 documents "
          "from FasterTokenizer (native tokenizer.cc) through "
          "viterbi_decode; the v1 reader path trains it under "
          "FLAGS_thread_checks; dlpack, device, hub and onnx.export; the "
          "analysis over the port")
    text_data_phase(card)

    print("[6] kernel registry: off through phases 3 and 5, then search, "
          "ondemand from the DB, and drive (a) on the tuned configs")
    registry = registry_phase(tune_c0, tune_dir)
    registry["int8_widths"] = errs.pop("int8_widths")

    print("[4] kernel timing")
    rows, paged = timing_phase(errs, launches, int8_ptxas)
    # each row's config as its main path resolves it (off) at the row's
    # shape, and the search's winners of its registry kernel
    for r in rows:
        reg = REGISTRY_NAME[r["name"]]
        r["config"] = K.resolve_config(reg, ())
        r["tuned"] = [{"key": t["key"], "winner": t["winner"]}
                      for t in registry["searches"] if t["kernel"] == reg]
        if r["name"] in api["launches"]:  # phase 7's path runs them too
            r["launches_paddle_api"] = api["launches"][r["name"]]
        if r["name"] in llama["launches"]:  # and phase 8's
            r["launches_llama_train"] = llama["launches"][r["name"]]
        amp_launches = runtime["gpt_o1_bf16"]["launches"]
        if r["name"] in amp_launches:  # and phase 12a's, bf16 from O1
            r["launches_amp"] = amp_launches[r["name"]]
        if r["name"] in engine["launches"]:  # and phase 13a's timed steps
            r["launches_engine"] = engine["launches"][r["name"]]
        if r["name"] in fleet["launches"]:  # phase 14a's timed steps
            r["launches_fleet"] = fleet["launches"][r["name"]]
        uly = fleet["sequence_parallel"]["ulysses"]["launches"]
        if r["name"] in uly:  # 14c's one Ulysses forward and backward
            r["launches_ulysses"] = uly[r["name"]]
        pipe = part2["pipeline"]["launches"]
        if r["name"] in pipe:  # 15a's timed 1F1B steps
            r["launches_pipeline"] = pipe[r["name"]]
        if r["name"] in auto["launches"]:  # 16a's timed steps
            r["launches_auto"] = auto["launches"][r["name"]]
        if r["name"] == "flash_attention_fwd":  # 21a's predictor runs
            r["launches_export"] = EXPORT["21a"]["launches_flash_fwd_timed"]
        if r["name"] in EXPORT["21b"]["launches"]:  # 21b's SGD steps
            r["launches_trainable"] = EXPORT["21b"]["launches"][r["name"]]
        if r["name"] in QI["22a"]["launches"]:  # 22a's QAT steps
            r["launches_qat"] = QI["22a"]["launches"][r["name"]]
        if r["name"] == "paged_attention_rows":  # phase 17's tp drives
            tp = TP_NATIVE["gpt"]
            r["launches_tp"] = (tp["17a"]["launches_tp"]
                                + tp["17a+e"]["launches_tp"]
                                + tp["17c"]["launches_tp"]
                                + TP_NATIVE["llama"]["launches_tp"])
            r["tp_shard_shape"] = tp["shard_kernel"]
    # the reference's (B*H, T, D) route shape: not on the port's main path
    long_rows = flash_timing(long_errs, dict.fromkeys(FLASH_REPLACES, 0),
                             FLASH_LONG, fused_qkv=False)
    # Llama-7B's training shape, with phase 8's launches
    llama_rows = flash_timing(llama_errs, llama["launches"], FLASH_LLAMA,
                              fused_qkv=False)
    # 15a's micro-batch shape, with its pipelined launches
    pipe_errs = {(n, torch.bfloat16): e for n, e in flash_check(
        *FLASH_PIPE, torch.bfloat16, fused_qkv=True).items()}
    pipe_rows = flash_timing(pipe_errs, part2["pipeline"]["launches"],
                             FLASH_PIPE, fused_qkv=True)
    for r in rows + long_rows + llama_rows + pipe_rows:
        extra = (f", {r['tflop_s']:.1f} TFLOP/s, host "
                 f"{r['host_us_per_call']:.1f} us/call" if "tflop_s" in r
                 else "")
        print(f"  {r['name']}: {r['ms']:.4f} ms{extra} (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, library {r['library_ms']}) at {r['shape']}")
        if r.get("host_us_operator"):
            h, b = r["host_us_operator"], r["host_us_backward"]
            print(f"    host us a call: operator {h['operator_us']:.2f}, "
                  f"launcher {h['launcher_us']:.2f} (+"
                  f"{h['operator_us'] - h['launcher_us']:.2f})"
                  + (f"; registered backward {b['operator_us']:.2f}, delta "
                     f"and the two launchers {b['launcher_us']:.2f} (+"
                     f"{b['operator_us'] - b['launcher_us']:.2f})" if b
                     else "")
                  + " (interleaved medians)")
    for r in paged:
        print(f"  paged_attention_rows ({r['tag']}): {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, {r['split']} blocks a row; by explicit split "
              + ", ".join(f"{k}: {v:.4f}" for k, v in r["ms_by_split"].items())
              + f") at {r['shape']}")
    # each kernel's device time from the profiled windows (drive (i)'s decode
    # steps, one train step) beside its CUDA-event time at the timing shape
    traced = next(d for d in drives if d["drive"] == "i")
    timeline = {"paged_attention_rows":
                traced["device_timeline"]["paged_attention_kernel"],
                **{k: train_tl[v] for k, v in FLASH_KERNELS.items()}}
    for r in rows:
        t = timeline.get(r["name"])
        if t is not None:
            print(f"  {r['name']}: device timeline {t['us_per_launch']:.2f} "
                  f"us a launch, {t['ms_per_step']:.4f} ms a step "
                  f"({t['launches']} launches); CUDA events "
                  f"{r['ms'] * 1e3:.2f} us at {r['shape']}")
    print(json.dumps({"device_timeline": timeline}))
    print(json.dumps({"flash_long_shape": long_rows}))
    print(json.dumps({"flash_llama_shape": llama_rows}))
    print(json.dumps({"flash_pipeline_shape": pipe_rows}))
    print(json.dumps({"train_models": {"llama_7b": llama,
                                       "ernie_3_base": ernie}}))
    print(json.dumps({"generate": gen}))
    print(json.dumps({"naninf": naninf}))
    print(json.dumps({"paged_shapes": paged}))
    print(json.dumps({"engine_drives": drives}))
    print(json.dumps({"registry": registry}))
    print(json.dumps({"engine_train": engine}))
    print(json.dumps({"fleet_train": fleet}))
    print(json.dumps({"fleet_part2": {"card": card, **part2}}))
    print(json.dumps({"auto_parallel_ckpt": {"card": card, **auto}}))
    print(json.dumps({"tp_native": {"card": card, **TP_NATIVE}}))
    print(json.dumps({"op_surface": OP_SURFACE}))
    print(json.dumps({"nn": NN}))
    print(json.dumps({"hapi_vision": HV}))
    print(json.dumps({"export": EXPORT}))
    print(json.dumps({"quant_incubate": QI}))
    print(json.dumps({"text_data": TEXT}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
