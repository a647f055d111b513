"""Hybrid-parallel training engine (port of
``paddle_tpu/distributed/engine.py`` ``HybridParallelEngine``).

The reference compiles forward, backward and the optimizer update into one
XLA program over a GSPMD mesh. The port runs one process a card and the
step eagerly: ``train_step`` clears the gradients, runs
``loss_fn(model, *batch)`` and its backward, syncs the gradients over the
data-parallel ranks through ``DataParallel``'s buckets (when the model is a
``DataParallel``, or dp x sp > 1), and applies the update the reference's
engine applies (``Optimizer._step(functional=True, with_params=True)``: the
compiled rule with the decay gate and lr scale of each parameter, no grad
clip). At ``dp > 1`` each rank passes its own dim-0 shard of the global
batch, and the returned loss is the mean over the ranks.

The mesh's ``mp``, ``sharding`` and ``sp`` axes run when ``fleet.init``
built the topology with the same degrees (``hcg.mesh``): the model's mp
layers hold their rank's shards, each rank's batch is cut into its T/sp
tokens over the sp group (``split_batch``: along the dimension that
``batch_specs`` names ``"sp"``, else along dim 1 of every input of two or
more dimensions), and a ``ShardingOptimizerStage1`` (which
``fleet.distributed_optimizer`` builds at sharding > 1) exchanges the
gradients over the sharding group in its update.

The batch axes are the mesh axes that ``dp_axes`` names: each rank takes
its own dim-0 shard of the global batch over them, as the reference's
``_batch_sharding`` shards dim 0 over them. The gradients, the loss, the
means over valid rows and ``eval_step``'s loss are averaged over exactly
those axes plus ``sp`` (the sync group), so one step is the reference's
one mean and one update over the logical batch; any other axis holds
replicas that see the same batch. The sync group is the world when the
axes span it, and otherwise a group that the engine's constructor creates
from the mesh's ``CommunicateTopology.get_fused_comm_list``: every rank
creates every list's group, in list order, so the constructor is
collective (every rank builds the engine). Groups are cached per mesh and
axes for the life of the process group.

``pp`` and ``ep`` axes larger than 1 are replica axes, as in the
reference, whose GSPMD step replicates over them every parameter without a
``pp`` or ``ep`` spec and the batch. Two models the reference's step cannot
run raise: a ``PipelineLayer`` built over a pp group of more than one rank
(it holds only its stage; ``PipelineParallelModel.train_batch`` runs its
schedule) and a ``MoELayer`` whose ``ep_group`` has more than one rank
(its all-to-all needs the expert-parallel body that the step does not
open; the reference raises an unbound axis name there).

At dp > 1 on a pure data-parallel mesh, with ``FLAGS_shard_weight_update``
on (the default), an elementwise rule and no accumulation, the update is
the reference's ZeRO-1 sharded weight update (``ShardedWeightUpdate``):
bucket reduce-scatter, a 1/dp-shard update, parameter all-gather.

``grad_accumulate=acc`` splits the batch's dim 0 into ``acc`` chunks and
runs one backward each before the one update. Each chunk's loss is scaled
by ``1/acc`` before its backward and ``.grad`` accumulates: for a power of
two this gives the bits of the reference's ``a + (g / acc).astype(a.dtype)``
(the scale is exact and commutes with every rounding of the backward, with
no subnormals at these scales), with no extra buffer.

The OOM recovery ladder (``_recover_oom``) keeps the reference's rungs,
counters, span attributes and attempt records: classify (``note_oom``) ->
``free_pressure`` (which drops the failed step's gradients and graph and
empties the caching allocator) -> retry once -> re-run the step through the
accumulate path at 2x and then 4x the configured accumulation (sticky,
with the dim-0 divisibility check) -> halt with a post-mortem and
``HbmExhausted``. Before each rung the RNG stream is restored to where the
step began, so a recovered step draws what a healthy one would (the
reference reuses the step's key). An out-of-memory inside the optimizer
update leaves the parameters half written, so the ladder halts there (the
counterpart of the reference's donated-and-dead arguments). The ``hbm.oom``
chaos point is consulted at ``engine.step`` (``engine.accum`` once
degraded) and at each degrade rung, as the reference's ``_dispatch`` does.

Under ``FLAGS_hbm_admission`` the step is admitted as ``jit``'s is: the
first two calls of a signature (the step's kind, its accumulation and the
batch's shapes and dtypes) measure the footprint
(``cost_model.MEASURED_CALLS``), and later calls run
``fault.memory.preflight`` with the second's numbers before anything is
touched.

Under dp x sp > 1 the forward runs inside ``ops.valid_mean.mean_over``
the data x sequence group: a mean over valid rows (the cross-entropies'
rows not labelled ``ignore_index``) divides by the group's count over its
size, so the group's average of the losses and of the gradients is the
reference's mean over the logical batch however unevenly the padding
falls on the ranks. ``eval_step`` cuts the batch and takes its means the
same way, and averages a 0-d result over the group.

``donate`` is accepted and recorded; the port updates in place. The
sharded update keeps the moments in its flat shards:
``sync_optimizer_state()`` (and a ``HybridParallelOptimizer``'s
``state_dict()``) unpacks them, and the OOM ladder's accumulate rungs sync
them back and fall to the replicated update, as the reference's do.
"""
from __future__ import annotations

import gc
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import profiler
from ..core.place import resolve_device
from ..ops.valid_mean import mean_over
from ..core.random import get_rng_state, set_rng_state
from ..fault import inject as _inject
from ..framework.flags import flag
from . import collective as C
from .mesh import global_mesh
from .parallel import DataParallel

__all__ = ["HybridParallelEngine", "shard_model_params"]


def _drop_frames(exc: BaseException) -> None:
    """Release what a failed step's frames hold (its activations, its
    graph), then the tracebacks of ``exc`` and its chained causes: a
    traceback kept in a local of a frame it references is a cycle that
    would hold the engine, its model and its optimizer until the garbage
    collector runs."""
    seen = set()
    e = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        if e.__traceback__ is not None:
            traceback.clear_frames(e.__traceback__)
            e.__traceback__ = None
        e = e.__cause__ or e.__context__


REPLICA_AXES = ("pp", "ep")


def fused_group(mesh, axes):
    """This rank's group over the mesh axes ``axes`` together, from the
    mesh's ``CommunicateTopology.get_fused_comm_list``. Every rank creates
    every list's group in list order (``new_group`` is collective), once
    per process group: later calls return the group kept in
    ``collective._fused``, which ``destroy_process_group`` clears."""
    from .fleet.base.topology import CommunicateTopology

    devs = np.asarray(mesh.devices)
    key = (tuple(mesh.axis_names), devs.tobytes(), devs.shape, tuple(axes))
    if key not in C._fused:
        topo = CommunicateTopology(mesh.axis_names, devs.shape)
        me = C.get_rank()
        for lst in topo.get_fused_comm_list(list(axes)):
            ranks = [int(devs.flat[r]) for r in lst]
            g = C.new_group(ranks, axis_name="+".join(axes))
            if me in ranks:
                C._fused[key] = g
    return C._fused[key]


def _check_replica_axes(model, sizes):
    """Raise where the reference's step cannot run a model over a ``pp`` or
    ``ep`` axis larger than 1 (see the module docstring)."""
    from .fleet.meta_parallel.moe_layer import MoELayer
    from .fleet.meta_parallel.pp_layers import PipelineLayer

    if sizes.get("pp", 1) > 1:
        for m in model.modules():
            if isinstance(m, PipelineLayer) and m._pp_group is not None \
                    and m._pp_group.nranks > 1:
                raise NotImplementedError(
                    "HybridParallelEngine runs a mesh 'pp' axis as replicas "
                    "of the whole model, as the reference's step does; this "
                    f"PipelineLayer holds only stage {m._stage_id} of "
                    f"{m.num_stages}: train it with fleet.distributed_model("
                    "layer).train_batch (PipelineTrainStep)")
    if sizes.get("ep", 1) > 1:
        for m in model.modules():
            if isinstance(m, MoELayer) and m.ep_group is not None \
                    and m.ep_group.nranks > 1:
                raise NotImplementedError(
                    "HybridParallelEngine runs a mesh 'ep' axis as replicas; "
                    "a MoELayer with an ep_group of "
                    f"{m.ep_group.nranks} ranks needs its expert all-to-all "
                    "inside an expert-parallel body that the step does not "
                    "open (the reference raises an unbound axis name there): "
                    "run the MoE layer's forward and backward in your own "
                    "loop over the ep group")


class HybridParallelEngine:
    """``loss_fn(model, *batch_tensors) -> scalar tensor``; one
    ``train_step(*batch)`` is one forward, backward, sync and update."""

    def __init__(
        self,
        model,
        optimizer,
        loss_fn: Callable,
        mesh=None,
        batch_specs: Optional[Sequence] = None,
        dp_axes=("dp",),
        grad_accumulate: int = 1,
        donate: bool = True,
    ):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh or global_mesh()
        self.batch_specs = batch_specs
        self.dp_axes = tuple(dp_axes)
        self.donate = donate
        self.grad_accumulate = max(int(grad_accumulate), 1)
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.buffers = list(model.buffers())
        if not self.params:
            raise ValueError("HybridParallelEngine: the model has no "
                             "trainable parameters")
        sizes = dict(self.mesh.shape)
        from .fleet.base.fleet_base import get_hybrid_communicate_group
        from .fleet.meta_optimizers.hybrid_parallel_optimizer import \
            ShardedWeightUpdate

        _check_replica_axes(model, sizes)
        self.dp = int(np.prod([sizes.get(a, 1) for a in self.dp_axes]))
        self.sp = int(sizes.get("sp", 1))
        n = int(np.prod(list(sizes.values()) or [1]))
        world = C.get_world_size()
        if n > 1 and world != n:
            raise ValueError(f"HybridParallelEngine: the mesh {sizes} needs a "
                             f"world of {n} ranks, have {world} "
                             "(init_parallel_env)")
        self._hcg = None
        # pp and ep are replica axes: they need no topology of their own
        hybrid = {a: s for a, s in sizes.items()
                  if a not in self.dp_axes and a not in REPLICA_AXES
                  and s > 1}
        if hybrid:
            hcg = get_hybrid_communicate_group()
            want = {a: s for a, s in sizes.items() if s > 1}
            have = None if hcg is None else {
                a: s for a, s in hcg.mesh.shape.items() if s > 1}
            if have != want:
                raise ValueError(
                    f"HybridParallelEngine: the mesh axes {hybrid} need "
                    f"fleet.init with the same degrees (have {have}); pass "
                    "mesh=fleet.get_hybrid_communicate_group().mesh")
            self._hcg = hcg
        # the batch axes plus sp: the gradients, the loss and the means over
        # valid rows are averaged over them (None: the world)
        self._sync_n = self.dp * self.sp
        self._sync_group = self._build_sync_group(n)
        # the group whose means over valid rows are taken together
        self._mean_group = (self._sync_group or C._get_default_group()) \
            if self._sync_n > 1 else None
        self._sp_group = self._hcg.get_sequence_parallel_group() \
            if self.sp > 1 else None
        # raises when the model sits on a card this process cannot reach
        self._device = resolve_device(self.params[0].device)
        self._dp_model = model if isinstance(model, DataParallel) else (
            DataParallel(model, group=self._sync_group)
            if self._sync_n > 1 else None)
        self._wus = ShardedWeightUpdate.maybe_build(
            optimizer, self.params, self.mesh, self.dp_axes,
            self.grad_accumulate)
        if self._wus is not None and hasattr(optimizer, "_sharded_update"):
            optimizer._sharded_update = self._wus
        # stability sentinel (fault/sentinel.py); None keeps the zero-cost
        # path — one attribute check per train_step
        self._sentinel = None
        # the hbm.oom chaos consult site name: "engine.step" until a sticky
        # degrade moves the primary dispatch onto the accumulate path
        self._dispatch_op = "engine.step"
        # step signature -> (calls measured, the last footprint): admission
        self._mem = {}
        # set when the last step's optimizer update raised: the parameters
        # may be half written
        self._update_failed = False
        self.last_oom_attempts = None
        self._placed = False

    def _build_sync_group(self, n):
        """The group over the mesh axes ``dp_axes`` names plus ``sp``: None
        (the world) when they span it or hold one rank, else this rank's
        group of the mesh's fused comm lists."""
        if self._sync_n in (1, n):
            return None
        return fused_group(self.mesh, [a for a in self.mesh.axis_names
                                       if a in self.dp_axes or a == "sp"])

    def place(self) -> None:
        """Put the parameters and buffers on this rank's card, once (the
        reference's placement by ``pspec``; see :func:`shard_model_params`)."""
        if not self._placed:
            shard_model_params(self.model, self.mesh, device=self._device)
            self._placed = True

    def attach_sentinel(self, sentinel) -> None:
        """Hook a :class:`~paddle_tpu_torch.fault.sentinel.StabilitySentinel`
        into the step: ``train_step`` consults the ``loss.spike``/
        ``grad.spike`` chaos points on the batch and feeds the step's loss
        to the sentinel as a COMMITTED observation (the update is applied
        by the time the loss is read), so a trip escalates to rollback,
        never skip."""
        self._sentinel = sentinel

    def _as_tensor(self, b):
        return b if isinstance(b, torch.Tensor) \
            else torch.as_tensor(np.asarray(b), device=self._device)

    def batch_layout(self, i, t):
        """Input ``i``'s layout over the mesh: ``batch_specs[i]`` when
        given, else dim 0 over the batch axes (``dp_axes``) and, under
        sequence parallelism, dim 1 over ``sp`` (the reference's
        ``_batch_sharding`` with the port's sequence cut)."""
        from .sharding_api import NamedSharding, PartitionSpec

        if self.batch_specs is not None and i is not None \
                and i < len(self.batch_specs) \
                and self.batch_specs[i] is not None:
            return NamedSharding(self.mesh, PartitionSpec(
                *self.batch_specs[i]))
        axes = tuple(a for a in self.dp_axes if a in self.mesh.axis_names
                     and self.mesh.shape[a] > 1)
        spec = [axes or None] + [None] * (t.dim() - 1)
        if self.sp > 1 and t.dim() >= 2:
            spec[1] = "sp"
        return NamedSharding(self.mesh, PartitionSpec(*spec))

    def prefetch(self, data, buffer_size=2):
        """``data`` (global batches) through a ``DevicePrefetcher`` onto
        this engine's card, each input cut to this rank's part by
        :meth:`batch_layout` before its copy: batch k+1 is copied while
        step k runs, and ``train_step`` does not cut it again."""
        from ..io import DevicePrefetcher

        return DevicePrefetcher(data, buffer_size=buffer_size,
                                device=self._device,
                                sharding=self.batch_layout)

    # -- the step ------------------------------------------------------------
    def train_step(self, *batch):
        from . import watchdog

        # progress for the distributed watchdog: a peer that stops stepping
        # is attributable from the table (two attribute checks without a
        # supervision session)
        watchdog.publish(step=self.optimizer._step_count, phase="train_step")
        with profiler.span("train_step", kind="engine") as sp:
            return self._train_step_impl(sp, *batch)

    def trial_step(self, *batch):
        """One forward and backward with the gradient sync, and no update
        (the step auto-parallel's plan search measures); the gradients are
        dropped after it. Returns the loss."""
        batch = self._shard_batch(batch)
        opt = self.optimizer
        opt.clear_grad(set_to_zero=False)
        with mean_over(self._mean_group):
            loss = self.loss_fn(self.model, *batch)
        loss.backward()
        if self._wus is None and self._dp_model is not None:
            self._dp_model.apply_collective_grads()
        opt.clear_grad(set_to_zero=False)
        return loss.detach()

    def _shard_batch(self, batch):
        """The batch as tensors on this engine's card, cut to this rank's
        T/sp tokens under sequence parallelism (a batch from
        :meth:`prefetch` is cut already: its tensors carry their
        ``placement``)."""
        if any(getattr(b, "placement", None) is not None for b in batch):
            return [self._as_tensor(b) for b in batch]
        batch = [self._as_tensor(b) for b in batch]
        if self._sp_group is None:
            return batch
        from .fleet.meta_parallel.sequence_parallel import split_batch

        return split_batch(batch, self._sp_group, self.batch_specs)

    def _train_step_impl(self, sp, *batch):
        batch = self._shard_batch(batch)
        sp.set(wus=self._wus is not None, params=len(self.params))
        first = None  # a signature whose call is measured
        if flag("FLAGS_hbm_admission", "off") != "off":
            first = self._admit(sp, batch)
        if self._sentinel is not None:
            # chaos spikes are applied to the batch on its device (a
            # poisoned batch is what the sentinel exists to survive)
            batch = list(self._sentinel.maybe_spike(
                batch, step=self.optimizer._step_count + 1))
        rng = get_rng_state()
        oom = None
        try:
            loss = self._dispatch(batch) if first is None \
                else self._measured(sp, first, batch)
        except Exception as e:
            from ..fault import memory as _hbm

            if not _hbm.is_oom(e):
                raise
            oom = e
        if oom is not None:
            # out of memory in the step: free pressure -> retry -> degrade
            # through the accumulate path -> halt (post-mortem). Run outside
            # the handler, so an error of a rung does not chain to the OOM
            # (the classifier walks the chain)
            loss = self._recover_oom(oom, batch, rng, sp)
        self._observe_stability(loss)
        return loss

    def _dispatch(self, batch):
        """One step, with the ``hbm.oom`` chaos point consulted at the
        dispatch site (the unarmed path is one module-attribute probe)."""
        if _inject._armed:
            _inject.maybe_hbm_oom(self._dispatch_op,
                                  step=self.optimizer._step_count + 1)
        return self._step(batch, self.grad_accumulate)

    def _step(self, batch, acc):
        """Forward, backward (``acc`` chunks), the dp sync and the update;
        the loss (an f32 mean of the chunks' losses when ``acc > 1``)."""
        opt = self.optimizer
        self._update_failed = False
        opt.clear_grad(set_to_zero=False)
        if acc == 1:
            with mean_over(self._mean_group):
                loss = self.loss_fn(self.model, *batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = None
            for i in range(acc):
                chunk = [b[i * (b.shape[0] // acc):(i + 1) * (b.shape[0] // acc)]
                         if b.dim() >= 1 else b for b in batch]
                with mean_over(self._mean_group):
                    part = self.loss_fn(self.model, *chunk)
                (part / acc).backward()
                part = (part.detach() / acc).float()
                loss = part if loss is None else loss + part
        wus = self._wus if acc == 1 else None
        if wus is None and self._dp_model is not None:
            self._dp_model.apply_collective_grads()
        if self._sync_n > 1:
            loss = C.all_reduce(loss.clone(), C.ReduceOp.AVG,
                                self._sync_group)
        try:
            if wus is None:
                opt._step(functional=True, with_params=True)
            else:
                opt._step_count += 1
                wus.apply()
                for k, v in wus.step_counters().items():
                    profiler.counter_inc(k, v)
        except BaseException:
            self._update_failed = True
            raise
        return loss

    # -- admission -----------------------------------------------------------
    def _signature(self, batch):
        return (self._dispatch_op, self.grad_accumulate) + tuple(
            (tuple(b.shape), str(b.dtype)) for b in batch)

    def _admit(self, sp, batch):
        """Preflight a signature measured ``MEASURED_CALLS`` times (under
        ``enforce`` this raises before anything is touched) and return
        None; else return the signature, whose call is then measured."""
        from ..cost_model import MEASURED_CALLS
        from ..fault import memory as _hbm

        sig = self._signature(batch)
        calls, mem = self._mem.get(sig, (0, None))
        if calls < MEASURED_CALLS:
            return sig
        _hbm.preflight(mem, self._dispatch_op, span=sp, device=self._device)
        return None

    def _measured(self, sp, sig, batch):
        """One of the first calls of ``sig``: dispatched, measured and
        noted."""
        from ..cost_model import MeasuredStep
        from ..fault import memory as _hbm

        with MeasuredStep(self._device) as run:
            loss = self._dispatch(batch)
        key = f"{sig[0]}:x{sig[1]}:{hash(sig) & 0xFFFFFFFFFFFFFFFF:016x}"
        mem = _hbm.analyze_compiled(run, key=key)
        self._mem[sig] = (self._mem.get(sig, (0, None))[0] + 1, mem)
        if mem is not None:
            sp.set(hbm_exec_peak_bytes=mem["peak_bytes"])
        return loss

    # -- the OOM ladder ------------------------------------------------------
    def _release(self):
        """Between two failed rungs: drop the partial gradients and the
        garbage, and give the allocator's free blocks back."""
        for p in self.params:
            p.grad = None
        gc.collect()
        if self._device.type == "cuda":
            torch.cuda.empty_cache()

    def _recover_oom(self, exc, batch, rng, sp):
        """The engine-level OOM recovery ladder (fault/memory.py), run on the
        step's batch with the RNG stream restored before each rung.

        classify -> free pressure -> retry once -> degrade by re-running the
        failed step through the accumulate path at 2x/4x the configured
        accumulation (sticky: the engine STAYS at the working accumulation,
        so every later step equals a run configured with it from the start)
        -> halt with a flight post-mortem carrying the census, the budget,
        the per-step-program attributions and every attempt."""
        from ..fault import memory as _hbm

        attempts = [{"action": "classify",
                     **_hbm.note_oom(self._dispatch_op, exc)}]
        self.last_oom_attempts = attempts  # what the ladder tried, last time
        _drop_frames(exc)

        def _halt(why, cause):
            attempts.append({"action": "halt", "why": why})
            path = _hbm.post_mortem("engine.step", attempts, cause,
                                    device=self._device)
            raise _hbm.HbmExhausted("engine.step", attempts, path) from cause

        if self._update_failed:
            # the parameters are half written: checkpoint/sentinel recovery
            # owns it from here
            _halt("the update had started", exc)
        attempts.append({"action": "free_pressure", **_hbm.free_pressure(
            "engine.step", params=self.params, device=self._device)})
        set_rng_state(rng)
        try:
            out = self._dispatch(batch)
        except Exception as e2:
            if not _hbm.is_oom(e2):
                raise
            attempts.append({"action": "retry", "ok": False})
            exc = e2
            _drop_frames(e2)
        else:
            profiler.counter_inc("hbm_oom_recoveries")
            attempts.append({"action": "retry", "ok": True})
            sp.set(hbm_oom_recovered="retry")
            return out
        base = self.grad_accumulate
        for mult in (2, 4):
            if self._update_failed:
                _halt("the update had started in a failed rung", exc)
            acc = base * mult
            if any(b.shape[0] % acc for b in batch if b.dim() >= 1):
                attempts.append({"action": f"degrade_x{mult}", "ok": False,
                                 "why": "batch dim0 not divisible"})
                continue
            if self._wus is not None:
                # the sharded update has no accumulate path: its shards go
                # back to the optimizer, which runs the replicated update
                self._drop_sharded_update()
            self._release()
            set_rng_state(rng)
            try:
                if _inject._armed:
                    _inject.maybe_hbm_oom(
                        "engine.accum", step=self.optimizer._step_count + 1)
                out = self._step(batch, acc)
            except Exception as e3:
                if not _hbm.is_oom(e3):
                    raise
                attempts.append({"action": f"degrade_x{mult}", "ok": False})
                exc = e3
                _drop_frames(e3)
                continue
            self.grad_accumulate = acc
            self._dispatch_op = "engine.accum"
            profiler.counter_inc("hbm_oom_recoveries")
            profiler.counter_inc("hbm_degraded_steps")
            attempts.append({"action": f"degrade_x{mult}", "ok": True})
            sp.set(hbm_oom_recovered=f"accum_x{mult}", grad_accumulate=acc)
            return out
        path = _hbm.post_mortem("engine.step", attempts, exc,
                                device=self._device)
        raise _hbm.HbmExhausted("engine.step", attempts, path) from exc

    def _observe_stability(self, loss) -> None:
        """Feed the committed step's loss to the attached sentinel (verdicts
        surface through ``sentinel.take_verdict()`` after ``train_step``
        returns)."""
        if self._sentinel is not None:
            self._sentinel.observe(self.optimizer._step_count, loss=loss,
                                   committed=True, stash=True)

    def _drop_sharded_update(self):
        self.sync_optimizer_state()
        if getattr(self.optimizer, "_sharded_update", None) is self._wus:
            self.optimizer._sharded_update = None
        self._wus = None

    def sync_optimizer_state(self):
        """Unpack the sharded update's flat moment shards into the
        optimizer's per-parameter accumulators (a collective over the dp
        ranks); a no-op on the replicated update, which keeps them there."""
        if self._wus is not None:
            self._wus.sync_back()

    def invalidate_dp_state(self):
        """Drop the sharded update's shards so the next step repacks them
        from the optimizer's accumulators (after loading a checkpoint into
        the optimizer); a no-op on the replicated update."""
        if self._wus is not None:
            self._wus.state = None

    def eval_step(self, fn, *batch):
        """``fn(model, *batch)`` without gradients, on the batch cut as
        ``train_step`` cuts it and with its means over valid rows taken
        over the data x sequence group. A 0-d floating result (a loss) is
        averaged over that group, which gives the reference's value over
        the logical batch; any other result is this rank's shard."""
        batch = self._shard_batch(batch)
        with torch.no_grad(), mean_over(self._mean_group):
            out = fn(self.model, *batch)
            if self._mean_group is not None and isinstance(
                    out, torch.Tensor) and out.dim() == 0 \
                    and out.is_floating_point():
                out = C.all_reduce(out.clone(), C.ReduceOp.AVG,
                                   self._sync_group)
        return out


def shard_model_params(model, mesh=None, device=None):
    """Place each parameter by its ``pspec`` without building an engine.

    The port's model-parallel layers are built holding their rank's shard
    (the placement the reference's ``device_put`` gives a parameter), so
    what placing leaves to do is the device: every parameter and buffer is
    moved, in place, onto ``device`` (default: this rank's card, or
    ``set_device``'s choice). ``mesh`` is accepted for the reference's
    signature."""
    dev = resolve_device(device)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.device != dev:
                t.data = t.data.to(dev)
    return model
