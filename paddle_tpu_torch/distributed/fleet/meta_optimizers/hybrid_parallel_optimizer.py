"""``HybridParallelOptimizer`` and the ZeRO-1 sharded weight update (port
of ``paddle_tpu/distributed/fleet/meta_optimizers/
hybrid_parallel_optimizer.py``).

``ShardedWeightUpdate`` is the reference's "Automatic Cross-Replica
Sharding of Weight Update" (arXiv:2004.13336) over one data-parallel
group: the gradients are flattened into reverse-backward-order buckets
(``fleet/grad_buckets.py``, padded to whole per-rank shards of whole
quantization blocks), each bucket is reduce-scattered (mean) — or, under
``FLAGS_quantized_allreduce``, put through the EQuARX blockwise int8
``quantized_psum_scatter_mean``, with an error-feedback residual kept per
bucket under ``FLAGS_quantized_allreduce_error_feedback`` — and the
elementwise rule updates this rank's 1/dp shard of the flat parameters
with this rank's shard of the flat moments; the updated shards are then
all-gathered into every parameter. A rank keeps padded/dp elements of each
moment. The reference runs it inside one ``shard_map``; the port runs the
same steps as collectives over the group. A bucket may mix decay gates:
the rule runs once a run of equal gate inside the shard (the reference
broadcasts a per-element gate vector; the products are the same).

``maybe_build``'s eligibility is the reference's: the flag on, a pure
data-parallel mesh (one dp axis larger than 1, no other), an elementwise
rule and no gradient accumulation; otherwise the engine runs the
replicated update. ``sync_back`` unpacks the shards into the optimizer's
per-parameter accumulators (the logical state; a collective).

``HybridParallelOptimizer`` wraps the user's optimizer (reference :241):
with a sharding group of more than one rank it wraps it further in
``ShardingOptimizerStage1``. Its eager ``step()`` first averages the
gradients over the hybrid communicate group's data x sequence group (the
reference's gradients are global by construction), then runs the inner
step, whose ``ClipGradByGlobalNorm`` is group-aware (``nn/clip.py``).
Under a DGC or LocalSGD meta-optimizer it does not average them: DGC
communicates its own masked tensor, and LocalSGD's steps are local.
``state_dict()`` is the logical state: when an engine's sharded update
owns the moments, it syncs them back first.
"""
from __future__ import annotations

import numpy as np
import torch

from ....framework import flags as _flags
from ... import collective as C
from ..grad_buckets import build_bucket_plan


def _base(opt):
    """The optimizer under any wrappers (its rule and its state)."""
    while True:
        inner = opt.__dict__.get("_inner_opt") or opt.__dict__.get("inner")
        if inner is None:
            return opt
        opt = inner


class ShardedWeightUpdate:
    """ZeRO-1 weight-update sharding over ``group`` (``nranks`` ranks)."""

    def __init__(self, optimizer, params, group, nranks: int,
                 axis: str = "dp"):
        self.optimizer = optimizer
        self.axis = axis
        self.base = _base(optimizer)
        self.params = list(params)
        self.group = group
        self.nranks = int(nranks)
        self.quantized = bool(_flags.flag("FLAGS_quantized_allreduce", False))
        self.block = int(_flags.flag("FLAGS_quantized_allreduce_block", 128))
        self.error_feedback = self.quantized and bool(
            _flags.flag("FLAGS_quantized_allreduce_error_feedback", False))
        index = {id(p): i for i, p in enumerate(self.base._parameter_list)}
        self._opt_index = [index[id(p)] for p in self.params]
        self.plan = build_bucket_plan(
            self.params, nranks=self.nranks,
            bucket_bytes=_flags.flag("FLAGS_dp_bucket_bytes"),
            block=self.block,
            wd_of=lambda p: self.base._gate(index[id(p)]),
            plr_of=lambda p: getattr(p, "optimize_attr", {}).get(
                "learning_rate", 1.0))
        self.state = None  # per bucket {key: this rank's flat shard}
        self.ef = None  # per bucket: the local compression residual

    # -- enablement ----------------------------------------------------------
    @staticmethod
    def maybe_build(optimizer, params, mesh, dp_axes, grad_accumulate=1,
                    group=None):
        """A ShardedWeightUpdate when the configuration is a pure-DP group
        eligible for weight-update sharding, else None."""
        if not _flags.flag("FLAGS_shard_weight_update", True):
            return None
        if grad_accumulate and int(grad_accumulate) > 1:
            return None
        if not params or not getattr(_base(optimizer), "_elementwise_rule",
                                     False):
            return None
        sizes = dict(mesh.shape)
        dp_present = [a for a in dp_axes if sizes.get(a, 1) > 1]
        other = [a for a, s in sizes.items()
                 if a not in tuple(dp_axes) and s > 1]
        if len(dp_present) != 1 or other:
            return None
        return ShardedWeightUpdate(optimizer, params, group,
                                   sizes[dp_present[0]], dp_present[0])

    def _rank(self):
        g = self.group if self.group is not None else C.get_group(0)
        return max(g.rank, 0)

    # -- state ---------------------------------------------------------------
    def _keys(self, b):
        return sorted(self.base._init_accums(
            torch.zeros(1, dtype=b.dtype)).keys())

    def state_specs(self):
        """The layout of the update's state, as the reference's: the step
        count replicated, each bucket's flat moments and compression
        residual sharded over the data axis (the port's specs are tuples)."""
        return {"t": (),
                "accums": [{k: (self.axis,) for k in self._keys(b)}
                           for b in self.plan.buckets],
                "ef": [(self.axis, None) for _ in self.plan.buckets]
                if self.error_feedback else []}

    def init_state(self):
        """Pack the optimizer's per-parameter accumulators (or zeros) into
        this rank's shard of each bucket's flat moments."""
        opt, r = self.base, self._rank()
        dev = self.params[0].device
        self.state, self.ef = [], []
        for b in self.plan.buckets:
            s = self.plan.shard_size(b)
            names = [opt._names[self._opt_index[i]] for i in b.indices]
            st = {}
            for k in self._keys(b):
                if any(opt._accumulators.get(n) for n in names):
                    parts = []
                    for i, n in zip(b.indices, names):
                        acc = opt._accumulators.get(n)
                        if not acc:
                            acc = opt._init_accums(self.params[i])
                        parts.append(acc[k])
                    flat = self.plan.flatten(b, parts)
                    st[k] = flat[r * s:(r + 1) * s].clone()
                else:
                    st[k] = torch.zeros(s, dtype=b.dtype, device=dev)
            self.state.append(st)
            self.ef.append(torch.zeros(b.padded, dtype=torch.float32,
                                       device=dev)
                           if self.error_feedback else None)

    def shard_bytes(self) -> int:
        """Bytes of optimizer state this rank holds."""
        return sum(v.numel() * v.element_size()
                   for st in (self.state or []) for v in st.values())

    @torch.no_grad()
    def sync_back(self):
        """Gather the flat shards and unpack them into the optimizer's
        per-parameter accumulators (a collective over the group)."""
        if self.state is None:
            return
        opt = self.base
        for b, st in zip(self.plan.buckets, self.state):
            for k, shard in st.items():
                flat = C.all_gather_into_tensor(None, shard, self.group)
                for i, piece in zip(b.indices, self.plan.unflatten(b, flat)):
                    name = opt._names[self._opt_index[i]]
                    opt._accumulators.setdefault(name, {})[k] = piece.clone()

    # -- the sharded update --------------------------------------------------
    def _wd_runs(self, b, lo, hi):
        """(start, end, gate) runs of equal decay gate over flat [lo, hi)
        (padding takes 1.0), relative to lo."""
        bounds = [(off, off + sz, w) for off, sz, w in
                  zip(b.offsets, b.sizes, b.wds)]
        bounds.append((b.size, b.padded, 1.0))
        runs = []
        for a, e, w in bounds:
            a, e = max(a, lo), min(e, hi)
            if a >= e:
                continue
            if runs and runs[-1][2] == w and runs[-1][1] == a - lo:
                runs[-1] = (runs[-1][0], e - lo, w)
            else:
                runs.append((a - lo, e - lo, w))
        return runs

    @torch.no_grad()
    def apply(self):
        """Reduce-scatter the bucket gradients, update this rank's shard,
        all-gather the parameters. The caller has counted the step."""
        if self.state is None:
            self.init_state()
        opt, n, r = self.base, self.nranks, self._rank()
        lr, t = opt.get_lr(), opt._step_count
        for bi, b in enumerate(self.plan.buckets):
            s = self.plan.shard_size(b)
            grads = [self.params[i].grad if self.params[i].grad is not None
                     else torch.zeros_like(self.params[i])
                     for i in b.indices]
            gf = self.plan.flatten(b, grads).float()
            if self.quantized:
                if self.error_feedback:
                    gf = gf + self.ef[bi]
                gshard, err = C.quantized_psum_scatter_mean(
                    gf, self.group, n, self.block)
                if self.error_feedback:
                    self.ef[bi] = err
            else:
                gshard = gf.new_empty(s)
                C.reduce_scatter(gshard, gf, C.ReduceOp.SUM, self.group)
                gshard = gshard / n
            pflat = self.plan.flatten(b, [self.params[i] for i in b.indices])
            pshard = pflat[r * s:(r + 1) * s]
            g = opt._regularized([pshard], [gshard.to(pshard.dtype)])[0]
            p_lr = lr if b.plr == 1.0 \
                else float(np.float32(lr) * np.float32(b.plr))
            st = self.state[bi]
            for a, e, w in self._wd_runs(b, r * s, (r + 1) * s):
                opt._update([pshard[a:e]], [g[a:e]],
                            [{k: v[a:e] for k, v in st.items()}], p_lr, t, w)
            pnew = C.all_gather_into_tensor(None, pshard.contiguous(),
                                            self.group)
            for i, arr in zip(b.indices, self.plan.unflatten(b, pnew)):
                self.params[i].copy_(arr)

    def step_counters(self):
        return {"dp_sync_bytes": self.plan.reduce_scatter_bytes(
                    self.quantized),
                "dp_gather_bytes": self.plan.gather_bytes(),
                "dp_buckets": len(self.plan),
                "dp_reduce_scatters": len(self.plan)}


class HybridParallelOptimizer:
    """Wraps the user's optimizer for hybrid-parallel training; attributes
    it lacks are the inner optimizer's."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._sharded_update = None  # set by an engine's ZeRO-1 update
        self._buckets = {}  # sync_gradients' plan of the last eager sync
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            from ..meta_parallel.sharding import ShardingOptimizerStage1

            self._inner_opt = ShardingOptimizerStage1(optimizer, hcg=hcg)

    def __getattr__(self, item):
        if item == "_inner_opt":
            raise AttributeError(item)
        return getattr(self._inner_opt, item)

    @property
    def _step_count(self):
        return self._inner_opt._step_count

    @_step_count.setter
    def _step_count(self, v):
        self._inner_opt._step_count = v

    def _communicates_itself(self):
        """True under a DGC or LocalSGD meta-optimizer."""
        from .dgc_optimizer import DGCMomentumOptimizer
        from .localsgd_optimizer import LocalSGDOptimizer

        opt = self._inner_opt
        while opt is not None:
            if isinstance(opt, (DGCMomentumOptimizer, LocalSGDOptimizer)):
                return True
            opt = opt.__dict__.get("_inner_opt") or opt.__dict__.get("inner")
        return False

    def _sync_grads(self):
        """Average the gradients over the data x sequence group (the eager
        loop's counterpart of the engine's sync)."""
        g = self._hcg.get_dp_sp_parallel_group() if self._hcg else None
        if g is None or g.nranks == 1 or self._communicates_itself():
            return
        from ...parallel import sync_gradients

        sync_gradients(_base(self)._parameter_list, g, cache=self._buckets)

    def step(self):
        self._sync_grads()
        self._inner_opt.step()

    def _step(self, functional, with_params=False):
        return self._inner_opt._step(functional, with_params)

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self._inner_opt.get_lr()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        if self._sharded_update is not None:
            self._sharded_update.sync_back()
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        self._inner_opt.set_state_dict(sd)
        if self._sharded_update is not None:
            self._sharded_update.state = None  # repacked on the next step


__all__ = ["HybridParallelOptimizer", "ShardedWeightUpdate"]
