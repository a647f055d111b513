"""Deep gradient compression (port of
``paddle_tpu/distributed/fleet/meta_optimizers/dgc_optimizer.py``; Lin et
al. 2018).

Momentum SGD with a velocity ``u`` and an error-feedback accumulator ``v``
a parameter: each step ``u = m * u + g`` and ``v += u``; only the top
``1 - sparsity`` fraction of ``|v|`` is communicated and applied, the rest
stays in ``v``, and ``u`` is masked where ``v`` was sent (momentum-factor
masking). Before ``rampup_begin_step`` the step is dense momentum. The
sparsity schedule, ``k = max(1, round(size * (1 - sparsity)))`` (Python's
round, half to even) and the mask ``|v| >= `` the k-th largest ``|v|`` (so
ties keep more than ``k``) are the reference's; the threshold is a value,
not an index, so ``torch.topk``'s order of ties does not matter.

The reference's "communicated" tensor is the masked dense ``v``, averaged
with ``lax.pmean`` over the dp axis when its step is traced inside a
``shard_map`` body. The port's rank is that body: with a data-parallel
group of more than one rank (``group``, else the hybrid communicate
group's), the masked tensor, and the dense gradient of a ramp-up step, is
all-reduced (mean) over it. ``HybridParallelOptimizer`` does not average
the gradients before this optimizer's step. State is keyed by ``p.name``.
"""
from __future__ import annotations

import torch

from ... import collective as C

__all__ = ["DGCMomentumOptimizer"]


def _dp_group(group):
    if group is not None:
        return group
    from ..base.fleet_base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.get_data_parallel_group() if hcg is not None else None


class DGCMomentumOptimizer:
    """Momentum SGD with top-k gradient compression and error feedback."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 group=None, axis_name=None, grad_clip=None, name=None,
                 lr_fn=None):
        # lr_fn: a live getter (the inner optimizer's get_lr), so an
        # attached scheduler keeps working
        self._lr_fn = lr_fn
        self._lr = float(learning_rate() if callable(learning_rate)
                         else learning_rate)
        self._momentum = float(momentum)
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(1, int(rampup_step))
        self._sparsity = tuple(sparsity) if isinstance(
            sparsity, (list, tuple)) else (float(sparsity),)
        self.group = _dp_group(group)
        self.axis_name = axis_name or (group.axis_name if group is not None
                                       else "dp")
        self._step_count = 0
        self._u = {}  # parameter name -> velocity
        self._v = {}  # parameter name -> error-feedback accumulator
        # the fraction of elements communicated by the last step
        self.last_comm_fraction = 1.0

    def get_lr(self):
        return float(self._lr_fn()) if self._lr_fn is not None else self._lr

    def set_lr(self, lr):
        self._lr = float(lr)

    def _pmean(self, t):
        g = self.group
        if g is None or g.nranks <= 1:
            return t
        return C.all_reduce(t.clone(), C.ReduceOp.AVG, g)

    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        if self._step_count >= self._rampup_begin:
            # each sparsity rung holds rampup_step / len(sparsity) steps,
            # then the last one stays
            idx = ((self._step_count - self._rampup_begin)
                   * len(self._sparsity) // self._rampup_step)
            sparsity = self._sparsity[min(len(self._sparsity) - 1, idx)]
        else:
            sparsity = None
        total = kept = 0
        for p in self._parameter_list:
            if p.grad is None or not p.requires_grad:
                continue
            g = p.grad.to(p.dtype)
            key = p.name
            if self._step_count < self._rampup_begin:
                # dense ramp-up: plain distributed momentum
                g = self._pmean(g)
                u = self._momentum * self._u.get(key, torch.zeros_like(g)) + g
                self._u[key] = u
                p.copy_(p - lr * u)
                continue
            u = self._momentum * self._u.get(key, torch.zeros_like(g)) + g
            v = self._v.get(key, torch.zeros_like(g)) + u
            k = max(1, int(round(v.numel() * (1.0 - sparsity))))
            absv = v.abs()
            thr = torch.topk(absv.reshape(-1), k).values[-1]
            mask = absv >= thr
            send = torch.where(mask, v, torch.zeros_like(v))
            # momentum-factor masking and error feedback (Lin et al. 3.2)
            self._v[key] = torch.where(mask, torch.zeros_like(v), v)
            self._u[key] = torch.where(mask, torch.zeros_like(u), u)
            send = self._pmean(send)
            p.copy_(p - lr * send)
            total += v.numel()
            kept += int(k)
        if total:
            self.last_comm_fraction = kept / total
        self._step_count += 1

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        return {"step": self._step_count,
                "u": {k: t.detach().clone() for k, t in self._u.items()},
                "v": {k: t.detach().clone() for k, t in self._v.items()}}

    def set_state_dict(self, state):
        # a key that matches no parameter would silently restart that
        # parameter's velocity and error feedback from zero
        names = {p.name for p in self._parameter_list}
        for part in ("u", "v"):
            stale = set(state.get(part, {})) - names
            if stale:
                raise ValueError(
                    f"DGC state_dict {part!r} keys {sorted(stale)} match no "
                    f"parameter of this optimizer (have {sorted(names)}); "
                    "checkpoints from the old integer-keyed format cannot "
                    "be restored")
        dev = {p.name: p for p in self._parameter_list}
        self._step_count = int(state.get("step", 0))
        self._u = {k: torch.as_tensor(a).to(dev[k].device)
                   for k, a in state.get("u", {}).items()}
        self._v = {k: torch.as_tensor(a).to(dev[k].device)
                   for k, a in state.get("v", {}).items()}
