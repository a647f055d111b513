"""LocalSGD (port of
``paddle_tpu/distributed/fleet/meta_optimizers/localsgd_optimizer.py``):
every worker takes ``k_steps`` local steps of the inner optimizer, then
the parameters are averaged over the data-parallel group.

The reference's ``sync_params`` averages with ``lax.pmean`` when its step
is traced inside a ``shard_map`` body and is a no-op otherwise. The port's
rank is that body: with a data-parallel group of more than one rank
(``group``, else the hybrid communicate group's) each parameter is
all-reduced (mean) over it; without one the sync is the identity.
``HybridParallelOptimizer`` does not average the gradients before this
optimizer's step (its steps are local).
"""
from __future__ import annotations

import torch

from ... import collective as C
from .dgc_optimizer import _dp_group

__all__ = ["LocalSGDOptimizer"]


class LocalSGDOptimizer:
    """``inner`` with k-step local training and parameter averaging;
    attributes it lacks are the inner optimizer's."""

    def __init__(self, inner, k_steps: int = 4, group=None, axis_name=None):
        self.inner = inner
        self.k_steps = max(int(k_steps), 1)
        self.group = _dp_group(group)
        self.axis_name = axis_name or (group.axis_name if group is not None
                                       else "dp")
        self._local_steps = 0

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def _parameter_list(self):
        return self.inner._parameter_list

    def step(self):
        self.inner.step()
        self._local_steps += 1
        if self._local_steps % self.k_steps == 0:
            self.sync_params()

    @torch.no_grad()
    def sync_params(self):
        """Average the parameters over the data-parallel group (the
        reference's ``c_allreduce(param) / nranks`` block)."""
        g = self.group
        if g is None or g.nranks <= 1:
            return
        for p in self.inner._parameter_list or []:
            C.all_reduce(p.data, C.ReduceOp.AVG, g)

    def clear_grad(self, set_to_zero=True):
        self.inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        st = self.inner.state_dict()
        st["@local_steps"] = self._local_steps
        return st

    def set_state_dict(self, st):
        st = dict(st)
        self._local_steps = st.pop("@local_steps", 0)
        self.inner.set_state_dict(st)
