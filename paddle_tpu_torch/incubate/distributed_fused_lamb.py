"""DistributedFusedLamb (port of
``paddle_tpu/incubate/distributed_fused_lamb.py``): LAMB over one flat
float32 master buffer, with a global gradient-norm clip.

Reference ``python/paddle/incubate/optimizer/distributed_fused_lamb.py``
and ``distributed_fused_lamb_op.cu``. Every parameter is a range of the
flat master buffer (float32 whatever the parameter's dtype); the moments
are flat too. A step flattens the gradients, clips them by their global
norm (``max_global_grad_norm > 0``), updates the moments over the whole
buffer, and scales each parameter's range by its trust ratio
``||w|| / ||r||``, whose norms are summed over views of the range in
float64 and rounded to float32 (as the port's ``Lamb`` sums them). The
reference indexes a per-element segment-id vector for the trust ratios;
at GPT-3 1.3B that vector alone would be 10.6 GB of int64, so the port
takes the ranges instead: the same sums, in another order.

``sharding_spec`` is accepted and changes nothing on one device, as in
the reference; slicing the moments over data-parallel ranks is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from ..optimizer import _f32_pow

__all__ = ["DistributedFusedLamb"]


class DistributedFusedLamb:
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 clip_after_allreduce=True, is_grad_scaled_by_nranks=False,
                 max_global_grad_norm=1.0, exclude_from_weight_decay_fn=None,
                 sharding_spec=None, name=None, **kw):
        self._lr = learning_rate
        self._wd = float(lamb_weight_decay)
        self._b1, self._b2 = float(beta1), float(beta2)
        self._eps = float(epsilon)
        self._max_norm = float(max_global_grad_norm)
        self._exclude_fn = exclude_from_weight_decay_fn
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        self._sharding_spec = sharding_spec
        self._step_count = 0
        self._shapes = [tuple(p.shape) for p in self._parameter_list]
        sizes = [int(np.prod(s)) if s else 1 for s in self._shapes]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(
            np.int64)
        self._total = int(self._offsets[-1])
        self._wd_gate = [0.0 if (self._exclude_fn and self._exclude_fn(p))
                         else 1.0 for p in self._parameter_list]
        self._m = self._v = self._master = None

    def get_lr(self):
        return float(self._lr() if callable(self._lr) else self._lr)

    def set_lr(self, lr):
        self._lr = float(lr)

    def _device(self):
        return self._parameter_list[0].device if self._parameter_list \
            else torch.device("cpu")

    def _flatten(self, tensors):
        if not tensors:
            return torch.zeros((0,), dtype=torch.float32,
                               device=self._device())
        return torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])

    def _ranges(self, flat):
        return [flat[int(lo):int(hi)]
                for lo, hi in zip(self._offsets[:-1], self._offsets[1:])]

    @staticmethod
    def _norms(views):
        return torch.stack([torch.linalg.vector_norm(v, dtype=torch.float64)
                            for v in views]).to(torch.float32)

    @torch.no_grad()
    def step(self):
        self._step_count += 1
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._parameter_list]
        g = self._flatten(grads)
        if self._master is None:
            self._master = self._flatten(self._parameter_list)
            self._m = torch.zeros_like(self._master)
            self._v = torch.zeros_like(self._master)
        if not self._total:
            return
        f32 = np.float32
        if self._max_norm > 0:
            gn = torch.linalg.vector_norm(g)
            g = g * torch.clamp(self._max_norm / (gn + 1e-12), max=1.0)
        b1, b2, t = self._b1, self._b2, self._step_count
        self._m.mul_(float(f32(b1))).add_(g * float(f32(1 - b1)))
        self._v.mul_(float(f32(b2))).add_(g * g * float(f32(1 - b2)))
        bc1 = float(f32(1) - _f32_pow(b1, t))
        bc2 = float(f32(1) - _f32_pow(b2, t))
        r = (self._m / bc1) / (torch.sqrt(self._v / bc2) + float(
            f32(self._eps)))
        masters, rs = self._ranges(self._master), self._ranges(r)
        wd = float(f32(self._wd))
        for rv, mv, gate in zip(rs, masters, self._wd_gate):
            if gate:
                rv.add_(mv * wd)
        w_n, r_n = self._norms(masters), self._norms(rs)
        trust = torch.where((w_n > 0) & (r_n > 0),
                            w_n / torch.clamp(r_n, min=1e-12),
                            torch.ones_like(w_n))
        scale = trust * float(f32(self.get_lr()))
        for mv, rv, s, p, sh in zip(masters, rs, scale.unbind(0),
                                    self._parameter_list, self._shapes):
            mv.sub_(s * rv)
            p.copy_(mv.reshape(sh).to(p.dtype))

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    def state_dict(self):
        out = {"@step": self._step_count}
        if self._m is not None:
            # copies: the live buffers are updated in place by the next step
            out["fused_moment1"] = self._m.clone()
            out["fused_moment2"] = self._v.clone()
            out["fused_master"] = self._master.clone()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("@step", 0))
        for key, attr in (("fused_moment1", "_m"), ("fused_moment2", "_v"),
                          ("fused_master", "_master")):
            if key in state:
                v = state[key]
                arr = (v if isinstance(v, torch.Tensor)
                       else torch.as_tensor(np.asarray(v))).detach()
                if tuple(arr.shape) != (self._total,):
                    raise ValueError(
                        f"{key} has {tuple(arr.shape)}, expected "
                        f"({self._total},): the parameter layout changed "
                        "since the checkpoint")
                setattr(self, attr, arr.to(self._device(), torch.float32,
                                           copy=True))
