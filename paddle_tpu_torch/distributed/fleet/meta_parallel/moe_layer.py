"""The mixture-of-experts layer and its expert all-to-all (port of
``paddle_tpu/distributed/fleet/meta_parallel/moe_layer.py``).

``moe_dispatch_combine`` computes what the reference's does: top-k gating
on the softmax of the gate logits, a capacity of ``ceil(k * T * cf / E)``
tokens an expert, each token's position in its expert's bucket by the
cumulative sum over the token-major ``(T * k, E)`` order, the clipped
scatter-add of the kept tokens into ``(E, C, D)`` buckets, the experts,
the combine gather weighted by the kept gate values, and the Switch-style
auxiliary loss ``E * sum(mean(probs) * mean(onehot(top-1)))`` over this
rank's tokens (the reference does not reduce it over ``ep``).

With an expert-parallel group of more than one rank the buckets cross by
``all_to_all`` on ``(ep, E / ep, C, D)``, as the reference's
``lax.all_to_all(..., tiled=False)`` does inside its ``shard_map``: rank
``r`` receives every rank's rows for its own ``E / ep`` experts, runs
them, and sends them back the same way. The exchange is an autograd
function whose backward is the same exchange. Each rank of a
``MoELayer(ep_group=...)`` holds its ``E / ep`` experts' ``w_up`` and
``w_down`` (the full stack is drawn, so the generator advances as at
ep = 1, and cut along dim 0); the gate is replicated.

The activation is named as in ``jax.nn``: ``"gelu"`` is the tanh
approximation, as ``jax.nn.gelu``'s default is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as TF

from ....nn.layer.common import Linear
from ....nn.layer.layers import Layer
from ...collective import _all_to_all_tiled

# jax.nn's activations by name, with jax's defaults
ACTIVATIONS = {
    "gelu": lambda h: TF.gelu(h, approximate="tanh"),
    "relu": torch.relu,
    "relu6": TF.relu6,
    "silu": TF.silu,
    "swish": TF.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": TF.softplus,
    "elu": TF.elu,
    "selu": TF.selu,
    "celu": TF.celu,
    "leaky_relu": lambda h: TF.leaky_relu(h, 0.01),
    "log_sigmoid": TF.logsigmoid,
    "hard_tanh": TF.hardtanh,
}


def act_fn(name: str):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise AttributeError(
            f"MoELayer: no activation named {name!r} (one of "
            f"{sorted(ACTIVATIONS)})") from None


def route(gate_logits, n_experts, capacity_factor=1.25, k=2):
    """(probs, gate values, expert of each choice, position in its bucket,
    kept, capacity) of the top-``k`` routing."""
    T = gate_logits.shape[0]
    probs = torch.softmax(gate_logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)  # (T, k)
    capacity = int(math.ceil(k * T * capacity_factor / n_experts))
    onehot = TF.one_hot(gate_idx, n_experts)  # (T, k, E)
    pos = (torch.cumsum(onehot.reshape(T * k, n_experts), dim=0)
           .reshape(T, k, n_experts) * onehot).sum(-1) - 1
    return probs, gate_vals, gate_idx, pos, pos < capacity, capacity


def moe_dispatch_combine(x, gate_logits, expert_fn, n_experts,
                         capacity_factor=1.25, group=None, k=2, routing=None):
    """``(tokens (T, D), gate logits (T, E))`` -> ``(combined (T, D),
    aux loss)``. ``expert_fn(buckets, local)`` maps ``(E', C, D)`` buckets
    through the experts: all ``E`` of them (``local=False``), or, over an
    ep group of more than one rank, the ``ep * E / ep`` rows this rank
    received for its own experts, rank-major (``local=True``).
    ``routing`` (``route``'s result) fixes the routing."""
    T, D = x.shape
    E = n_experts
    probs, gate_vals, gate_idx, pos, keep, C = routing if routing is not None \
        else route(gate_logits, E, capacity_factor, k)
    flat_e = gate_idx.reshape(-1)
    flat_pos = pos.reshape(-1).clamp(0, C - 1)
    flat_keep = keep.reshape(-1)
    flat_x = torch.repeat_interleave(x, k, dim=0)
    vals = torch.where(flat_keep[:, None], flat_x, torch.zeros_like(flat_x))
    buckets = x.new_zeros((E, C, D)).index_put((flat_e, flat_pos), vals,
                                               accumulate=True)
    ep = group.nranks if group is not None else 1
    if ep > 1:
        local_e = E // ep
        b = _all_to_all_tiled(buckets.reshape(ep, local_e, C, D), group, 0, 0)
        y = expert_fn(b.reshape(ep * local_e, C, D), local=True)
        y = _all_to_all_tiled(y.reshape(ep, local_e, C, D), group, 0, 0)
        out_buckets = y.reshape(E, C, D)
    else:
        out_buckets = expert_fn(buckets, local=False)
    gathered = out_buckets[flat_e, flat_pos]  # (T * k, D)
    weights = (gate_vals.reshape(-1) * flat_keep).to(x.dtype)
    combined = (gathered * weights[:, None]).reshape(T, k, D).sum(dim=1)
    me = probs.mean(dim=0)
    ce = TF.one_hot(gate_idx[:, 0], E).to(probs.dtype).mean(dim=0)
    aux = (me * ce).sum() * E
    return combined, aux


class MoELayer(Layer):
    """Top-k gated expert FFN (see the module docstring)."""

    def __init__(self, d_model, d_hidden, n_experts, top_k=2,
                 capacity_factor=1.25, ep_group=None, activation="gelu", *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.ep_group = ep_group
        ep = ep_group.nranks if ep_group is not None else 1
        if n_experts % ep:
            raise ValueError(f"MoELayer: {n_experts} experts do not split "
                             f"over {ep} expert-parallel ranks")
        kw = {"device": device, "generator": generator}
        self.gate = Linear(d_model, n_experts, bias_attr=False, dtype=dtype,
                           **kw)
        self.w_up = self.create_parameter([n_experts, d_model, d_hidden],
                                          **kw)
        self.w_down = self.create_parameter([n_experts, d_hidden, d_model],
                                            **kw)
        if ep > 1:
            local, r = n_experts // ep, max(ep_group.rank, 0)
            with torch.no_grad():
                for p in (self.w_up, self.w_down):
                    p.data = p.data[r * local:(r + 1) * local].clone()
        self.act = activation
        self.aux_loss = None
        self.last_routing = None  # route()'s result of the last forward

    def _experts(self, buckets, local=False):
        wu, wd = self.w_up, self.w_down
        act = act_fn(self.act)
        if local and wu.shape[0] != buckets.shape[0]:
            # rows from every rank for this rank's experts, rank-major
            b = buckets.reshape(-1, wu.shape[0], *buckets.shape[1:])
            h = act(torch.einsum("recd,edh->rech", b, wu))
            return torch.einsum("rech,ehd->recd", h, wd).reshape(
                buckets.shape[0], buckets.shape[1], wd.shape[-1])
        h = act(torch.einsum("ecd,edh->ech", buckets, wu))
        return torch.einsum("ech,ehd->ecd", h, wd)

    def forward(self, x):
        tokens = x.reshape(-1, x.shape[-1])
        logits = tokens @ self.gate.weight
        routing = route(logits, self.n_experts, self.capacity_factor,
                        self.top_k)
        self.last_routing = routing
        out, aux = moe_dispatch_combine(
            tokens, logits, self._experts, self.n_experts,
            self.capacity_factor, group=self.ep_group, k=self.top_k,
            routing=routing)
        self.aux_loss = aux
        return out.reshape(x.shape)

    def dropped_tokens(self) -> int:
        """Token choices the last forward dropped at capacity."""
        keep = self.last_routing[4]
        return int(keep.numel() - int(keep.sum()))


__all__ = ["MoELayer", "moe_dispatch_combine", "route", "ACTIVATIONS"]
