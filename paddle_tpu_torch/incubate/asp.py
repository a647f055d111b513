"""ASP, n:m structured sparsity (port of ``paddle_tpu/incubate/asp.py``).

Reference ``python/paddle/fluid/contrib/sparsity/asp.py:286``
(prune_model / ASPHelper / OptimizerWithSparsityGuarantee) and ``utils.py``
(mask_1d, check_mask_1d). The n:m mask keeps the n largest magnitudes of
every m-group along the last axis; ties go to the earlier entry (a stable
``argsort``, as ``jnp.argsort`` is). A decorated optimizer re-applies the
masks after every step, so training stays on the sparse support.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Tuple

import numpy as np
import torch

# id -> (weakref to the parameter, mask): the weakref guards against id
# reuse after collection and lets dead entries be dropped
_MASKS: Dict[int, Tuple["weakref.ref", torch.Tensor]] = {}
_SUPPORTED = ("Linear",)


def compute_mask_nm(arr, n=2, m=4):
    """Keep the n largest-magnitude entries of every m-group along the last
    axis (reference sparsity/utils.py get_mask_1d)."""
    w = arr.detach() if isinstance(arr, torch.Tensor) \
        else torch.as_tensor(np.asarray(arr))
    if w.shape[-1] % m:
        return torch.ones_like(w)  # a tail that does not divide stays dense
    a = w.reshape(-1, m).abs()
    kth = torch.sort(a, dim=-1).values[:, m - n]  # the n-th largest a group
    mask = (a >= kth[:, None]).to(w.dtype)
    # break ties deterministically: at most n kept a group
    idx = torch.argsort(-a, dim=-1, stable=True)
    rank = torch.empty_like(idx).scatter_(
        1, idx, torch.arange(m, device=w.device).expand_as(idx).contiguous())
    mask = mask * (rank < n).to(w.dtype)
    return mask.reshape(w.shape)


def check_mask_nm(arr, n=2, m=4) -> bool:
    """True iff every m-group has at most n nonzeros (reference
    check_mask_1d)."""
    w = arr.detach().float().cpu().numpy() if isinstance(arr, torch.Tensor) \
        else np.asarray(arr)
    if w.shape[-1] % m:
        return True
    g = (w.reshape(-1, m) != 0).sum(axis=-1)
    return bool((g <= n).all())


def _prunable_params(model, supported_types) -> List[torch.Tensor]:
    return [sub.weight for _, sub in model.named_sublayers()
            if type(sub).__name__ in supported_types and hasattr(sub, "weight")]


@torch.no_grad()
def prune_model(model, n=2, m=4, mask_algo="mask_1d", with_mask=True,
                supported_types=_SUPPORTED):
    """Compute and apply n:m masks on the supported layers (reference
    asp.py:286 prune_model). The masks are kept, so decorated optimizers
    re-apply them."""
    for p in _prunable_params(model, supported_types):
        mask = compute_mask_nm(p, n, m)
        _MASKS[id(p)] = (weakref.ref(p), mask)
        p.mul_(mask)
    return model


@torch.no_grad()
def apply_masks(params):
    dead = [k for k, (ref, _) in _MASKS.items() if ref() is None]
    for k in dead:
        del _MASKS[k]
    for p in params:
        entry = _MASKS.get(id(p))
        if entry is None:
            continue
        ref, mask = entry
        if ref() is not p:  # id recycled onto a different tensor
            del _MASKS[id(p)]
            continue
        p.mul_(mask.to(p.dtype))


class OptimizerWithSparsityGuarantee:
    """Optimizer decorator (reference asp.py ASPHelper.decorate): after each
    step, project the pruned weights back onto their mask support."""

    def __init__(self, optimizer):
        self._inner = optimizer

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def step(self):
        self._inner.step()
        apply_masks(self._inner._parameter_list or [])

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()  # the mask projection included
        return None, None

    def clear_grad(self, *a, **k):
        self._inner.clear_grad(*a, **k)


def decorate(optimizer):
    return OptimizerWithSparsityGuarantee(optimizer)


__all__ = [
    "compute_mask_nm", "check_mask_nm", "prune_model", "decorate",
    "apply_masks", "OptimizerWithSparsityGuarantee",
]
