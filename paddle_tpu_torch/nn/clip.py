"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``).

Each clip takes and returns ``[(param, grad), ...]``: the optimizer calls it
in ``step()`` and updates with the clipped gradients, while ``p.grad`` keeps
the unclipped ones, as in the reference. A parameter with
``need_clip=False`` passes through. The arithmetic is the reference's: the
squares are summed in float32, the global clip scales by
``clip / max(norm, clip)``, and each gradient is scaled in float32 and cast
back to its own dtype. The norms and scales stay on the device
(``torch._foreach_*`` over the whole list), so a clip adds no host sync to
a step.

Under hybrid parallelism ``ClipGradByGlobalNorm`` is group-aware: the
reference's clip sees logical arrays, so its norm is global. A parameter
an mp layer shards (``mp_distributed``, with its ``mp_group``) holds one
rank's slice, so its squares are summed over the mp group, while a
replicated one (LayerNorms, ``RowParallelLinear``'s bias) counts once, not
mp times. Gradients a ZeRO-2 optimizer reduce-scattered (``sharded``
indices, over ``shard_group``) are summed over that group the same way.
A ZeRO-3 slice (``zero3_group``, with a ``zero3_dim``) counts as such a
sharded gradient over its group. With no group of more than one rank the
norm is the single-rank one. ``ClipGradByNorm`` takes a sharded gradient's
own norm over its mp group, then over its ZeRO-3 group, the same way.
"""
from __future__ import annotations

import torch


def _clipped(params_grads):
    """The indices of the pairs a clip applies to."""
    return [i for i, (p, g) in enumerate(params_grads)
            if g is not None and getattr(p, "need_clip", True)]


def _scaled(grads, scales):
    """Each gradient times its float32 scale (one 0-d tensor for all, or one
    a gradient), computed in float32 and rounded once to the gradient's
    dtype, as the reference's ``(g.astype(f32) * scale).astype(g.dtype)``.
    The scale goes in as a one-element tensor, which promotes the product
    to float32 (a 0-d float32 operand would not: torch's CUDA multiply
    rounds it to bf16 first), and ``out=`` stores it in the gradient's
    dtype, in one pass. One scale for gradients of one dtype scales them
    all as one flat tensor, whose pieces are the returned views
    (``chip_smoke.py`` holds the result bit for bit on the card)."""
    one_dtype = len({g.dtype for g in grads}) == 1
    if isinstance(scales, torch.Tensor) and one_dtype:
        flat = torch.cat([g.reshape(-1) for g in grads])
        out = torch.mul(flat, scales.reshape(1), out=torch.empty_like(flat))
        return [piece.view_as(g) for piece, g in
                zip(out.split([g.numel() for g in grads]), grads)]
    if isinstance(scales, torch.Tensor):
        scales = [scales] * len(grads)
    return [torch.mul(g, s.reshape(1), out=torch.empty_like(g))
            for g, s in zip(grads, scales)]


def _replace(params_grads, idx, grads):
    out = list(params_grads)
    for i, g in zip(idx, grads):
        out[i] = (params_grads[i][0], g)
    return out


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to [min, max] (min = -max by default)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        if not idx:
            return params_grads
        gs = [params_grads[i][1] for i in idx]
        gs = torch._foreach_clamp_max(torch._foreach_clamp_min(gs, self.min),
                                      self.max)
        return _replace(params_grads, idx, gs)


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip / max(norm, 1e-12), 1)`` with its
    own float32 L2 norm (the logical gradient's under tensor parallelism:
    ``_logical_norms``)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        if not idx:
            return params_grads
        gs = [params_grads[i][1] for i in idx]
        norms = _logical_norms(params_grads, idx, torch._foreach_norm(
            gs, 2, dtype=torch.float32))
        scales = torch._foreach_reciprocal(
            torch._foreach_clamp_min(norms, 1e-12))
        torch._foreach_mul_(scales, self.clip_norm)
        torch._foreach_clamp_max_(scales, 1.0)
        return _replace(params_grads, idx, _scaled(gs, scales))


def mp_split(p):
    """The mp group of more than one rank that shards ``p``, or None."""
    g = getattr(p, "mp_group", None)
    return g if getattr(p, "mp_distributed", False) and g is not None \
        and g.nranks > 1 else None


def zero3_split(p):
    """The ZeRO-3 group of more than one rank that slices ``p``, or
    None."""
    g = getattr(p, "zero3_group", None)
    return g if getattr(p, "zero3_dim", None) is not None and g is not None \
        and g.nranks > 1 else None


def _logical_norms(params_grads, idx, norms):
    """``norms``, the float32 norms of the gradients at ``idx``, with the
    norm of each gradient an mp layer shards (``mp_distributed`` over an
    ``mp_group`` of more than one rank), or ZeRO-3 slices, taken over the
    logical gradient: its shard's squares summed over the group, one
    all-reduce a group."""
    from ..distributed import collective as C

    for split in (mp_split, zero3_split):
        groups = {}
        for k, i in enumerate(idx):
            g = split(params_grads[i][0])
            if g is not None:
                groups.setdefault(id(g), (g, []))[1].append(k)
        if not groups:
            continue
        norms = list(norms)
        for g, ks in groups.values():
            sq = C.all_reduce(torch.stack([norms[k] for k in ks]) ** 2,
                              group=g)
            for k, n in zip(ks, torch.sqrt(sq)):
                norms[k] = n
    return norms


def _global_norm(grads):
    """sqrt of the float32 sum of squares of every gradient (0-d, on the
    device)."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def _group_global_norm(params_grads, idx, sharded, shard_group):
    """The global norm over the logical gradients when they are spread
    over ranks, or None when no group of more than one rank is involved:
    squares of mp-sharded gradients summed over their mp group, of
    ZeRO-sharded ones over ``shard_group``, replicated ones once."""
    from ..distributed import collective as C

    dist_of = [bool(getattr(params_grads[i][0], "mp_distributed", False))
               for i in idx]
    mp = next((params_grads[i][0].mp_group for i, d in zip(idx, dist_of)
               if d and getattr(params_grads[i][0], "mp_group", None)
               is not None and params_grads[i][0].mp_group.nranks > 1), None)
    sh = shard_group if shard_group is not None and shard_group.nranks > 1 \
        and sharded else None
    if mp is None and sh is None:
        return None
    gs = [params_grads[i][1] for i in idx]
    sq = torch.stack(torch._foreach_norm(gs, 2, dtype=torch.float32)) ** 2
    zero = sq.new_zeros(())

    def part(d, s):
        m = [k for k, i in enumerate(idx)
             if dist_of[k] == d and (i in sharded) == s]
        return sq[m].sum() if m else zero

    def total(t, g):  # the sum over g's ranks (the rank's own without g)
        return t if g is None else C.all_reduce(t.clone(), group=g)

    dist_sh = total(part(True, True).reshape(1), sh)
    rep_sh = total(part(False, True).reshape(1), sh)
    dist_all = total(dist_sh + part(True, False), mp)
    return torch.sqrt((dist_all + rep_sh + part(False, False))[0])


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip / max(gn, clip)``, ``gn`` the L2 norm
    over all of them (of the logical gradients under hybrid parallelism)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads, sharded=frozenset(), shard_group=None):
        idx = _clipped(params_grads)
        if not idx:
            return params_grads
        gs = [params_grads[i][1] for i in idx]
        zero3 = [i for i in idx if zero3_split(params_grads[i][0])]
        if zero3 and not sharded:
            sharded = frozenset(zero3)
            shard_group = zero3_split(params_grads[zero3[0]][0])
        gn = _group_global_norm(params_grads, idx, sharded, shard_group)
        if gn is None:
            gn = _global_norm(gs)
        scale = self.clip_norm / torch.clamp_min(gn, self.clip_norm)
        return _replace(params_grads, idx, _scaled(gs, scale))


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by ``min(max_norm / max(total, 1e-6),
    1)``, ``total`` the float32 ``norm_type`` norm over all of them, and
    return ``total``. As in the reference, ``need_clip`` is not read here and
    ``error_if_nonfinite`` is accepted and ignored."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.zeros(())
    gs = [p.grad for p in params]
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max().float() for g in gs]).max()
    else:
        total = torch.stack(torch._foreach_norm(gs, norm_type,
                                                dtype=torch.float32))
        total = torch.linalg.vector_norm(total, norm_type)
    scale = torch.clamp_max(float(max_norm) / torch.clamp_min(total, 1e-6),
                            1.0)
    for p, g in zip(params, _scaled(gs, scale)):
        p.grad.copy_(g)
    return total


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]
