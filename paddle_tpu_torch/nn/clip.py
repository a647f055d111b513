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
    own float32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        if not idx:
            return params_grads
        gs = [params_grads[i][1] for i in idx]
        norms = torch._foreach_norm(gs, 2, dtype=torch.float32)
        scales = torch._foreach_reciprocal(
            torch._foreach_clamp_min(norms, 1e-12))
        torch._foreach_mul_(scales, self.clip_norm)
        torch._foreach_clamp_max_(scales, 1.0)
        return _replace(params_grads, idx, _scaled(gs, scales))


def _global_norm(grads):
    """sqrt of the float32 sum of squares of every gradient (0-d, on the
    device)."""
    norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``clip / max(gn, clip)``, ``gn`` the L2 norm
    over all of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        idx = _clipped(params_grads)
        if not idx:
            return params_grads
        gs = [params_grads[i][1] for i in idx]
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
