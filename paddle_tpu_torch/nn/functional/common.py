"""Dropout drawn from the port's own generators (``core/random.py``)."""
from __future__ import annotations

import torch

from ...core import random as random_state


def keep_mask(shape, p: float, device) -> torch.Tensor:
    """A bool mask that keeps each element with probability ``1 - p``,
    drawn from the device's default generator."""
    u = torch.empty(shape, device=device)
    u.uniform_(generator=random_state.default_generator(device))
    return u >= p


def dropout(x, p: float = 0.5, training: bool = True):
    """Inverted dropout: kept elements are scaled by ``1 / (1 - p)``."""
    if not training or not p:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = keep_mask(x.shape, p, x.device)
    return x * keep.to(x.dtype) / (1.0 - p)


__all__ = ["dropout", "keep_mask"]
