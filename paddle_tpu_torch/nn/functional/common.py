"""linear (port of ``paddle_tpu/nn/functional/common.py:19``), embedding
(:96) and dropout, drawn from the port's own generators
(``core/random.py``)."""
from __future__ import annotations

import torch

from ...core import random as random_state
from ...core.dispatch import amp_cast


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)`` with Paddle's (in, out) weight."""
    x, weight, bias = amp_cast("linear", (x, weight, bias))
    y = x @ weight
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``. The ``padding_idx`` row
    is zeroed before the lookup, as the reference does, so it reads 0 and
    gets no gradient."""
    if padding_idx is not None:
        weight = weight.index_fill(
            0, torch.tensor([int(padding_idx)], device=weight.device), 0.0)
    return weight[x]


def _keep_mask(shape, p: float, device) -> torch.Tensor:
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
    keep = _keep_mask(x.shape, p, x.device)
    return x * keep.to(x.dtype) / (1.0 - p)


__all__ = ["linear", "embedding", "dropout"]
