"""The denominator of a mean over valid rows (the cross-entropies' rows
whose label is not ``ignore_index``), made global over data-parallel ranks.

The reference holds the logical batch, so its mean loss divides the sum
over every rank's valid rows by the count of all of them. The port's ranks
each hold a shard, and their losses and gradients are averaged over the
data x sequence group; where padding falls unevenly (the tail of a
sequence lands on the last sp rank) a mean of per-rank means is not the
reference's mean. ``HybridParallelEngine`` runs its forward inside
``mean_over(group)``: there ``denominator`` all-reduces the valid count
over the group and returns ``total / n``, so that the group's average of
the per-rank ``sum / (total / n)`` is ``sum over ranks / total``, for the
loss and for its gradients. Where every rank holds as many valid rows the
denominator is each rank's own count, bit for bit. Outside the context it
is the rank's count.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["mean_over", "denominator"]

# per thread, as autograd's and autocast's modes are: the group the
# engine's forward averages over, or None
_state = threading.local()


@contextlib.contextmanager
def mean_over(group):
    """Make every mean over valid rows inside global over ``group`` (a
    ``collective.Group``; None or one rank: the rank's own mean)."""
    prev = getattr(_state, "group", None)
    _state.group = group if group is not None and group.nranks > 1 else None
    try:
        yield
    finally:
        _state.group = prev


def denominator(valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The divisor of a mean over the True rows of ``valid``: their count
    (at least 1), or under ``mean_over`` the group's count over its size."""
    count = valid.sum()
    group = getattr(_state, "group", None)
    if group is None:
        return count.clamp_min(1).to(dtype)
    from ..distributed import collective as C

    total = C.all_reduce(count.detach().clone(), group=group)
    return total.clamp_min(1).to(dtype) / group.nranks
