"""``fleet.utils``: activation recomputation (port of
``paddle_tpu/distributed/fleet/utils/__init__.py``) on
``torch.utils.checkpoint(use_reentrant=False)``. The port's dropout draws
from its own generators (``core/random``), which torch's checkpoint does
not replay, so the recompute restarts the generator of the first tensor
argument's device from the forward's state and draws the same masks."""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ....core import random as random_state


@contextlib.contextmanager
def _generator_state(gen, state):
    """Run with ``gen`` set to ``state``, then put its state back."""
    saved = gen.get_state()
    gen.set_state(state)
    try:
        yield
    finally:
        gen.set_state(saved)


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` whose activations are dropped after
    the forward and recomputed in the backward."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    if not preserve or dev is None:
        return checkpoint(function, *args, use_reentrant=False, **kwargs)
    gen = random_state.default_generator(dev)
    state = gen.get_state()
    return checkpoint(
        function, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _generator_state(gen, state)), **kwargs)


class recompute_sequential:
    """Each of ``functions`` through ``recompute`` in turn."""

    def __init__(self, functions, segments=1):
        self.functions = functions
        self.segments = segments

    def __call__(self, x):
        for f in self.functions:
            x = recompute(f, x)
        return x


__all__ = ["recompute", "recompute_sequential"]
