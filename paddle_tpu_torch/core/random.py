"""Process-wide random state (port of ``paddle_tpu/core/random.py``).

``seed(n)`` reseeds one ``torch.Generator`` per device; dropout and the
train step draw from ``default_generator(device)``. Nothing in the port
reads torch's global RNG. The generators give other numbers than JAX's keys
from the same seed, so parity tests run with dropout 0.
"""
from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_seed = 0  # guarded_by: _lock
_generators: dict = {}  # device -> torch.Generator; guarded_by: _lock


def seed(s: int) -> int:
    """Reseed every device's default generator (and those made later)."""
    global _seed
    with _lock:
        _seed = int(s)
        for g in _generators.values():
            g.manual_seed(_seed)
    return _seed


def default_generator(device) -> torch.Generator:
    """The generator of ``device``, made on first use from the last seed."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        g = _generators.get(dev)
        if g is None:
            g = torch.Generator(device=dev).manual_seed(_seed)
            _generators[dev] = g
        return g


def get_rng_state() -> dict:
    """Every device generator's state, ``{device string: uint8 CPU
    tensor}``: with the model's and the optimizer's, what a checkpoint
    needs to replay dropout exactly."""
    with _lock:
        return {str(dev): g.get_state() for dev, g in _generators.items()}


def set_rng_state(state: dict) -> None:
    """Restore what :func:`get_rng_state` returned (generators are made as
    needed)."""
    for dev, st in state.items():
        default_generator(dev).set_state(st.cpu() if st.device.type != "cpu"
                                         else st)


__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state"]
