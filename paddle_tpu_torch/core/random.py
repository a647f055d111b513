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


class ProgramRNG:
    """Checkpointable view of the process's generators: put
    ``program_rng`` in a checkpoint tree (``{"model": m, "optimizer": o,
    "rng": program_rng}``) and a restored run draws the same numbers again
    (the stability sentinel's rollback, ``hapi.Model.fit``). A generator
    made after the capture is put back to its first state, the last seed's,
    which is where it stood then."""

    def state_dict(self) -> dict:
        with _lock:
            seed_now = _seed
        return {"seed": torch.tensor(seed_now, dtype=torch.int64),
                "devices": get_rng_state()}

    def set_state_dict(self, sd: dict) -> None:
        global _seed
        states = dict(sd.get("devices", {}))
        with _lock:
            if "seed" in sd:
                _seed = int(sd["seed"])
            for dev, g in _generators.items():
                if str(dev) not in states:
                    g.manual_seed(_seed)
        set_rng_state(states)


program_rng = ProgramRNG()

__all__ = ["seed", "default_generator", "get_rng_state", "set_rng_state",
           "ProgramRNG", "program_rng"]
