"""Unique names (``paddle.utils.unique_name``): ``generate(key)`` gives
``key_0``, ``key_1``, ... from a per-key counter, and ``guard()`` runs a
block on fresh counters and puts the old ones back after it.

Parameters are named ``param_<n>`` from this counter, and the optimizers key
their state by that name, as the reference does. A model built twice in one
process gets other names the second time; build each under ``guard()`` and
the two get the same names, so an optimizer's ``state_dict`` carries over
from one to the other.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

_lock = threading.Lock()
_counters = defaultdict(int)  # key -> next index; guarded_by: _lock


def generate(key: str) -> str:
    global _counters
    with _lock:
        n = _counters[key]
        _counters[key] = n + 1
    return f"{key}_{n}"


@contextlib.contextmanager
def guard():
    """Fresh counters for the block."""
    global _counters
    with _lock:
        saved, _counters = _counters, defaultdict(int)
    try:
        yield
    finally:
        with _lock:
            _counters = saved


__all__ = ["generate", "guard"]
