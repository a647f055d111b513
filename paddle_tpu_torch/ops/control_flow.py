"""Control flow (port of ``paddle_tpu/ops/control_flow.py``): ``cond``,
``case``, ``switch_case`` and ``while_loop``.

The port runs eagerly, so each takes the reference's eager branch: the
predicate (or branch index) is read on the host and the chosen Python
function runs. On the card that read is one host sync per ``cond`` and per
loop test. The branches' outputs keep their structure, as the reference's
do.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

from .creation import _as


def _true(pred) -> bool:
    return bool(_as(pred).reshape(()))


def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()`` (no-argument closures
    that return the same structure)."""
    return true_fn() if _true(pred) else false_fn()


def case(pred_fn_pairs: Sequence, default: Callable = None, name=None):
    """The function of the first pair whose predicate holds; else
    ``default`` (else the last pair's function)."""
    if not pred_fn_pairs:
        raise ValueError("case() needs at least one (pred, fn) pair")
    for pred, fn in pred_fn_pairs:
        if _true(pred):
            return fn()
    return (default or pred_fn_pairs[-1][1])()


def switch_case(branch_index, branch_fns, default: Callable = None,
                name=None):
    """The branch ``branch_index`` selects: a list's position or a dict's
    key; an index outside them runs ``default`` (else the last branch)."""
    i = int(_as(branch_index).reshape(()))
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        pos = keys.index(i) if i in keys else len(fns)
    else:
        fns = list(branch_fns)
        pos = i if 0 <= i < len(fns) else len(fns)
    fns = fns + [default if default is not None else fns[-1]]
    return fns[pos]()


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars,
               is_test=False, name=None):
    """Runs ``loop_vars = body_fn(*loop_vars)`` while ``cond_fn(*loop_vars)``
    holds; returns the final ``loop_vars`` as a list."""
    state = [v if isinstance(v, (list, tuple, torch.Tensor)) else _as(v)
             for v in loop_vars]
    while _true(cond_fn(*state)):
        out = body_fn(*state)
        state = list(out) if isinstance(out, (list, tuple)) else [out]
    return state


__all__ = ["cond", "case", "switch_case", "while_loop"]
