"""Control flow (port of ``paddle_tpu/ops/control_flow.py``): ``cond``,
``case``, ``switch_case`` and ``while_loop``.

Eagerly each takes the reference's eager branch: the predicate (or branch
index) is read on the host and the chosen Python function runs. On the card
that read is one host sync per ``cond`` and per loop test. The branches'
outputs keep their structure, as the reference's do.

Traced (under ``torch.export``, or on the fake tensors of ``make_fx``), a
predicate has no value to read, so each becomes PyTorch's control-flow
operator, as the reference lowers to ``lax.cond``/``lax.while_loop``:
``cond`` is ``torch.cond``, ``case`` and ``switch_case`` nested
``torch.cond``s, and ``while_loop`` is ``torch.while_loop`` (both branches
must return the same structure of tensors, and the loop's carry must keep
its shapes and dtypes, as the reference's ``lax`` operators require).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils import _pytree as pytree

from .creation import _as


def _true(pred) -> bool:
    return bool(_as(pred).reshape(()))


def is_traced(x) -> bool:
    """Whether ``x`` is a tensor being traced (``torch.export``, or a fake
    tensor under ``make_fx``): its value cannot be read."""
    if not isinstance(x, torch.Tensor):
        return False
    if torch.compiler.is_exporting():
        return True
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


def _traced_cond(pred, true_fn, false_fn):
    """``torch.cond`` over two no-argument closures; a Python number among
    their outputs becomes a tensor on the predicate's device."""
    def wrap(fn):
        def run():
            return pytree.tree_map(
                lambda x: x if isinstance(x, torch.Tensor)
                else torch.as_tensor(x, device=pred.device), fn())
        return run

    return torch.cond(pred.reshape(()).to(torch.bool), wrap(true_fn),
                      wrap(false_fn), ())


def cond(pred, true_fn: Callable, false_fn: Callable, name=None):
    """``true_fn()`` if ``pred`` else ``false_fn()`` (no-argument closures
    that return the same structure)."""
    if is_traced(pred):
        return _traced_cond(pred, true_fn, false_fn)
    return true_fn() if _true(pred) else false_fn()


def case(pred_fn_pairs: Sequence, default: Callable = None, name=None):
    """The function of the first pair whose predicate holds; else
    ``default`` (else the last pair's function)."""
    if not pred_fn_pairs:
        raise ValueError("case() needs at least one (pred, fn) pair")
    if any(is_traced(p) for p, _ in pred_fn_pairs):
        pred, fn = pred_fn_pairs[0]
        rest = pred_fn_pairs[1:]
        if not rest:
            return cond(_as(pred), fn, default or fn)
        return cond(_as(pred), fn, lambda: case(rest, default))
    for pred, fn in pred_fn_pairs:
        if _true(pred):
            return fn()
    return (default or pred_fn_pairs[-1][1])()


def switch_case(branch_index, branch_fns, default: Callable = None,
                name=None):
    """The branch ``branch_index`` selects: a list's position or a dict's
    key; an index outside them runs ``default`` (else the last branch)."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
    else:
        fns = list(branch_fns)
        keys = list(range(len(fns)))
    last = default if default is not None else fns[-1]
    if is_traced(branch_index):
        i = branch_index.reshape(())

        def chain(j):
            if j == len(fns):
                return last()
            return cond(i == keys[j], fns[j], lambda: chain(j + 1))

        return chain(0)
    i = int(_as(branch_index).reshape(()))
    pos = keys.index(i) if i in keys else len(fns)
    return (fns + [last])[pos]()


def _traced_while(cond_fn, body_fn, state):
    dev = next((v.device for v in state if isinstance(v, torch.Tensor)),
               None)
    init = tuple(v if isinstance(v, torch.Tensor)
                 else torch.as_tensor(v, device=dev) for v in state)

    def body(*vs):
        out = body_fn(*vs)
        out = list(out) if isinstance(out, (list, tuple)) else [out]
        return tuple(o if isinstance(o, torch.Tensor)
                     else torch.as_tensor(o, device=dev).to(v.dtype)
                     for o, v in zip(out, vs))

    from torch._higher_order_ops.while_loop import while_loop as _while

    out = _while(lambda *vs: _as(cond_fn(*vs)).reshape(()).to(torch.bool),
                 body, init)
    return list(out)


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars,
               is_test=False, name=None):
    """Runs ``loop_vars = body_fn(*loop_vars)`` while ``cond_fn(*loop_vars)``
    holds; returns the final ``loop_vars`` as a list."""
    if any(is_traced(v) for v in loop_vars):
        return _traced_while(cond_fn, body_fn, list(loop_vars))
    state = [v if isinstance(v, (list, tuple, torch.Tensor)) else _as(v)
             for v in loop_vars]
    while _true(cond_fn(*state)):
        out = body_fn(*state)
        state = list(out) if isinstance(out, (list, tuple)) else [out]
    return state


__all__ = ["cond", "case", "switch_case", "while_loop"]
