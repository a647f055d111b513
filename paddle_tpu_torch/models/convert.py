"""Load the reference model's weights into a port model by parameter name
(GPT, Llama and ERNIE alike: their parameter names, the mp layers' included,
equal the reference's ``state_dict()`` names), and carry them across tensor
parallelism.

The reference keeps logical arrays; under mp a port rank holds its shard.
``load_reference_state_dict(model, state, mp_rank, mp_degree)`` copies rank
``mp_rank``'s shard of each logical array, ``split_state_dict`` cuts a
logical state into every rank's, and ``merge_state_dicts`` gathers the
ranks' states back into the logical one. Each parameter's cut is its
``mp_layout`` (set by the mp layers; replicated otherwise), read from the
one table ``MP_LAYOUTS`` of ``distributed/fleet/meta_parallel/mp_layers.py``
that the layers cut their own initial weights by: GPT's and ERNIE's fused
``qkv`` is cut head by head (``"qkv"``), so each rank holds q, k and v of
its own heads.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..distributed.fleet.meta_parallel.mp_layers import (merge_shards,
                                                         shard_of)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16}


def mp_layouts(model: torch.nn.Module) -> Dict[str, str]:
    """``{parameter name: its MP_LAYOUTS key}`` of ``model``."""
    return {n: getattr(p, "mp_layout", "replicated")
            for n, p in model.named_parameters()}


def load_reference_state_dict(model: torch.nn.Module,
                              state: Mapping[str, np.ndarray],
                              mp_rank: int = 0, mp_degree: int = 1) -> None:
    """Copy ``{name: np.ndarray}`` — the JAX model's ``state_dict()``
    exported as numpy, logical shapes — into ``model``'s parameters: rank
    ``mp_rank``'s shard of each under ``mp_degree``. Every name, shape and
    dtype is checked first; any missing, extra, mis-shaped or mis-typed
    entry raises ``ValueError`` and nothing is copied. bfloat16 parameters
    take float32 arrays (numpy has no bfloat16) and round them on the
    copy."""
    params = dict(model.named_parameters())
    layouts = mp_layouts(model)
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    errors = []
    if missing:
        errors.append(f"missing {missing}")
    if extra:
        errors.append(f"unexpected {extra}")
    shards = {}
    for name in sorted(set(params) & set(state)):
        p, a = params[name], np.asarray(state[name])
        np_dtype = a.dtype
        try:
            a = shard_of(torch.from_numpy(np.ascontiguousarray(a)),
                         layouts[name], mp_rank, mp_degree)
        except ValueError as e:
            errors.append(f"{name}: {e}")
            continue
        if tuple(a.shape) != tuple(p.shape):
            errors.append(f"{name}: shape {tuple(a.shape)} != {tuple(p.shape)}"
                          + (f" (the rank {mp_rank} shard of {mp_degree})"
                             if mp_degree > 1 else ""))
            continue
        want = np.float32 if p.dtype == torch.bfloat16 else _NP_DTYPES.get(p.dtype)
        if np_dtype != want:
            errors.append(f"{name}: dtype {np_dtype} != {want}")
        shards[name] = a
    if errors:
        raise ValueError("load_reference_state_dict: " + "; ".join(errors))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(shards[name])


def split_state_dict(state: Mapping[str, torch.Tensor],
                     layouts: Mapping[str, str],
                     mp_degree: int) -> List[Dict[str, torch.Tensor]]:
    """Every mp rank's state (rank order) from the logical ``state``, each
    cut by ``layouts`` (``mp_layouts`` of a model); replicated entries are
    the same tensor on every rank."""
    return [{k: shard_of(v, layouts.get(k, "replicated"), r, mp_degree)
             for k, v in state.items()} for r in range(mp_degree)]


def merge_state_dicts(states: Sequence[Mapping[str, torch.Tensor]],
                      layouts: Mapping[str, str]) -> Dict[str, torch.Tensor]:
    """The logical state from every mp rank's ``state_dict()`` (rank
    order): the inverse of ``split_state_dict``."""
    return {k: merge_shards([s[k] for s in states],
                            layouts.get(k, "replicated"))
            for k in states[0]}
