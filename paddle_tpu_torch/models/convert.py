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

Pipeline and expert parallelism cut a state differently:
``pp_split_state_dict`` gives each stage of a ``PipelineLayer`` the keys
of its ``stage{s}_{i}`` sublayers, with a ``SharedLayerDesc`` key's
parameters on every stage that holds it (the reference's state keeps them
once, under the key's first position), and ``pp_merge_state_dicts`` takes
them back. ``ep_split_state_dict`` cuts a ``MoELayer``'s ``w_up`` and
``w_down`` along dim 0 (each ep rank's experts) and
``ep_merge_state_dicts`` joins them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from ..distributed.fleet.meta_parallel.mp_layers import (merge_shards,
                                                         shard_of)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.int64: np.int64,
              torch.int32: np.int32, torch.bool: np.bool_}


def mp_layouts(model: torch.nn.Module) -> Dict[str, str]:
    """``{parameter name: its MP_LAYOUTS key}`` of ``model``."""
    return {n: getattr(p, "mp_layout", "replicated")
            for n, p in model.named_parameters()}


def _persistent_buffers(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: buffer}`` of the buffers ``state_dict()`` holds."""
    out = {}
    for mname, m in model.named_modules():
        for bname, b in m._buffers.items():
            if b is not None and bname not in m._non_persistent_buffers_set:
                out[f"{mname}.{bname}" if mname else bname] = b
    return out


def load_reference_state_dict(model: torch.nn.Module,
                              state: Mapping[str, np.ndarray],
                              mp_rank: int = 0, mp_degree: int = 1) -> None:
    """Copy ``{name: np.ndarray}`` — the JAX model's ``state_dict()``
    exported as numpy, logical shapes — into ``model``'s parameters and
    persistable buffers (BatchNorm's ``_mean`` and ``_variance``, for
    example): rank ``mp_rank``'s shard of each parameter under
    ``mp_degree``. Every name, shape and dtype is checked first; any
    missing, extra, mis-shaped or mis-typed entry raises ``ValueError`` and
    nothing is copied. bfloat16 tensors take float32 arrays (numpy has no
    bfloat16) and round them on the copy."""
    targets = dict(model.named_parameters())
    targets.update(_persistent_buffers(model))
    layouts = mp_layouts(model)
    missing = sorted(set(targets) - set(state))
    extra = sorted(set(state) - set(targets))
    errors = []
    if missing:
        errors.append(f"missing {missing}")
    if extra:
        errors.append(f"unexpected {extra}")
    shards = {}
    for name in sorted(set(targets) & set(state)):
        p, a = targets[name], np.asarray(state[name])
        np_dtype = a.dtype
        try:
            # np.require keeps a 0-d buffer 0-d (np.ascontiguousarray
            # would make it shape (1,))
            a = shard_of(torch.from_numpy(np.require(a, requirements="C")),
                         layouts.get(name, "replicated"), mp_rank, mp_degree)
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
        for name, p in targets.items():
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


def pp_stage_prefixes(layer) -> List[Dict[str, str]]:
    """For each stage of the ``PipelineLayer`` ``layer``: ``{the stage's
    sublayer prefix: the reference's prefix}``. A shared key maps to its
    first position overall; its repeats inside one stage are left out, as
    the reference's state leaves them out."""
    from ..distributed.fleet.meta_parallel.pp_layers import (LayerDesc,
                                                             SharedLayerDesc)

    first, out = {}, []
    parts = layer.segment_parts
    for s in range(layer.num_stages):
        here, seen = {}, set()
        for i in range(parts[s], parts[s + 1]):
            d, pre = layer._layers_desc[i], f"stage{s}_{i}"
            if isinstance(d, SharedLayerDesc):
                logical = first.setdefault(d.layer_name, pre)
                if d.layer_name in seen:
                    continue
                seen.add(d.layer_name)
                here[pre] = logical
            elif isinstance(d, (LayerDesc, torch.nn.Module)):
                here[pre] = pre
        out.append(here)
    return out


def _renamed(state, mapping):
    """The entries of ``state`` under one of ``mapping``'s source prefixes,
    renamed to its target prefix."""
    out = {}
    for k, v in state.items():
        head, _, rest = k.partition(".")
        if head in mapping:
            out[f"{mapping[head]}.{rest}"] = v
    return out


def pp_split_state_dict(state: Mapping[str, torch.Tensor],
                        layer) -> List[Dict[str, torch.Tensor]]:
    """Every stage's state (stage order) from the reference's state of the
    ``PipelineLayer`` ``layer`` (any rank's: each knows every stage's
    descs)."""
    return [_renamed(state, {v: k for k, v in m.items()})
            for m in pp_stage_prefixes(layer)]


def pp_merge_state_dicts(states: Sequence[Mapping[str, torch.Tensor]],
                         layer) -> Dict[str, torch.Tensor]:
    """The reference's state from every stage's state (stage order): the
    inverse of ``pp_split_state_dict``; a shared key's parameters are
    taken from the first stage that holds them."""
    out = {}
    for st, m in zip(states, pp_stage_prefixes(layer)):
        for k, v in _renamed(st, m).items():
            out.setdefault(k, v)
    return out


EXPERT_PARAMS = ("w_up", "w_down")


def _is_expert(name):
    return name.rsplit(".", 1)[-1] in EXPERT_PARAMS


def ep_split_state_dict(state: Mapping[str, torch.Tensor],
                        ep_degree: int) -> List[Dict[str, torch.Tensor]]:
    """Every ep rank's state (rank order): each ``MoELayer``'s ``w_up`` and
    ``w_down`` cut along dim 0 into the rank's experts, the rest whole."""
    def cut(k, v, r):
        v = torch.as_tensor(v)
        return shard_of(v, "rows", r, ep_degree) if _is_expert(k) else v

    return [{k: cut(k, v, r) for k, v in state.items()}
            for r in range(ep_degree)]


def ep_merge_state_dicts(states: Sequence[Mapping[str, torch.Tensor]]
                         ) -> Dict[str, torch.Tensor]:
    """The logical state from every ep rank's (rank order): the inverse of
    ``ep_split_state_dict``."""
    return {k: merge_shards([s[k] for s in states], "rows")
            if _is_expert(k) else states[0][k] for k in states[0]}
