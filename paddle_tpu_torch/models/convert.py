"""Load the reference model's weights into a port model by parameter name
(GPT, Llama and ERNIE alike: their parameter names, the mp layers' included,
equal the reference's ``state_dict()`` names)."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16}


def load_reference_state_dict(model: torch.nn.Module,
                              state: Mapping[str, np.ndarray]) -> None:
    """Copy ``{name: np.ndarray}`` — the JAX model's ``state_dict()`` exported
    as numpy — into ``model``'s parameters. Every name, shape and dtype is
    checked first; any missing, extra, mis-shaped or mis-typed entry raises
    ``ValueError`` and nothing is copied. bfloat16 parameters take float32
    arrays (numpy has no bfloat16) and round them on the copy."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    errors = []
    if missing:
        errors.append(f"missing {missing}")
    if extra:
        errors.append(f"unexpected {extra}")
    for name in sorted(set(params) & set(state)):
        p, a = params[name], np.asarray(state[name])
        if tuple(a.shape) != tuple(p.shape):
            errors.append(f"{name}: shape {tuple(a.shape)} != {tuple(p.shape)}")
            continue
        want = np.float32 if p.dtype == torch.bfloat16 else _NP_DTYPES.get(p.dtype)
        if a.dtype != want:
            errors.append(f"{name}: dtype {a.dtype} != {want}")
    if errors:
        raise ValueError("load_reference_state_dict: " + "; ".join(errors))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.ascontiguousarray(state[name])))
