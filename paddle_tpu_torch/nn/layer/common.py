"""Linear and Embedding with the reference's parameter layout and names."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...core.place import resolve_device
from ..functional.common import dropout


class Linear(nn.Module):
    """``x @ weight + bias`` with Paddle's **(in, out)** weight layout, so
    weights carry across from the reference with no transpose. Built on
    ``cuda`` unless ``device="cpu"`` (``core.place.resolve_device``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": resolve_device(device), "dtype": dtype}
        self.weight = nn.Parameter(torch.empty(in_features, out_features, **kw))
        self.bias = (nn.Parameter(torch.zeros(out_features, **kw)) if bias
                     else None)
        # Xavier-uniform, as Paddle's default weight initializer
        limit = math.sqrt(6.0 / (in_features + out_features))
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)

    def forward(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias


class Embedding(nn.Module):
    """Row lookup into a ``(num_embeddings, dim)`` table named ``weight``,
    built on ``cuda`` unless ``device="cpu"``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=resolve_device(device),
            dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        return self.weight[ids]


class Dropout(nn.Module):
    """Inverted dropout drawn from the port's generators (``core/random``),
    never from torch's global RNG; active only in ``train()`` mode."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        return dropout(x, self.p, self.training)
