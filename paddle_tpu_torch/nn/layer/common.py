"""Linear and Embedding with the reference's parameter layout and names."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Linear(nn.Module):
    """``x @ weight + bias`` with Paddle's **(in, out)** weight layout, so
    weights carry across from the reference with no transpose."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
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
    """Row lookup into a ``(num_embeddings, dim)`` table named ``weight``."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 std: float = 0.02, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)

    def forward(self, ids):
        return self.weight[ids]
