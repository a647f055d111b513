"""LayerNorm with the reference's parameter names and formula."""
from __future__ import annotations

import torch
from torch import nn


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """The explicit mean/variance expression, evaluated in x's dtype (as the
    reference does; ``torch.layer_norm`` would upcast bf16)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * weight + bias


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape: int, epsilon: float = 1e-5,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.weight = nn.Parameter(torch.ones(normalized_shape, **kw))
        self.bias = nn.Parameter(torch.zeros(normalized_shape, **kw))
        self.epsilon = epsilon

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon)
