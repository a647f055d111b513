"""Tensor-parallel (Megatron) layers in their single-device form (port of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py:43–122``).

Each layer keeps the reference's constructor arguments, its full logical
weight in Paddle's (in, out) layout (the embedding's is (vocab, dim)), the
Xavier-uniform default and the zero bias, and calls the reference's helper
collectives in the same places (``distributed/collective.py``). With one
rank each helper is the identity, so a layer computes what the plain
``nn.Linear``/``nn.Embedding``/cross-entropy would. ``mp_group`` defaults to
none (the reference reads the hybrid communicate group, which is unset
without ``fleet.init``). A layer holds the whole weight, so a group of more
than one rank raises in the forward: the sharded layers come with the
tensor-parallel topology of ROADMAP A11b.

Like the port's ``nn.Linear``, each layer takes ``device`` (default
``get_device()``), ``dtype`` (default ``get_default_dtype()``) and the
``generator`` its random initializer draws from as keyword arguments.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....nn import functional as F
from ....nn import initializer as I
from ....nn.layer.layers import Layer
from ...collective import (_c_concat, _c_identity,
                           _c_softmax_with_cross_entropy, _c_split,
                           _mp_allreduce)


def _mp_degree(group) -> int:
    return group.nranks if group is not None else 1


def _single_rank(group, what: str) -> None:
    n = _mp_degree(group)
    if n > 1:
        raise NotImplementedError(
            f"{what} over a group of {n} ranks is not ported yet: its weight "
            "shards come with ROADMAP A11b (the tensor-parallel topology); "
            "only the single-rank layer is")


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.group = mp_group
        self.world_size = _mp_degree(self.group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierUniform(), device=device,
            generator=generator)

    def forward(self, x):
        _single_rank(self.group, "VocabParallelEmbedding")
        return F.embedding(x, self.weight)


class ColumnParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.group = mp_group
        self.world_size = _mp_degree(self.group)
        self.gather_output = gather_output
        self._name = name
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform(), **kw)
        self.bias = self.create_parameter(
            [out_features], is_bias=True, default_initializer=I.Constant(0.0),
            **kw) if has_bias else None

    def forward(self, x):
        _single_rank(self.group, "ColumnParallelLinear")
        x = _c_identity(x, self.group)
        out = F.linear(x, self.weight, self.bias)
        if self.gather_output:
            out = _c_concat(out, self.group)
        return out


class RowParallelLinear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.group = mp_group
        self.world_size = _mp_degree(self.group)
        self.input_is_parallel = input_is_parallel
        kw = {"device": device, "generator": generator}
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierUniform(), **kw)
        self.bias = self.create_parameter(
            [out_features], is_bias=True, default_initializer=I.Constant(0.0),
            **kw) if has_bias else None

    def forward(self, x):
        _single_rank(self.group, "RowParallelLinear")
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        out = _mp_allreduce(F.linear(x, self.weight, None), self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(Layer):
    """Per-row cross-entropy (``reduction="none"``) of logits whose class
    axis the group would shard; rows labelled ``ignore_index`` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        _single_rank(self.group, "ParallelCrossEntropy")
        return _c_softmax_with_cross_entropy(input, label, self.group,
                                             self.ignore_index)


__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy"]
