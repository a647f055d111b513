"""Tensor-parallel (Megatron) layers (port of
``paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py:28–122``).

The reference keeps each layer's full logical weight and lets GSPMD shard
it over the ``mp`` mesh axis. The port runs one process a rank, so each
layer holds **its rank's shard**: ``VocabParallelEmbedding`` rows,
``ColumnParallelLinear`` columns (and the bias with them),
``RowParallelLinear`` rows (its bias is replicated). The shards are cut
by one table, ``MP_LAYOUTS``, which ``models/convert.py`` reads too to
carry weights across and merge them back. A column layer whose output is
``fused_groups`` equal parts side by side (GPT's and ERNIE's fused
``qkv``: q, k, v) is cut part by part, so rank r holds columns
``{s * n/g + r * n/(g*mp) + j}``: q, k and v of its own heads.

Initialization draws the full logical weight from the layer's generator
and keeps the shard, so a model built at mp = N holds exactly the slices
of the mp = 1 model from the same seed. ``mp_group=None`` reads the
hybrid communicate group's ``mp`` group (``fleet.init``), as the
reference's ``_mp_group`` does; without ``fleet.init`` the layer is
single-rank. The forward calls the reference's helper collectives in the
same places (``distributed/collective.py``): with one rank each is the
identity, so a layer computes what the plain ``nn.Linear``/
``nn.Embedding``/cross-entropy would. The embedding is Megatron's: ids
outside this rank's rows are masked, looked up, zeroed, then all-reduced
over mp. Each sharded parameter carries ``mp_distributed = True`` and its
``mp_group`` (the group-aware global-norm clip reads them) and every
parameter of these layers its ``mp_layout``.

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

# name -> (axis cut, parts side by side along it); None: replicated
MP_LAYOUTS = {
    "replicated": None,
    "rows": (0, 1),       # VocabParallelEmbedding, RowParallelLinear.weight
    "cols": (-1, 1),      # ColumnParallelLinear weight and bias
    "qkv": (-1, 3),       # a fused q|k|v ColumnParallelLinear
}


def _parts(layout: str):
    spec = MP_LAYOUTS[layout]
    return (None, 1) if spec is None else spec


def shard_of(full: torch.Tensor, layout: str, rank: int, nranks: int):
    """Rank ``rank``'s shard of the logical ``full`` under ``layout`` (a
    view; the whole tensor when replicated or ``nranks == 1``)."""
    axis, groups = _parts(layout)
    if axis is None or nranks == 1:
        return full
    n = full.shape[axis]
    if n % (groups * nranks):
        raise ValueError(f"mp layout {layout!r}: dimension {n} does not split"
                         f" into {groups} x {nranks} equal parts")
    step = n // groups
    size = step // nranks
    pieces = [full.narrow(axis, s * step + rank * size, size)
              for s in range(groups)]
    return pieces[0] if groups == 1 else torch.cat(pieces, dim=axis)


def merge_shards(shards, layout: str):
    """The logical tensor from every rank's shard (rank order): the
    inverse of :func:`shard_of`."""
    axis, groups = _parts(layout)
    if axis is None or len(shards) == 1:
        return shards[0]
    per = [s.chunk(groups, dim=axis) for s in shards]
    return torch.cat([p[g] for g in range(groups) for p in per], dim=axis)


def _mp_group(mp_group):
    if mp_group is not None:
        return mp_group
    from ..base.fleet_base import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    return hcg.get_model_parallel_group() if hcg is not None else None


def _mp_degree(group) -> int:
    return group.nranks if group is not None else 1


def _mp_rank(group) -> int:
    return max(group.rank, 0) if group is not None else 0


def _sharded(layer, shape, layout, attr=None, is_bias=False,
             default_initializer=None, **kw):
    """A parameter holding this rank's shard of the logical ``shape``: the
    full weight is drawn (so the generator advances as at mp = 1) and cut
    by ``layout``."""
    p = layer.create_parameter(shape, attr=attr, is_bias=is_bias,
                               default_initializer=default_initializer, **kw)
    n = layer.world_size
    if n > 1 and MP_LAYOUTS[layout] is not None:
        with torch.no_grad():
            p.data = shard_of(p.data, layout, _mp_rank(layer.group),
                              n).contiguous().clone()
        p.mp_distributed = True
        p.mp_group = layer.group
    p.mp_layout = layout
    return p


class VocabParallelEmbedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.group = _mp_group(mp_group)
        self.world_size = _mp_degree(self.group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = num_embeddings // self.world_size
        self.vocab_start = _mp_rank(self.group) * self.per_rank
        self.weight = _sharded(self, [num_embeddings, embedding_dim], "rows",
                               weight_attr,
                               default_initializer=I.XavierUniform(),
                               device=device, generator=generator)

    def forward(self, x):
        if self.world_size == 1:
            return F.embedding(x, self.weight)
        local = x - self.vocab_start
        outside = (local < 0) | (local >= self.per_rank)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside.unsqueeze(-1), 0.0)
        return _mp_allreduce(out, self.group)


class ColumnParallelLinear(Layer):
    """``fused_groups``: the output is that many equal parts side by side
    (3 for a fused q|k|v), each split over the ranks."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, fused_groups: int = 1,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype=dtype)
        self.group = _mp_group(mp_group)
        self.world_size = _mp_degree(self.group)
        self.gather_output = gather_output
        if gather_output and fused_groups != 1 and self.world_size > 1:
            raise ValueError("a fused ColumnParallelLinear cannot gather its "
                             "output: the ranks' parts interleave")
        self._name = name
        layout = "qkv" if fused_groups == 3 else "cols"
        if fused_groups not in (1, 3):
            raise ValueError(f"fused_groups must be 1 or 3, got {fused_groups}")
        kw = {"device": device, "generator": generator}
        self.weight = _sharded(self, [in_features, out_features], layout,
                               weight_attr,
                               default_initializer=I.XavierUniform(), **kw)
        self.bias = _sharded(self, [out_features], layout, is_bias=True,
                             default_initializer=I.Constant(0.0),
                             **kw) if has_bias else None

    def forward(self, x):
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
        self.group = _mp_group(mp_group)
        self.world_size = _mp_degree(self.group)
        self.input_is_parallel = input_is_parallel
        kw = {"device": device, "generator": generator}
        self.weight = _sharded(self, [in_features, out_features], "rows",
                               weight_attr,
                               default_initializer=I.XavierUniform(), **kw)
        self.bias = _sharded(self, [out_features], "replicated",
                             is_bias=True,
                             default_initializer=I.Constant(0.0),
                             **kw) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = _c_split(x, self.group)
        out = _mp_allreduce(F.linear(x, self.weight, None), self.group)
        if self.bias is not None:
            out = out + self.bias
        return out


class ParallelCrossEntropy(Layer):
    """Per-row cross-entropy (``reduction="none"``) of logits whose class
    axis is sharded over the group; rows labelled ``ignore_index`` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _mp_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return _c_softmax_with_cross_entropy(input, label, self.group,
                                             self.ignore_index)


def tied_logits(x, embedding):
    """``x @ embedding.weight.T`` over the full vocabulary: each rank's
    rows of the tied head, gathered over mp (the plain product at one rank
    or for a plain ``Embedding``)."""
    g = embedding.group if getattr(embedding, "world_size", 1) > 1 else None
    return _c_concat(F.linear(_c_identity(x, g), embedding.weight.T), g)


__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "MP_LAYOUTS",
           "shard_of", "merge_shards", "tied_logits"]
