"""ERNIE, a BERT-style bidirectional encoder (port of
``paddle_tpu/models/ernie.py``): token, position and segment embeddings,
post-LN encoder layers with exact (erf) GELU, a tanh pooler, an MLM head
tied to the word embedding and an NSP head.

Built on the port's model-parallel layers, as the reference's
is on its own, so parameter names and shapes equal the reference's
``state_dict()`` (e.g. ``ernie.layers.0.attn.qkv.weight`` is (h, 3h)) and
its weights load by name (``models/convert.py``). Under mp each rank holds
its heads (``qkv`` cut head by head) and its vocabulary rows, and the MLM
logits are gathered over mp. Attention is
bidirectional, so ``scaled_dot_product_attention`` takes the exact path,
never the flash kernels (the reference sends non-causal calls there too).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.place import resolve_device
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..distributed.fleet.meta_parallel.mp_layers import tied_logits
from ..nn import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear
from ..nn import functional as F
from ..nn.initializer import Normal


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02


def _no_gen(kw):
    return {k: v for k, v in kw.items() if k != "generator"}


class ErnieSelfAttention(Layer):
    def __init__(self, config: ErnieConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = ColumnParallelLinear(h, 3 * h, has_bias=True,
                                        gather_output=False, fused_groups=3,
                                        **kw)
        if config.num_heads % self.qkv.world_size:
            raise ValueError(f"{config.num_heads} heads do not split over "
                             f"mp = {self.qkv.world_size}")
        self.out = RowParallelLinear(h, h, has_bias=True,
                                     input_is_parallel=True, **kw)
        self.dropout = config.attention_dropout

    def forward(self, x, attn_mask=None):
        B, T = x.shape[0], x.shape[1]
        qkv = self.qkv(x)
        local_h = qkv.shape[-1] // 3
        q, k, v = qkv.reshape(B, T, 3, local_h // self.head_dim,
                              self.head_dim).unbind(2)
        o = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False,
            dropout_p=self.dropout, training=self.training)
        return self.out(o.reshape(B, T, local_h))


class ErnieLayer(Layer):
    """Post-LN: ``ln1(x + drop(attn(x)))``, then
    ``ln2(x + drop(down(gelu(up(x)))))``."""

    def __init__(self, config: ErnieConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.attn = ErnieSelfAttention(config, **kw)
        self.ln1 = LayerNorm(h, **_no_gen(kw))
        self.up = ColumnParallelLinear(h, config.intermediate_size,
                                       has_bias=True, gather_output=False,
                                       **kw)
        self.down = RowParallelLinear(config.intermediate_size, h,
                                      has_bias=True, input_is_parallel=True,
                                      **kw)
        self.ln2 = LayerNorm(h, **_no_gen(kw))
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, x, attn_mask=None):
        x = self.ln1(x + self.dropout(self.attn(x, attn_mask)))
        return self.ln2(x + self.dropout(self.down(F.gelu(self.up(x)))))


class ErnieModel(Layer):
    def __init__(self, config: ErnieConfig, **kw):
        super().__init__()
        self.config = config
        init = Normal(std=config.initializer_range)
        h = config.hidden_size
        self.word_emb = VocabParallelEmbedding(config.vocab_size, h,
                                               weight_attr=init, **kw)
        self.pos_emb = Embedding(config.max_position_embeddings, h,
                                 weight_attr=init, **kw)
        self.type_emb = Embedding(config.type_vocab_size, h,
                                  weight_attr=init, **kw)
        self.emb_ln = LayerNorm(h, **_no_gen(kw))
        self.dropout = Dropout(config.hidden_dropout)
        self.layers = LayerList(
            [ErnieLayer(config, **kw) for _ in range(config.num_layers)])
        self.pooler = Linear(h, h, **kw)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attn_mask=None):
        T = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.word_emb(input_ids) + self.pos_emb(position_ids) \
            + self.type_emb(token_type_ids)
        x = self.dropout(self.emb_ln(x))
        for layer in self.layers:
            x = layer(x, attn_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class ErnieForPretraining(Layer):
    """MLM logits through a transform, LayerNorm and the word embedding
    (tied), and NSP logits from the pooled first token.

    Built on ``device`` (default ``get_device()``: the card unless the CPU
    was asked for) in ``dtype``, with random weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config: ErnieConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__(dtype=dtype)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = {"device": dev, "dtype": dtype, "generator": gen}
        h = config.hidden_size
        self.ernie = ErnieModel(config, **kw)
        self.mlm_transform = Linear(h, h, **kw)
        self.mlm_ln = LayerNorm(h, device=dev, dtype=dtype)
        self.nsp_head = Linear(h, 2, **kw)
        self.config = config

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids,
                                 attn_mask=attn_mask)
        h = self.mlm_ln(F.gelu(self.mlm_transform(seq)))
        mlm_logits = tied_logits(h, self.ernie.word_emb)
        return mlm_logits, self.nsp_head(pooled)

    def loss(self, input_ids, mlm_labels, nsp_labels=None):
        """Mean MLM cross-entropy over the labelled positions (label -100
        elsewhere), plus the NSP cross-entropy when ``nsp_labels`` is
        given."""
        mlm_logits, nsp_logits = self(input_ids)
        loss = F.cross_entropy(mlm_logits.reshape(-1, mlm_logits.shape[-1]),
                               mlm_labels.reshape(-1), ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + F.cross_entropy(nsp_logits, nsp_labels)
        return loss


def ernie_3_base(**kw):
    return ErnieConfig(**kw)
