"""GPT model family (port of ``paddle_tpu/models/gpt.py``).

Parameter names and shapes equal the reference's ``state_dict()``: e.g.
``gpt.layers.0.attn.qkv.weight`` is (h, 3h) in Paddle's (in, out) layout and
``gpt.embeddings.word_embeddings.weight`` is (V, h), so the reference's
weights load by name (``models/convert.py``). The LM head is tied to the
word embedding. Attention in ``forward`` is the plain causal path (a masked
softmax); dropout applies only in ``train()`` mode, serving runs ``eval()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.place import resolve_device
from ..nn import Embedding, LayerNorm, Linear


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    initializer_range: float = 0.02

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.head_dim = h // config.num_heads
        self.qkv = Linear(h, 3 * h, **kw)
        self.proj = Linear(h, h, **kw)
        self.attn_dropout = config.attention_dropout

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).reshape(B, T, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(self.head_dim))
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        p = F.dropout(p, self.attn_dropout, self.training)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.proj(out.reshape(B, T, -1))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.up = Linear(h, config.ffn_size, **kw)
        self.down = Linear(config.ffn_size, h, **kw)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        fk = {k: v for k, v in kw.items() if k != "generator"}
        self.ln1 = LayerNorm(config.hidden_size, epsilon=1e-5, **fk)
        self.attn = GPTAttention(config, **kw)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=1e-5, **fk)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, x):
        x = x + self.dropout(self.attn(self.ln1(x)))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPTEmbeddings(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        std = config.initializer_range
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size,
                                         std=std, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size, std=std, **kw)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
        return self.dropout(x)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **kw)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, **kw) for _ in range(config.num_layers)])
        fk = {k: v for k, v in kw.items() if k != "generator"}
        self.final_ln = LayerNorm(config.hidden_size, epsilon=1e-5, **fk)

    def forward(self, input_ids, position_ids=None):
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x)
        return self.final_ln(x)


class GPTForPretraining(nn.Module):
    """LM head tied to the word embedding.

    Built on ``device`` (``cuda`` unless the caller passes ``"cpu"``) in
    ``dtype``, with random weights drawn from a ``torch.Generator`` seeded
    with ``seed``."""

    def __init__(self, config: GPTConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype, generator=gen)

    def forward(self, input_ids, position_ids=None):
        x = self.gpt(input_ids, position_ids)
        return x @ self.gpt.embeddings.word_embeddings.weight.T


# -- standard configs --------------------------------------------------------
def gpt_tiny(**kw):
    return GPTConfig(
        vocab_size=1024, hidden_size=128, num_layers=4, num_heads=4,
        max_position_embeddings=256, **kw,
    )


def gpt3_1p3b(**kw):
    """GPT-3 1.3B (the repo's BASELINE north-star config)."""
    return GPTConfig(
        vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
        max_position_embeddings=2048, **kw,
    )


def gpt3_13b(**kw):
    return GPTConfig(
        vocab_size=50304, hidden_size=5120, num_layers=40, num_heads=40,
        max_position_embeddings=2048, **kw,
    )
