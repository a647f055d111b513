"""GPT model family (port of ``paddle_tpu/models/gpt.py``).

Parameter names and shapes equal the reference's ``state_dict()``: e.g.
``gpt.layers.0.attn.qkv.weight`` is (h, 3h) in Paddle's (in, out) layout and
``gpt.embeddings.word_embeddings.weight`` is (V, h), so the reference's
weights load by name (``models/convert.py``). The LM head is tied to the
word embedding. Attention in ``forward`` goes through
``nn.functional.scaled_dot_product_attention`` (the flash kernels on the card
when eligible, the exact masked softmax otherwise); dropout draws from the
port's generators (``core/random``) and applies only in ``train()`` mode,
serving runs ``eval()``. ``GPTForPretraining.loss`` is the training loss,
fused (``ops/fused_ce.py``) or through full logits.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import random as random_state
from ..core.place import resolve_device
from ..nn import Dropout, Embedding, LayerNorm, Linear
from ..nn import functional as F


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
    fused_lm_loss: bool = True  # blockwise head+CE, no (B*T, V) logits tensor
    remat: bool = False  # recompute each decoder layer in the backward
    # "auto": the flash kernels when eligible (see scaled_dot_product_attention),
    # "exact"/"flash" force one path; "ring" is the reference's
    # sequence-parallel path, not ported yet (ROADMAP A18)
    attention_impl: str = "auto"

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
        if config.attention_impl not in ("auto", "ring", "exact", "flash"):
            raise ValueError("attention_impl must be auto|ring|exact|flash, "
                             f"got {config.attention_impl!r}")
        if config.attention_impl == "ring":
            raise NotImplementedError(
                "attention_impl='ring' (sequence-parallel ring attention) is "
                "not ported yet: ROADMAP A18 (distributed)")
        self.impl = (config.attention_impl
                     if config.attention_impl in ("exact", "flash") else None)

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        q, k, v = self.qkv(x).reshape(B, T, 3, self.num_heads,
                                      self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.attn_dropout,
            training=self.training, impl=self.impl)
        return self.proj(out.reshape(B, T, -1))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.up = Linear(h, config.ffn_size, **kw)
        self.down = Linear(config.ffn_size, h, **kw)

    def forward(self, x):
        return self.down(TF.gelu(self.up(x), approximate="tanh"))


class GPTDecoderLayer(nn.Module):
    """Pre-LN decoder block."""

    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        fk = {k: v for k, v in kw.items() if k != "generator"}
        self.ln1 = LayerNorm(config.hidden_size, epsilon=1e-5, **fk)
        self.attn = GPTAttention(config, **kw)
        self.ln2 = LayerNorm(config.hidden_size, epsilon=1e-5, **fk)
        self.mlp = GPTMLP(config, **kw)
        self.dropout = Dropout(config.hidden_dropout)

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
        self.dropout = Dropout(config.hidden_dropout)

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
            if self.config.remat and torch.is_grad_enabled():
                x = _remat(layer, x)
            else:
                x = layer(x)
        return self.final_ln(x)


@contextlib.contextmanager
def _generator_state(gen, state):
    """Run with ``gen`` set to ``state``, then put its state back."""
    saved = gen.get_state()
    gen.set_state(state)
    try:
        yield
    finally:
        gen.set_state(saved)


def _remat(layer, x):
    """Activation checkpointing of one decoder layer. Its dropout draws from
    the port's generator, which torch's checkpoint does not replay, so the
    recompute restarts that generator from the forward's state and draws
    the same masks."""
    gen = random_state.default_generator(x.device)
    state = gen.get_state()
    return checkpoint(
        layer, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(),
                            _generator_state(gen, state)))


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

    def loss(self, input_ids, labels):
        """Mean next-token cross-entropy against ``labels`` (B, T)."""
        if self.config.fused_lm_loss:
            x = self.gpt(input_ids)
            w = self.gpt.embeddings.word_embeddings.weight
            return F.fused_linear_cross_entropy(x, w, labels)
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))


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
