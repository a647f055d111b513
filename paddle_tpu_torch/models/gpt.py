"""GPT model family (port of ``paddle_tpu/models/gpt.py``).

Parameter names and shapes equal the reference's ``state_dict()``: e.g.
``gpt.layers.0.attn.qkv.weight`` is (h, 3h) in Paddle's (in, out) layout and
``gpt.embeddings.word_embeddings.weight`` is (V, h), so the reference's
weights load by name (``models/convert.py``). The LM head is tied to the
word embedding. The projections and the word embedding are the mp layers,
as in the reference (``VocabParallelEmbedding``, ``ColumnParallelLinear``
for ``qkv`` and ``up``, ``RowParallelLinear`` for ``proj`` and ``down``,
whose bias is added after the matmul, outside ``linear``: under
``amp.auto_cast`` the sum then follows its inputs, as the reference's
does). Built after ``fleet.init`` with mp > 1, each rank holds its shard:
its heads (``qkv`` cut head by head, ``fused_groups=3``) and its rows of
the vocabulary, and the loss is the vocab-parallel fused CE on the tied,
sharded weight. With ``sequence_parallel=True`` and an sp group of more
than one rank, each rank holds T/sp tokens at their global positions
``r * T/sp + arange(T/sp)``, and attention runs as ring attention over the
sp group (``attention_impl`` "auto" or "ring", the reference's dropout
rule); the other paths gather the sequence's q, k and v and keep this
rank's rows. Every class is an
``nn.Layer`` (a ``torch.nn.Module`` with Paddle's API), so the Paddle-API
loop (``to_tensor`` ids, ``loss.backward()``, ``opt.step()``,
``opt.clear_grad()``) runs on it as it does on the reference's. Attention
in ``forward`` goes through
``nn.functional.scaled_dot_product_attention`` (the flash kernels on the card
when eligible, the exact masked softmax otherwise); dropout draws from the
port's generators (``core/random``) and applies only in ``train()`` mode,
serving runs ``eval()``. ``GPTForPretraining.loss`` is the training loss,
fused (``ops/fused_ce.py``) or through full logits; ``generate`` the dense
KV-cached decode (``models/generation.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.place import resolve_device
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..distributed.fleet.meta_parallel import sequence_parallel as _sp
from ..distributed.fleet.meta_parallel.mp_layers import tied_logits
from ..nn import Dropout, Embedding, Layer, LayerList, LayerNorm
from ..nn import functional as F
from ..nn.initializer import Normal


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
    use_mp_layers: bool = True  # a VocabParallelEmbedding (else Embedding)
    fused_lm_loss: bool = True  # blockwise head+CE, no (B*T, V) logits tensor
    remat: bool = False  # recompute each decoder layer in the backward
    sequence_parallel: bool = False  # shard the sequence over the sp group
    # "auto": ring attention when sequence_parallel and an sp group of more
    # than one rank, else the flash kernels when eligible (see
    # scaled_dot_product_attention); "ring" forces the ring under sp;
    # "exact"/"flash" force one path
    attention_impl: str = "auto"

    @property
    def ffn_size(self):
        return self.intermediate_size or 4 * self.hidden_size


class GPTAttention(Layer):
    def __init__(self, config: GPTConfig, **kw):
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
        self.proj = RowParallelLinear(h, h, has_bias=True,
                                      input_is_parallel=True, **kw)
        self.attn_dropout = config.attention_dropout
        if config.attention_impl not in ("auto", "ring", "exact", "flash"):
            raise ValueError("attention_impl must be auto|ring|exact|flash, "
                             f"got {config.attention_impl!r}")
        self.config = config
        self.impl = (config.attention_impl
                     if config.attention_impl in ("exact", "flash") else None)

    def _ring_group(self):
        """The sp group iff ring attention runs (reference gpt.py:90):
        sequence_parallel on, impl auto or ring, an sp group of more than
        one rank, and no attention dropout in play (ring, like flash, never
        forms the score matrix a dropout mask applies to)."""
        cfg = self.config
        if not cfg.sequence_parallel or cfg.attention_impl not in ("auto",
                                                                   "ring"):
            return None
        if self.attn_dropout and self.training:
            if cfg.attention_impl == "ring":
                raise ValueError("attention_impl='ring' does not support "
                                 "attention_dropout>0 while training; set "
                                 "attention_dropout=0.0")
            return None
        return _sp.sp_group()

    def forward(self, x):
        B, T = x.shape[0], x.shape[1]
        qkv = self.qkv(x)  # (B, T, 3H/mp): this rank's heads' q, k, v
        local_h = qkv.shape[-1] // 3
        q, k, v = qkv.reshape(B, T, 3, local_h // self.head_dim,
                              self.head_dim).unbind(2)
        ring = self._ring_group()
        if ring is not None:
            out = _sp.ring_attention(q, k, v, ring, causal=True)
        else:
            group = _sp.sp_group() if self.config.sequence_parallel else None
            if group is not None:  # the whole sequence, then this rank's rows
                q, k, v = (_sp.gather_sequence(t, group) for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout,
                training=self.training, impl=self.impl)
            if group is not None:
                out = _sp.split_sequence(out, group)
        return self.proj(out.reshape(B, T, local_h))


class GPTMLP(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.up = ColumnParallelLinear(h, config.ffn_size, has_bias=True,
                                       gather_output=False, **kw)
        self.down = RowParallelLinear(config.ffn_size, h, has_bias=True,
                                      input_is_parallel=True, **kw)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate=True))


class GPTDecoderLayer(Layer):
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


class GPTEmbeddings(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        init = Normal(std=config.initializer_range)
        emb = VocabParallelEmbedding if config.use_mp_layers else Embedding
        self.word_embeddings = emb(config.vocab_size, config.hidden_size,
                                   weight_attr=init, **kw)
        self.sequence_parallel = config.sequence_parallel
        self.position_embeddings = Embedding(
            config.max_position_embeddings, config.hidden_size,
            weight_attr=init, **kw)
        self.dropout = Dropout(config.hidden_dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            T = input_ids.shape[1]
            group = _sp.sp_group() if self.sequence_parallel else None
            start = group.rank * T if group is not None else 0  # global
            position_ids = torch.arange(start, start + T,
                                        device=input_ids.device)[None]
        x = self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
        return self.dropout(x)


class GPTModel(Layer):
    def __init__(self, config: GPTConfig, **kw):
        super().__init__()
        self.config = config
        self.embeddings = GPTEmbeddings(config, **kw)
        self.layers = LayerList(
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


def _remat(layer, x):
    """Activation checkpointing of one decoder layer through
    ``fleet.utils.recompute``, which replays the port's generator in the
    recompute so the dropout masks are the forward's."""
    from ..distributed.fleet.utils import recompute

    return recompute(layer, x)


class GPTForPretraining(Layer):
    """LM head tied to the word embedding.

    Built on ``device`` (default ``get_device()``: the card unless the CPU
    was asked for) in ``dtype``, with random weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, config: GPTConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__(dtype=dtype)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.config = config
        self.gpt = GPTModel(config, device=dev, dtype=dtype, generator=gen)

    def forward(self, input_ids, position_ids=None):
        x = self.gpt(input_ids, position_ids)
        return tied_logits(x, self.gpt.embeddings.word_embeddings)

    def loss(self, input_ids, labels):
        """Mean next-token cross-entropy against ``labels`` (B, T)."""
        if self.config.fused_lm_loss:
            x = self.gpt(input_ids)
            emb = self.gpt.embeddings.word_embeddings
            return F.fused_linear_cross_entropy(
                x, emb.weight, labels,
                group=emb.group if getattr(emb, "world_size", 1) > 1
                else None)
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, do_sample=True,
                 num_beams=1, length_penalty=0.0,
                 generator: Optional[torch.Generator] = None):
        """KV-cached dense decode (``models/generation.py`` ``generate``):
        greedy, sampled (uniforms from ``generator``, else the port's
        generator of the device) or, with ``num_beams > 1``, beam search
        under the GNMT ``length_penalty``."""
        from .generation import generate as _generate

        return _generate(
            self, input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, do_sample=do_sample,
            num_beams=num_beams, length_penalty=length_penalty,
            generator=generator)


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
