"""Llama model family (port of ``paddle_tpu/models/llama.py``).

RMSNorm, rotary embeddings on interleaved pairs, grouped-query attention and
a SwiGLU MLP, with an untied LM head. Parameter names and shapes equal the
reference's ``state_dict()``: e.g. ``model.layers.0.self_attn.q_proj.weight``
is (h, h) in Paddle's (in, out) layout and ``lm_head.weight`` is (h, V), so
the reference's weights load by name (``models/convert.py``). The projections,
the embedding and the head are the port's model-parallel layers, as the
reference's are (``distributed/fleet/meta_parallel``): under mp each rank
holds its query and KV heads (the KV heads must split over mp) and the
head's columns, whose logits are gathered.
Attention in ``forward`` goes through
``nn.functional.scaled_dot_product_attention`` (the flash kernels on the
card for the causal training pass), with grouped-query attention's K/V
heads repeated before it, so the backward sums each KV head's gradient over
its query heads. Every class is an ``nn.Layer``, as GPT's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.place import resolve_device
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear,
                                               VocabParallelEmbedding)
from ..nn import Layer, LayerList
from ..nn import functional as F
from ..nn.initializer import Constant, Normal


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None
    intermediate_size: Optional[int] = None
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02

    @property
    def ffn_size(self):
        if self.intermediate_size is not None:
            return self.intermediate_size
        return int(2 * (4 * self.hidden_size) / 3 + 255) // 256 * 256

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads


class RMSNorm(Layer):
    """x times an f32 rsqrt of its mean square, cast back to x's dtype, then
    times the gain (the reference's order of rounding)."""

    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=Constant(1.0), device=device)
        self.eps = eps

    def forward(self, x):
        var = x.float().square().mean(-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


def rope_angles(pos, D, theta):
    """(..., D/2) f32 angles ``pos * theta^(-2i/D)`` for f32 positions."""
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                        device=pos.device) / D))
    return pos[..., None] * inv


def rotate_pairs(x, cos, sin):
    """Rotate the interleaved pairs (x[..., ::2], x[..., 1::2]) of x by the
    angles whose cos/sin broadcast against them."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def apply_rope(q, k, theta=10000.0):
    """Rotary embedding of (B, T, H, D) q/k at positions 0..T-1, rotated in
    f32 and cast back to each input's dtype."""
    T, D = q.shape[1], q.shape[-1]
    ang = rope_angles(torch.arange(T, dtype=torch.float32, device=q.device),
                      D, theta)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    return (rotate_pairs(q, cos, sin).to(q.dtype),
            rotate_pairs(k, cos, sin).to(k.dtype))


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.kv_heads = config.kv_heads
        self.head_dim = h // config.num_heads
        kvd = self.kv_heads * self.head_dim
        col = {"has_bias": False, "gather_output": False, **kw}
        self.q_proj = ColumnParallelLinear(h, h, **col)
        mp = self.q_proj.world_size
        if self.kv_heads % mp or self.num_heads % mp:
            raise ValueError(f"{self.num_heads} heads and {self.kv_heads} KV "
                             f"heads must both split over mp = {mp}")
        self.k_proj = ColumnParallelLinear(h, kvd, **col)
        self.v_proj = ColumnParallelLinear(h, kvd, **col)
        self.o_proj = RowParallelLinear(h, h, has_bias=False,
                                        input_is_parallel=True, **kw)
        self.theta = config.rope_theta

    def forward(self, x, attn_mask=None):
        B, T = x.shape[0], x.shape[1]
        # this rank's heads (all of them at mp = 1)
        q = self.q_proj(x).reshape(B, T, -1, self.head_dim)
        k = self.k_proj(x).reshape(B, T, -1, self.head_dim)
        v = self.v_proj(x).reshape(B, T, -1, self.head_dim)
        q, k = apply_rope(q, k, self.theta)
        if self.kv_heads != self.num_heads:  # GQA: q head h reads h // rep
            rep = self.num_heads // self.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            training=self.training)
        return self.o_proj(out.reshape(B, T, -1))


class LlamaMLP(Layer):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, f = config.hidden_size, config.ffn_size
        col = {"has_bias": False, "gather_output": False, **kw}
        self.gate_proj = ColumnParallelLinear(h, f, **col)
        self.up_proj = ColumnParallelLinear(h, f, **col)
        self.down_proj = RowParallelLinear(f, h, has_bias=False,
                                           input_is_parallel=True, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        nk = {k: v for k, v in kw.items() if k != "generator"}
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, **nk)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(config.hidden_size,
                                                config.rms_norm_eps, **nk)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, x, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size,
            weight_attr=Normal(std=config.initializer_range), **kw)
        self.layers = LayerList(
            [LlamaDecoderLayer(config, **kw) for _ in range(config.num_layers)])
        nk = {k: v for k, v in kw.items() if k != "generator"}
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **nk)

    def forward(self, input_ids, attn_mask=None):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return self.norm(x)


class LlamaForCausalLM(Layer):
    """Untied LM head over ``LlamaModel``.

    Built on ``device`` (default ``get_device()``: the card unless the CPU
    was asked for) in ``dtype``, with random weights drawn from a
    ``torch.Generator`` seeded with ``seed``; every parameter is created on
    the device. ``loss`` trains it, eagerly or through
    ``jit.compile_train_step``; ``generate`` is the dense KV-cached decode
    (``models/generation.py``), ``serving.Engine`` the paged one."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__(dtype=dtype)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = {"device": dev, "dtype": dtype, "generator": gen}
        self.model = LlamaModel(config, **kw)
        self.lm_head = ColumnParallelLinear(config.hidden_size,
                                            config.vocab_size, has_bias=False,
                                            gather_output=True, **kw)

    def forward(self, input_ids, attn_mask=None):
        return self.lm_head(self.model(input_ids, attn_mask))

    def loss(self, input_ids, labels):
        """Mean next-token cross-entropy against ``labels`` (B, T)."""
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, do_sample=True,
                 generator: Optional[torch.Generator] = None):
        """KV-cached dense decode (``models/generation.py``
        ``generate_llama``: RoPE at absolute cache positions, the cache
        holding the KV heads only). Sampled calls draw from ``generator``
        (a seeded one on the model's device when None)."""
        from .generation import generate_llama

        return generate_llama(
            self, input_ids, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, do_sample=do_sample,
            generator=generator)


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                       num_heads=4, max_position_embeddings=256, **kw)


def llama_7b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, **kw)
