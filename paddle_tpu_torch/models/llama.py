"""Llama model family (port of ``paddle_tpu/models/llama.py``).

RMSNorm, rotary embeddings on interleaved pairs, grouped-query attention and
a SwiGLU MLP, with an untied LM head. Parameter names and shapes equal the
reference's ``state_dict()``: e.g. ``model.layers.0.self_attn.q_proj.weight``
is (h, h) in Paddle's (in, out) layout and ``lm_head.weight`` is (h, V), so
the reference's weights load by name (``models/convert.py``). Attention in
``forward`` goes through ``nn.functional.scaled_dot_product_attention``, as
GPT's does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as TF
from torch import nn

from ..core.place import resolve_device
from ..nn import Embedding, Linear
from ..nn import functional as F


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


class RMSNorm(nn.Module):
    """x times an f32 rsqrt of its mean square, cast back to x's dtype, then
    times the gain (the reference's order of rounding)."""

    def __init__(self, hidden_size, eps=1e-6, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(
            hidden_size, device=resolve_device(device), dtype=dtype))
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


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_heads
        self.kv_heads = config.kv_heads
        self.head_dim = h // config.num_heads
        kvd = self.kv_heads * self.head_dim
        self.q_proj = Linear(h, h, bias=False, **kw)
        self.k_proj = Linear(h, kvd, bias=False, **kw)
        self.v_proj = Linear(h, kvd, bias=False, **kw)
        self.o_proj = Linear(h, h, bias=False, **kw)
        self.theta = config.rope_theta

    def forward(self, x, attn_mask=None):
        B, T = x.shape[0], x.shape[1]
        q = self.q_proj(x).reshape(B, T, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(B, T, self.kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(B, T, self.kv_heads, self.head_dim)
        q, k = apply_rope(q, k, self.theta)
        if self.kv_heads != self.num_heads:  # GQA: q head h reads h // rep
            rep = self.num_heads // self.kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            training=self.training)
        return self.o_proj(out.reshape(B, T, -1))


class LlamaMLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        h, f = config.hidden_size, config.ffn_size
        self.gate_proj = Linear(h, f, bias=False, **kw)
        self.up_proj = Linear(h, f, bias=False, **kw)
        self.down_proj = Linear(f, h, bias=False, **kw)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
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


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **kw):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      std=config.initializer_range, **kw)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **kw) for _ in range(config.num_layers)])
        nk = {k: v for k, v in kw.items() if k != "generator"}
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **nk)

    def forward(self, input_ids, attn_mask=None):
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, attn_mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Untied LM head over ``LlamaModel``.

    Built on ``device`` (``cuda`` unless the caller passes ``"cpu"``) in
    ``dtype``, with random weights drawn from a ``torch.Generator`` seeded
    with ``seed``; every parameter is created on the device. ``generate``
    (dense KV-cached decode) is not ported yet (ROADMAP A9); serve through
    ``serving.Engine``."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype: Optional[torch.dtype] = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        kw = {"device": dev, "dtype": dtype, "generator": gen}
        self.model = LlamaModel(config, **kw)
        self.lm_head = Linear(config.hidden_size, config.vocab_size,
                              bias=False, **kw)

    def forward(self, input_ids, attn_mask=None):
        return self.lm_head(self.model(input_ids, attn_mask))

    def loss(self, input_ids, labels):
        """Mean next-token cross-entropy against ``labels`` (B, T)."""
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))


def llama_tiny(**kw):
    return LlamaConfig(vocab_size=1024, hidden_size=128, num_layers=4,
                       num_heads=4, max_position_embeddings=256, **kw)


def llama_7b(**kw):
    return LlamaConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                       num_heads=32, **kw)
