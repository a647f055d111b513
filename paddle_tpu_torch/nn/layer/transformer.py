"""Transformer layers (port of ``paddle_tpu/nn/layer/transformer.py``):
``MultiHeadAttention`` with its ``Cache`` (self-attention keys and values,
grown along T) and ``StaticCache`` (cross-attention keys and values,
computed once), the encoder and decoder layers and stacks, and
``Transformer``.

The reference's choices, each kept: the attention runs through
``F.scaled_dot_product_attention`` on (B, T, H, D) with an additive mask and
no ``is_causal``, so it takes the exact path (never the flash kernels); a
bool mask becomes ``(1 - m) * -1e9``; dropout is applied to the attention's
output, not to its probabilities; ``need_weights`` appends ``None``; the
encoder and decoder layers do not pass ``weight_attr``/``bias_attr`` to
their sublayers; the decoder layer's feed-forward output is added without
dropout; ``generate_square_subsequent_mask`` is float32 -inf above the
diagonal.
"""
from __future__ import annotations

import collections
import copy

import torch

from .. import functional as F
from .common import Dropout, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm


def _copies(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it, each copy's
    parameters under fresh names (the optimizers key their state by name
    when given bare parameters)."""
    from ...utils import unique_name

    out = [layer]
    for _ in range(num_layers - 1):
        c = copy.deepcopy(layer)
        for p in c.parameters():
            p.name = unique_name.generate("param")
        out.append(c)
    return LayerList(out)


def _convert_attention_mask(attn_mask):
    if attn_mask is None or attn_mask.dtype != torch.bool:
        return attn_mask
    return (1.0 - attn_mask.to(torch.float32)) * -1e9


class MultiHeadAttention(Layer):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout, self.need_weights = dropout, need_weights
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr,
                             bias_attr, **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _heads(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], 1)
            v = torch.cat([cache.v, v], 1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key``'s (and ``value``'s) projections when
        ``type`` is ``StaticCache``, else an empty ``Cache``."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        z = torch.zeros(key.shape[0], 0, self.num_heads, self.head_dim,
                        dtype=self.q_proj.weight.dtype, device=key.device)
        return self.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=_convert_attention_mask(attn_mask),
            training=self.training)
        out = out.reshape(out.shape[0], out.shape[1], self.embed_dim)
        if self.dropout and self.training:
            out = F.dropout(out, self.dropout, training=self.training)
        out = self.out_proj(out)
        outs = [out]
        if self.need_weights:
            outs.append(None)
        if cache is not None:
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)


def _sublayer_kw(device, dtype, generator):
    return {"device": device, "dtype": dtype, "generator": generator}


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        kw = _sublayer_kw(device, dtype, generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(
            d_model, nhead,
            attn_dropout if attn_dropout is not None else dropout, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(act_dropout if act_dropout is not None
                                else dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout2(self.activation(self.linear1(src))))
        src = residual + self.dropout(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)


class TransformerEncoder(Layer):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself), then ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(encoder_layer, num_layers)
        self.num_layers, self.norm = num_layers, norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, src_mask)
            else:
                output, c = layer(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.self_attn.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        kw = _sublayer_kw(device, dtype, generator)
        self.normalize_before = normalize_before
        p_attn = attn_dropout if attn_dropout is not None else dropout
        self.self_attn = MultiHeadAttention(d_model, nhead, p_attn, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, p_attn, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, **kw)
        self.linear2 = Linear(dim_feedforward, d_model, **kw)
        self.norm1 = LayerNorm(d_model, **kw)
        self.norm2 = LayerNorm(d_model, **kw)
        self.norm3 = LayerNorm(d_model, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(act_dropout if act_dropout is not None
                                else dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incr_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                             cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = residual + self.linear2(self.dropout3(self.activation(
            self.linear1(tgt))))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incr_cache, static_cache))

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(
            memory, type=MultiHeadAttention.Cache)
        static = self.cross_attn.gen_cache(
            memory, memory, type=MultiHeadAttention.StaticCache)
        return incremental, static


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = _copies(decoder_layer, num_layers)
        self.num_layers, self.norm = num_layers, norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, layer in enumerate(self.layers):
            if cache is None:
                output = layer(output, memory, tgt_mask, memory_mask)
            else:
                output, c = layer(output, memory, tgt_mask, memory_mask,
                                  cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """Encoder and decoder stacks (post-norm unless ``normalize_before``,
    which adds a final LayerNorm to each stack); the defaults are the
    Transformer base."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        kw = _sublayer_kw(device, dtype, generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            self.encoder = TransformerEncoder(
                layer, num_encoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, **kw)
            self.decoder = TransformerDecoder(
                layer, num_decoder_layers,
                LayerNorm(d_model, **kw) if normalize_before else None)
        self.d_model, self.nhead = d_model, nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length):
        """(length, length) float32: 0 on and below the diagonal, -inf
        above, on ``get_device()``."""
        from ...core.place import resolve_device

        return torch.triu(torch.full((length, length), float("-inf"),
                                     dtype=torch.float32,
                                     device=resolve_device()), 1)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]
