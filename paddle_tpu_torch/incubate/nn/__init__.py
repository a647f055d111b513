"""Fused transformer layers (port of ``paddle_tpu/incubate/nn/__init__.py``).

Reference ``python/paddle/incubate/nn/layer/fused_transformer.py``
(FusedMultiHeadAttention, FusedFeedForward) backed by
``fused_attention_op.cu`` / ``fused_feedforward_op.cu``. The layers present
the same API and parameter names over the port's functional path
(attention through ``F.scaled_dot_product_attention``, which takes the
flash kernels where it is eligible).
"""
from __future__ import annotations

from ...nn import functional as F
from ...nn.layer.common import Dropout, Linear
from ...nn.layer.layers import Layer
from ...nn.layer.norm import LayerNorm

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]


class FusedMultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, kdim=None, vdim=None,
                 normalize_before=False, need_weights=False,
                 qkv_weight_attr=None, qkv_bias_attr=None,
                 linear_weight_attr=None, linear_bias_attr=None,
                 pre_ln_scale_attr=None, pre_ln_bias_attr=None,
                 ln_scale_attr=None, ln_bias_attr=None, epsilon=1e-05,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, generator=generator,
                               **kw)
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator,
                               **kw)
        self.norm = LayerNorm(embed_dim, epsilon=epsilon, **kw)
        self.dropout = Dropout(dropout_rate)
        self.attn_dropout_rate = attn_dropout_rate

    def forward(self, query, attn_mask=None, cache=None):
        residual = query
        x = self.norm(query) if self.normalize_before else query
        qkv = self.qkv_proj(x)
        B, T = qkv.shape[0], qkv.shape[1]
        q, k, v = qkv.reshape(B, T, 3, self.num_heads,
                              self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             training=self.training)
        out = self.out_proj(out.reshape(B, T, self.embed_dim))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedFeedForward(Layer):
    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-05, activation="relu", act_dropout_rate=None,
                 normalize_before=False, linear1_weight_attr=None,
                 linear1_bias_attr=None, linear2_weight_attr=None,
                 linear2_bias_attr=None, ln1_scale_attr=None,
                 ln1_bias_attr=None, ln2_scale_attr=None, ln2_bias_attr=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.normalize_before = normalize_before
        self.linear1 = Linear(d_model, dim_feedforward, generator=generator,
                              **kw)
        self.linear2 = Linear(dim_feedforward, d_model, generator=generator,
                              **kw)
        self.norm = LayerNorm(d_model, epsilon=epsilon, **kw)
        self.dropout1 = Dropout(act_dropout_rate
                                if act_dropout_rate is not None
                                else dropout_rate)
        self.dropout2 = Dropout(dropout_rate)
        self.activation = getattr(F, activation)

    def forward(self, src, cache=None):
        residual = src
        x = self.norm(src) if self.normalize_before else src
        x = self.linear2(self.dropout1(self.activation(self.linear1(x))))
        out = residual + self.dropout2(x)
        if not self.normalize_before:
            out = self.norm(out)
        return out


class FusedTransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, name=None, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate, attn_dropout_rate or dropout_rate,
            normalize_before=normalize_before, **kw)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate, activation=activation,
            act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **kw)

    def forward(self, src, src_mask=None, cache=None):
        out = self.fused_attn(src, attn_mask=src_mask)
        return self.ffn(out)
