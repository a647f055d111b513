"""Vision Transformer, ViT-B/16 and ViT-L/16 (port of
``paddle_tpu/vision/models/vit.py``): a strided-convolution patch
embedding, a class token, learned positions and a pre-norm
``nn.TransformerEncoder``. Its attention is not causal, so it takes the
exact path (``nn.functional.attention``), not the flash kernel."""
from __future__ import annotations

import torch

from ... import nn


class PatchEmbed(nn.Layer):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = nn.Conv2D(in_chans, embed_dim, kernel_size=patch_size,
                              stride=patch_size, device=device, dtype=dtype,
                              generator=generator)

    def forward(self, x):
        x = self.proj(x)  # (B, E, H/P, W/P)
        return x.flatten(2).transpose(1, 2)  # (B, N, E)


class VisionTransformer(nn.Layer):
    def __init__(
        self, img_size=224, patch_size=16, in_chans=3, num_classes=1000,
        embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, dropout=0.0,
        *, device=None, dtype=None, generator=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        n = self.patch_embed.num_patches
        init = nn.initializer.TruncatedNormal(std=0.02)
        self.cls_token = self.create_parameter(
            [1, 1, embed_dim], dtype=dtype, default_initializer=init,
            device=device, generator=generator)
        self.pos_embed = self.create_parameter(
            [1, n + 1, embed_dim], dtype=dtype, default_initializer=init,
            device=device, generator=generator)
        self.pos_drop = nn.Dropout(dropout)
        enc_layer = nn.TransformerEncoderLayer(
            embed_dim, num_heads, int(embed_dim * mlp_ratio),
            dropout=dropout, activation="gelu", normalize_before=True, **kw)
        self.encoder = nn.TransformerEncoder(
            enc_layer, depth, norm=nn.LayerNorm(embed_dim, **kw))
        self.head = nn.Linear(embed_dim, num_classes, **kw) \
            if num_classes > 0 else nn.Identity()

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], 1)
        x = self.pos_drop(x + self.pos_embed)
        x = self.encoder(x)
        return self.head(x[:, 0])


def vit_b_16(num_classes=1000, **kwargs):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12,
                             num_classes=num_classes, **kwargs)


def vit_l_16(num_classes=1000, **kwargs):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16,
                             num_classes=num_classes, **kwargs)
