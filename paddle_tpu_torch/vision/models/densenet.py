"""DenseNet (port of ``paddle_tpu/vision/models/densenet.py``)."""
from __future__ import annotations

import torch

from ... import nn


class _DenseLayer(nn.Layer):
    def __init__(self, num_input_features, growth_rate, bn_size, drop_rate,
                 *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.norm1 = nn.BatchNorm2D(num_input_features, **kw)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input_features, bn_size * growth_rate, 1,
                               bias_attr=False, **kw)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate, **kw)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False, **kw)
        self.drop_rate = drop_rate
        self.dropout = nn.Dropout(drop_rate) if drop_rate else None

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        if self.dropout is not None:
            out = self.dropout(out)
        return torch.cat([x, out], 1)


class _Transition(nn.Sequential):
    def __init__(self, num_input_features, num_output_features, *,
                 device=None, dtype=None, generator=None):
        kw = {"device": device, "dtype": dtype, "generator": generator}
        super().__init__(
            nn.BatchNorm2D(num_input_features, **kw),
            nn.ReLU(),
            nn.Conv2D(num_input_features, num_output_features, 1,
                      bias_attr=False, **kw),
            nn.AvgPool2D(2, stride=2),
        )


class DenseNet(nn.Layer):
    CFG = {
        121: (6, 12, 24, 16),
        161: (6, 12, 36, 24),
        169: (6, 12, 32, 32),
        201: (6, 12, 48, 32),
        264: (6, 12, 64, 48),
    }

    def __init__(self, layers=121, growth_rate=32, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        block_config = self.CFG[layers]
        if layers == 161:
            growth_rate, num_init_features = 48, 96
        else:
            num_init_features = 64
        self.features = nn.Sequential(
            nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(num_init_features, **kw),
            nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        num_features = num_init_features
        blocks = []
        for i, num_layers in enumerate(block_config):
            for j in range(num_layers):
                blocks.append(_DenseLayer(num_features + j * growth_rate,
                                          growth_rate, bn_size, dropout,
                                          **kw))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                blocks.append(_Transition(num_features, num_features // 2,
                                          **kw))
                num_features //= 2
        self.blocks = nn.Sequential(*blocks)
        self.norm_final = nn.BatchNorm2D(num_features, **kw)
        self.relu = nn.ReLU()
        self.pool = nn.AdaptiveAvgPool2D(1) if with_pool else None
        self.classifier = nn.Linear(num_features, num_classes, **kw) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.features(x)
        x = self.relu(self.norm_final(self.blocks(x)))
        if self.pool is not None:
            x = self.pool(x)
        if self.classifier is not None:
            x = self.classifier(x.flatten(1))
        return x


def densenet121(pretrained=False, **kw):
    return DenseNet(121, **kw)


def densenet161(pretrained=False, **kw):
    return DenseNet(161, **kw)


def densenet169(pretrained=False, **kw):
    return DenseNet(169, **kw)


def densenet201(pretrained=False, **kw):
    return DenseNet(201, **kw)


def densenet264(pretrained=False, **kw):
    return DenseNet(264, **kw)
