"""InceptionV3 (port of ``paddle_tpu/vision/models/inceptionv3.py``)."""
from __future__ import annotations

import torch

from ... import nn


class ConvBN(nn.Sequential):
    def __init__(self, cin, cout, k, stride=1, padding=0, *, device=None,
                 dtype=None, generator=None):
        kw = {"device": device, "dtype": dtype, "generator": generator}
        super().__init__(
            nn.Conv2D(cin, cout, k, stride=stride, padding=padding,
                      bias_attr=False, **kw),
            nn.BatchNorm2D(cout, **kw),
            nn.ReLU(),
        )


def _cat(xs):
    return torch.cat(xs, 1)


class InceptionA(nn.Layer):
    def __init__(self, cin, pool_features, **kw):
        super().__init__()
        self.b1 = ConvBN(cin, 64, 1, **kw)
        self.b5 = nn.Sequential(ConvBN(cin, 48, 1, **kw),
                                ConvBN(48, 64, 5, padding=2, **kw))
        self.b3 = nn.Sequential(
            ConvBN(cin, 64, 1, **kw), ConvBN(64, 96, 3, padding=1, **kw),
            ConvBN(96, 96, 3, padding=1, **kw))
        self.pool = nn.Sequential(nn.AvgPool2D(3, 1, 1),
                                  ConvBN(cin, pool_features, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b5(x), self.b3(x), self.pool(x)])


class InceptionB(nn.Layer):
    def __init__(self, cin, **kw):
        super().__init__()
        self.b3 = ConvBN(cin, 384, 3, stride=2, **kw)
        self.b3d = nn.Sequential(
            ConvBN(cin, 64, 1, **kw), ConvBN(64, 96, 3, padding=1, **kw),
            ConvBN(96, 96, 3, stride=2, **kw))
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b3d(x), self.pool(x)])


class InceptionC(nn.Layer):
    def __init__(self, cin, c7, **kw):
        super().__init__()
        self.b1 = ConvBN(cin, 192, 1, **kw)
        self.b7 = nn.Sequential(
            ConvBN(cin, c7, 1, **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, 192, (7, 1), padding=(3, 0), **kw),
        )
        self.b7d = nn.Sequential(
            ConvBN(cin, c7, 1, **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, c7, (1, 7), padding=(0, 3), **kw),
            ConvBN(c7, c7, (7, 1), padding=(3, 0), **kw),
            ConvBN(c7, 192, (1, 7), padding=(0, 3), **kw),
        )
        self.pool = nn.Sequential(nn.AvgPool2D(3, 1, 1),
                                  ConvBN(cin, 192, 1, **kw))

    def forward(self, x):
        return _cat([self.b1(x), self.b7(x), self.b7d(x), self.pool(x)])


class InceptionD(nn.Layer):
    def __init__(self, cin, **kw):
        super().__init__()
        self.b3 = nn.Sequential(ConvBN(cin, 192, 1, **kw),
                                ConvBN(192, 320, 3, stride=2, **kw))
        self.b7 = nn.Sequential(
            ConvBN(cin, 192, 1, **kw),
            ConvBN(192, 192, (1, 7), padding=(0, 3), **kw),
            ConvBN(192, 192, (7, 1), padding=(3, 0), **kw),
            ConvBN(192, 192, 3, stride=2, **kw),
        )
        self.pool = nn.MaxPool2D(3, 2)

    def forward(self, x):
        return _cat([self.b3(x), self.b7(x), self.pool(x)])


class InceptionE(nn.Layer):
    def __init__(self, cin, **kw):
        super().__init__()
        self.b1 = ConvBN(cin, 320, 1, **kw)
        self.b3_1 = ConvBN(cin, 384, 1, **kw)
        self.b3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.b3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.bd_1 = nn.Sequential(ConvBN(cin, 448, 1, **kw),
                                  ConvBN(448, 384, 3, padding=1, **kw))
        self.bd_2a = ConvBN(384, 384, (1, 3), padding=(0, 1), **kw)
        self.bd_2b = ConvBN(384, 384, (3, 1), padding=(1, 0), **kw)
        self.pool = nn.Sequential(nn.AvgPool2D(3, 1, 1),
                                  ConvBN(cin, 192, 1, **kw))

    def forward(self, x):
        a = self.b3_1(x)
        d = self.bd_1(x)
        return _cat([
            self.b1(x),
            _cat([self.b3_2a(a), self.b3_2b(a)]),
            _cat([self.bd_2a(d), self.bd_2b(d)]),
            self.pool(x),
        ])


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.stem = nn.Sequential(
            ConvBN(3, 32, 3, stride=2, **kw), ConvBN(32, 32, 3, **kw),
            ConvBN(32, 64, 3, padding=1, **kw),
            nn.MaxPool2D(3, 2), ConvBN(64, 80, 1, **kw),
            ConvBN(80, 192, 3, **kw), nn.MaxPool2D(3, 2),
        )
        self.blocks = nn.Sequential(
            InceptionA(192, 32, **kw), InceptionA(256, 64, **kw),
            InceptionA(288, 64, **kw),
            InceptionB(288, **kw),
            InceptionC(768, 128, **kw), InceptionC(768, 160, **kw),
            InceptionC(768, 160, **kw), InceptionC(768, 192, **kw),
            InceptionD(768, **kw),
            InceptionE(1280, **kw), InceptionE(2048, **kw),
        )
        self.pool = nn.AdaptiveAvgPool2D(1) if with_pool else None
        self.dropout = nn.Dropout(0.5)
        self.fc = nn.Linear(2048, num_classes, **kw) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.pool is not None:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kw):
    return InceptionV3(**kw)
