"""GoogLeNet, Inception v1 (port of
``paddle_tpu/vision/models/googlenet.py``)."""
from __future__ import annotations

import torch

from ... import nn


class Inception(nn.Layer):
    def __init__(self, in_ch, c1, c2_red, c2, c3_red, c3, c4, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.b1 = nn.Sequential(nn.Conv2D(in_ch, c1, 1, **kw), nn.ReLU())
        self.b2 = nn.Sequential(
            nn.Conv2D(in_ch, c2_red, 1, **kw), nn.ReLU(),
            nn.Conv2D(c2_red, c2, 3, padding=1, **kw), nn.ReLU())
        self.b3 = nn.Sequential(
            nn.Conv2D(in_ch, c3_red, 1, **kw), nn.ReLU(),
            nn.Conv2D(c3_red, c3, 5, padding=2, **kw), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(in_ch, c4, 1, **kw), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], 1)


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True, *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
            nn.Conv2D(64, 64, 1, **kw), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1, **kw), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32, **kw)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64, **kw)
        self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64, **kw)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64, **kw)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64, **kw)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64, **kw)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128, **kw)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128, **kw)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128, **kw)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.dropout = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes, **kw)

    def forward(self, x):
        x = self.stem(x)
        x = self.inc3b(self.inc3a(x))
        x = self.pool3(x)
        x = self.inc4e(self.inc4d(self.inc4c(self.inc4b(self.inc4a(x)))))
        x = self.pool4(x)
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.dropout(x.flatten(1))
            x = self.fc(x)
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
