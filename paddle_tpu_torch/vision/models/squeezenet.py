"""SqueezeNet 1.0 and 1.1 (port of
``paddle_tpu/vision/models/squeezenet.py``)."""
from __future__ import annotations

import torch

from ... import nn


class Fire(nn.Layer):
    def __init__(self, inplanes, squeeze_planes, expand1x1_planes,
                 expand3x3_planes, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.squeeze = nn.Conv2D(inplanes, squeeze_planes, 1, **kw)
        self.expand1x1 = nn.Conv2D(squeeze_planes, expand1x1_planes, 1, **kw)
        self.expand3x3 = nn.Conv2D(squeeze_planes, expand3x3_planes, 3,
                                   padding=1, **kw)
        self.relu = nn.ReLU()

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return torch.cat([self.relu(self.expand1x1(x)),
                          self.relu(self.expand3x3(x))], 1)


class SqueezeNet(nn.Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.num_classes = num_classes
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(96, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                Fire(128, 32, 128, 128, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 32, 128, 128, **kw), Fire(256, 48, 192, 192, **kw),
                Fire(384, 48, 192, 192, **kw), Fire(384, 64, 256, 256, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(512, 64, 256, 256, **kw),
            )
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2, **kw), nn.ReLU(),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(64, 16, 64, 64, **kw), Fire(128, 16, 64, 64, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(128, 32, 128, 128, **kw), Fire(256, 32, 128, 128, **kw),
                nn.MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 48, 192, 192, **kw), Fire(384, 48, 192, 192, **kw),
                Fire(384, 64, 256, 256, **kw), Fire(512, 64, 256, 256, **kw),
            )
        self.classifier = nn.Sequential(
            nn.Dropout(0.5),
            nn.Conv2D(512, num_classes, 1, **kw),
            nn.ReLU(),
            nn.AdaptiveAvgPool2D(1),
        )

    def forward(self, x):
        x = self.features(x)
        x = self.classifier(x)
        return x.flatten(1)


def squeezenet1_0(pretrained=False, **kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    return SqueezeNet("1.1", **kwargs)
