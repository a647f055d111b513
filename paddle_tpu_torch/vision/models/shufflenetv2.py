"""ShuffleNetV2 (port of ``paddle_tpu/vision/models/shufflenetv2.py``)."""
from __future__ import annotations

import torch

from ... import nn


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    x = x.reshape(n, groups, c // groups, h, w).transpose(1, 2)
    return x.reshape(n, c, h, w)


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.stride = stride
        branch_features = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride, 1, groups=inp,
                          bias_attr=False, **kw),
                nn.BatchNorm2D(inp, **kw),
                nn.Conv2D(inp, branch_features, 1, bias_attr=False, **kw),
                nn.BatchNorm2D(branch_features, **kw),
                nn.ReLU(),
            )
        else:
            self.branch1 = None
        in2 = inp if stride > 1 else branch_features
        self.branch2 = nn.Sequential(
            nn.Conv2D(in2, branch_features, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(branch_features, **kw),
            nn.ReLU(),
            nn.Conv2D(branch_features, branch_features, 3, stride, 1,
                      groups=branch_features, bias_attr=False, **kw),
            nn.BatchNorm2D(branch_features, **kw),
            nn.Conv2D(branch_features, branch_features, 1, bias_attr=False,
                      **kw),
            nn.BatchNorm2D(branch_features, **kw),
            nn.ReLU(),
        )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    CFG = {
        0.25: (24, 24, 48, 96, 512),
        0.33: (24, 32, 64, 128, 512),
        0.5: (24, 48, 96, 192, 1024),
        1.0: (24, 116, 232, 464, 1024),
        1.5: (24, 176, 352, 704, 1024),
        2.0: (24, 244, 488, 976, 2048),
    }

    def __init__(self, scale=1.0, act="relu", num_classes=1000,
                 with_pool=True, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        stages_repeats = [4, 8, 4]
        c0, c1, c2, c3, c_last = self.CFG[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, c0, 3, 2, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(c0, **kw), nn.ReLU())
        self.maxpool = nn.MaxPool2D(3, 2, 1)
        stages = []
        inp = c0
        for reps, outp in zip(stages_repeats, (c1, c2, c3)):
            stages.append(InvertedResidual(inp, outp, 2, **kw))
            for _ in range(reps - 1):
                stages.append(InvertedResidual(outp, outp, 1, **kw))
            inp = outp
        self.stages = nn.Sequential(*stages)
        self.conv_last = nn.Sequential(
            nn.Conv2D(inp, c_last, 1, bias_attr=False, **kw),
            nn.BatchNorm2D(c_last, **kw), nn.ReLU())
        self.pool = nn.AdaptiveAvgPool2D(1) if with_pool else None
        self.fc = nn.Linear(c_last, num_classes, **kw) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.conv_last(self.stages(self.maxpool(self.conv1(x))))
        if self.pool is not None:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def shufflenet_v2_x0_25(pretrained=False, **kw):
    return ShuffleNetV2(0.25, **kw)


def shufflenet_v2_x0_33(pretrained=False, **kw):
    return ShuffleNetV2(0.33, **kw)


def shufflenet_v2_x0_5(pretrained=False, **kw):
    return ShuffleNetV2(0.5, **kw)


def shufflenet_v2_x1_0(pretrained=False, **kw):
    return ShuffleNetV2(1.0, **kw)


def shufflenet_v2_x1_5(pretrained=False, **kw):
    return ShuffleNetV2(1.5, **kw)


def shufflenet_v2_x2_0(pretrained=False, **kw):
    return ShuffleNetV2(2.0, **kw)
