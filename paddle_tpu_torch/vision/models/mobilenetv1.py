"""MobileNetV1 (port of ``paddle_tpu/vision/models/mobilenetv1.py``)."""
from __future__ import annotations

from ... import nn


class ConvBNLayer(nn.Sequential):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, *, device=None, dtype=None,
                 generator=None):
        kw = {"device": device, "dtype": dtype, "generator": generator}
        super().__init__(
            nn.Conv2D(in_channels, out_channels, kernel_size, stride, padding,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_channels, **kw),
            nn.ReLU(),
        )


class DepthwiseSeparable(nn.Sequential):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, **kw):
        super().__init__(
            ConvBNLayer(int(in_channels * scale), int(out_channels1 * scale),
                        3, stride=stride, padding=1,
                        groups=int(num_groups * scale), **kw),
            ConvBNLayer(int(out_channels1 * scale),
                        int(out_channels2 * scale), 1, **kw),
        )


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.scale = scale
        cfg = [
            # in, out1, out2, groups, stride
            (32, 32, 64, 32, 1),
            (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1),
            (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1),
            (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, stride=2, padding=1,
                                 **kw)
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(i, o1, o2, g, s, scale, **kw)
            for i, o1, o2, g, s in cfg])
        self.pool = nn.AdaptiveAvgPool2D(1) if with_pool else None
        self.fc = nn.Linear(int(1024 * scale), num_classes, **kw) \
            if num_classes > 0 else None

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.pool is not None:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kw):
    return MobileNetV1(scale=scale, **kw)
