"""ResNeXt (port of ``paddle_tpu/vision/models/resnext.py``): grouped
convolution bottlenecks on the ResNet skeleton."""
from __future__ import annotations

from ... import nn


class BottleneckBlock(nn.Layer):
    expansion = 2

    def __init__(self, inplanes, planes, stride=1, cardinality=32,
                 downsample=None, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.conv1 = nn.Conv2D(inplanes, planes, 1, bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(planes, **kw)
        self.conv2 = nn.Conv2D(planes, planes, 3, stride=stride, padding=1,
                               groups=cardinality, bias_attr=False, **kw)
        self.bn2 = nn.BatchNorm2D(planes, **kw)
        self.conv3 = nn.Conv2D(planes, planes * self.expansion, 1,
                               bias_attr=False, **kw)
        self.bn3 = nn.BatchNorm2D(planes * self.expansion, **kw)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNeXt(nn.Layer):
    CFG = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}

    def __init__(self, depth=50, cardinality=32, num_classes=1000,
                 with_pool=True, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self._kw = kw
        layers = self.CFG[depth]
        base_width = 128 if cardinality == 32 else 256
        self.inplanes = 64
        self.cardinality = cardinality
        self.conv1 = nn.Conv2D(3, 64, 7, stride=2, padding=3,
                               bias_attr=False, **kw)
        self.bn1 = nn.BatchNorm2D(64, **kw)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        self.layer1 = self._make_layer(base_width, layers[0])
        self.layer2 = self._make_layer(base_width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(base_width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(base_width * 8, layers[3], stride=2)
        self.pool = nn.AdaptiveAvgPool2D(1) if with_pool else None
        self.fc = (
            nn.Linear(base_width * 8 * BottleneckBlock.expansion,
                      num_classes, **kw)
            if num_classes > 0 else None
        )
        del self._kw

    def _make_layer(self, planes, blocks, stride=1):
        kw = self._kw
        downsample = None
        out = planes * BottleneckBlock.expansion
        if stride != 1 or self.inplanes != out:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, out, 1, stride=stride,
                          bias_attr=False, **kw),
                nn.BatchNorm2D(out, **kw),
            )
        layers = [BottleneckBlock(self.inplanes, planes, stride,
                                  self.cardinality, downsample, **kw)]
        self.inplanes = out
        for _ in range(1, blocks):
            layers.append(BottleneckBlock(self.inplanes, planes,
                                          cardinality=self.cardinality, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.pool is not None:
            x = self.pool(x)
        if self.fc is not None:
            x = self.fc(x.flatten(1))
        return x


def resnext50_32x4d(pretrained=False, **kw):
    return ResNeXt(50, 32, **kw)


def resnext101_32x4d(pretrained=False, **kw):
    return ResNeXt(101, 32, **kw)


def resnext152_32x4d(pretrained=False, **kw):
    return ResNeXt(152, 32, **kw)
