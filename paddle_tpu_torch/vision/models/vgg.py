"""VGG (port of ``paddle_tpu/vision/models/vgg.py``)."""
from __future__ import annotations

from ... import nn

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
          512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, device=None, dtype=None,
                generator=None):
    kw = {"device": device, "dtype": dtype, "generator": generator}
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            conv2d = nn.Conv2D(in_channels, v, kernel_size=3, padding=1, **kw)
            if batch_norm:
                layers += [conv2d, nn.BatchNorm2D(v, **kw), nn.ReLU()]
            else:
                layers += [conv2d, nn.ReLU()]
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Layer):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm=False, *, device=None, dtype=None, generator=None,
         **kwargs):
    kw = {"device": device, "dtype": dtype, "generator": generator}
    return VGG(make_layers(cfgs[cfg], batch_norm=batch_norm, **kw), **kwargs,
               **kw)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
