"""AlexNet (port of ``paddle_tpu/vision/models/alexnet.py``)."""
from __future__ import annotations

from ... import nn


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype, "generator": generator}
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, kernel_size=11, stride=4, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(kernel_size=3, stride=2),
            nn.Conv2D(64, 192, kernel_size=5, padding=2, **kw),
            nn.ReLU(),
            nn.MaxPool2D(kernel_size=3, stride=2),
            nn.Conv2D(192, 384, kernel_size=3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(384, 256, kernel_size=3, padding=1, **kw),
            nn.ReLU(),
            nn.Conv2D(256, 256, kernel_size=3, padding=1, **kw),
            nn.ReLU(),
            nn.MaxPool2D(kernel_size=3, stride=2),
        )
        self.avgpool = nn.AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(),
                nn.Linear(256 * 6 * 6, 4096, **kw),
                nn.ReLU(),
                nn.Dropout(),
                nn.Linear(4096, 4096, **kw),
                nn.ReLU(),
                nn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.classifier(x)
        return x


def alexnet(pretrained=False, **kwargs):
    return AlexNet(**kwargs)
