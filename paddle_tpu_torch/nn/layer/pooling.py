"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``), with the
reference's argument order: ``MaxPool*D(kernel_size, stride, padding,
ceil_mode, return_mask, data_format)``."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0,
                 ceil_mode=False, return_mask=False, data_format=None,
                 name=None, *, device=None, dtype=None, generator=None, **kw):
        super().__init__(dtype=dtype)
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.return_mask = ceil_mode, return_mask
        self.data_format = data_format
        self.kw = kw


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode)


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCHW")


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.return_mask, self.ceil_mode,
                            self.data_format or "NCDHW")


class AvgPool1D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         dtype=dtype)
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode)


class AvgPool2D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format=data_format, dtype=dtype)
        self.exclusive, self.divisor_override = exclusive, divisor_override

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AvgPool3D(_Pool):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(kernel_size, stride, padding, ceil_mode,
                         data_format=data_format, dtype=dtype)
        self.exclusive, self.divisor_override = exclusive, divisor_override

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class _AdaptivePool(Layer):
    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self.output_size, self.return_mask = output_size, return_mask
        self.data_format = data_format


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


__all__ = [
    "MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
    "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]
