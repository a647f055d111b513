"""Vision transforms (port of ``paddle_tpu/vision/transforms/``): numpy
images in, numpy images out, except ``ToTensor`` (a host torch tensor) and
``Normalize`` of a tensor (a tensor). The ``DataLoader`` moves batches to
the device.

``Resize`` is the reference's ``jax.image.resize(..., "bilinear")``: the
antialiased weight matrices of ``nn.functional.interpolate``, one spatial
axis at a time. The random transforms take a ``generator`` (a
``torch.Generator``, for example ``core.random.default_generator("cpu")``)
and draw from it; without one they draw from numpy's global generator, as
the reference's do, and make the reference's draws after the same
``np.random.seed``.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


def _rand(generator):
    """One uniform draw in [0, 1)."""
    if generator is None:
        return np.random.rand()
    return float(torch.rand((), generator=generator))


def _randint(low, high, generator):
    if generator is None:
        return np.random.randint(low, high)
    return int(torch.randint(low, high, (), generator=generator))


def _array(img, dtype=None):
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return np.asarray(img, dtype)


class ToTensor(BaseTransform):
    """HWC (or HW) to a float32 CHW host tensor, scaled to [0, 1] when the
    values look like bytes."""

    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = _array(img, np.float32)
        if arr.ndim == 2:
            arr = arr[None] if self.data_format == "CHW" else arr[..., None]
        elif arr.ndim == 3 and self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        if isinstance(img, torch.Tensor):
            mean = torch.from_numpy(self.mean.reshape(shape)).to(img.device)
            std = torch.from_numpy(self.std.reshape(shape)).to(img.device)
            return ((img.float() - mean) / std).float()
        arr = np.asarray(img, np.float32)
        return ((arr - self.mean.reshape(shape))
                / self.std.reshape(shape)).astype(np.float32)


def _resize_axes(arr, axes, sizes):
    from ...nn.functional.common import _resize_weights

    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    for ax, n_out in zip(axes, sizes):
        if x.shape[ax] == n_out:
            continue
        w = torch.from_numpy(_resize_weights(x.shape[ax], n_out, False)).to(
            torch.float32)
        x = (x.movedim(ax, -1) @ w).movedim(-1, ax)
    return x.numpy()


class Resize(BaseTransform):
    """Bilinear (antialiased when it shrinks) to ``size`` (h, w); an image
    whose last axis has at most 4 entries is HWC, else CHW."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def _apply_image(self, img):
        arr = _array(img, np.float32)
        hwc = arr.ndim == 3 and arr.shape[-1] <= 4
        if arr.ndim == 2:
            arr = arr[..., None]
            hwc = True
        axes = (0, 1) if hwc else (1, 2)
        return _resize_axes(arr, axes, self.size)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)

    def _apply_image(self, img):
        arr = _array(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, keys=None,
                 generator=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.padding = padding
        self.generator = generator

    def _apply_image(self, img):
        arr = _array(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            arr = np.pad(arr, [(p[1], p[3]), (p[0], p[2])]
                         + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        i = _randint(0, max(h - th, 0) + 1, self.generator)
        j = _randint(0, max(w - tw, 0) + 1, self.generator)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys)
        self.prob = prob
        self.generator = generator

    def _apply_image(self, img):
        if _rand(self.generator) < self.prob:
            return hflip(img)
        return _array(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, generator=None):
        super().__init__(keys)
        self.prob = prob
        self.generator = generator

    def _apply_image(self, img):
        if _rand(self.generator) < self.prob:
            return vflip(img)
        return _array(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = _array(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None, generator=None):
        super().__init__(keys)
        self.value = value
        self.generator = generator

    def _apply_image(self, img):
        arr = _array(img, np.float32)
        if self.generator is None:
            factor = 1 + np.random.uniform(-self.value, self.value)
        else:
            factor = 1 + self.value * (2 * _rand(self.generator) - 1)
        return np.clip(arr * factor, 0, 255 if arr.max() > 1.5 else 1.0)


# the functional forms
def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.ascontiguousarray(_array(img)[:, ::-1])


def vflip(img):
    return np.ascontiguousarray(_array(img)[::-1])


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)
