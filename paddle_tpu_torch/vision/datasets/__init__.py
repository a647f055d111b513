"""Vision datasets (port of ``paddle_tpu/vision/datasets/``).

Nothing is fetched. ``MNIST``/``FashionMNIST`` read the idx files (gzip)
under ``io.data_home()/mnist`` when they are there; else they, and
``Cifar10``/``Cifar100`` always, make the reference's deterministic
synthetic arrays from a numpy ``RandomState`` (at most
``PADDLE_TPU_SYNTH_N`` samples, default 4096), the same shapes and label
space, so a training pipeline runs end to end. ``ImageFolder`` and
``DatasetFolder`` read ``.npy`` images (no image decoder is used).
Samples are numpy arrays; the ``DataLoader`` makes the tensors.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset, data_home


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train", transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        images, labels = self._load()
        self.images, self.labels = images, labels

    def _load(self):
        base = os.path.join(data_home(), "mnist")
        prefix = "train" if self.mode == "train" else "t10k"
        img_f = os.path.join(base, f"{prefix}-images-idx3-ubyte.gz")
        lab_f = os.path.join(base, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img_f) and os.path.exists(lab_f):
            with gzip.open(img_f, "rb") as f:
                magic, n, h, w = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, h, w)
            with gzip.open(lab_f, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), dtype=np.uint8)
            return images, labels.astype(np.int64)
        # synthetic fallback (deterministic)
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        n = 60000 if self.mode == "train" else 10000
        n = min(n, int(os.environ.get("PADDLE_TPU_SYNTH_N", "4096")))
        labels = rng.randint(0, 10, n).astype(np.int64)
        images = np.zeros((n, 28, 28), np.uint8)
        for i, l in enumerate(labels):  # class-dependent blobs → learnable
            images[i, (l * 2 + 2) : (l * 2 + 6), 4:24] = 200
            images[i] += rng.randint(0, 40, (28, 28)).astype(np.uint8)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[..., None]  # HWC
        label = np.asarray(self.labels[idx], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        rng = np.random.RandomState(0 if mode == "train" else 1)
        n = min(50000 if mode == "train" else 10000, int(os.environ.get("PADDLE_TPU_SYNTH_N", "4096")))
        self.labels = rng.randint(0, 10, n).astype(np.int64)
        self.images = rng.randint(0, 255, (n, 32, 32, 3)).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], dtype=np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    def __init__(self, data_file=None, mode="train", transform=None, download=True, backend=None):
        super().__init__(data_file, mode, transform, download, backend)
        rng = np.random.RandomState(2)
        self.labels = rng.randint(0, 100, len(self.labels)).astype(np.int64)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None, is_valid_file=None):
        self.samples = []
        self.transform = transform
        exts = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        if os.path.isdir(root):
            for dirpath, _, files in sorted(os.walk(root)):
                for fn in sorted(files):
                    if fn.lower().endswith(exts):
                        self.samples.append(os.path.join(dirpath, fn))

    def __getitem__(self, idx):
        path = self.samples[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            raise RuntimeError("image decoding unavailable (no PIL in env); use .npy")
        if self.transform:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class DatasetFolder(ImageFolder):
    def __init__(self, root, loader=None, extensions=None, transform=None, is_valid_file=None):
        super().__init__(root, loader, extensions, transform, is_valid_file)
        self.classes = sorted({os.path.basename(os.path.dirname(p)) for p in self.samples})
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def __getitem__(self, idx):
        (img,) = super().__getitem__(idx)
        label = self.class_to_idx[os.path.basename(os.path.dirname(self.samples[idx]))]
        return img, np.asarray(label, np.int64)
