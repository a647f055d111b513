"""dataset.cifar (port of ``paddle_tpu/dataset/cifar.py``; reference
dataset/cifar.py) — generator API over vision.datasets.Cifar10."""
from ..vision.datasets import Cifar10


def _reader(mode):
    def reader():
        ds = Cifar10(mode=mode)
        for i in range(len(ds)):
            img, label = ds[i]
            yield img.reshape(-1) if hasattr(img, "reshape") else img, int(label)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
