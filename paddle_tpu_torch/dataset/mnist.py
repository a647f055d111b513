"""dataset.mnist (port of ``paddle_tpu/dataset/mnist.py``; reference
dataset/mnist.py) — generator API over vision.datasets.MNIST."""
from ..vision.datasets import MNIST


def _reader(mode):
    def reader():
        ds = MNIST(mode=mode)
        for i in range(len(ds)):
            img, label = ds[i]
            yield img.reshape(-1) if hasattr(img, "reshape") else img, int(label)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
