"""dataset.imikolov (port of ``paddle_tpu/dataset/imikolov.py``; reference
dataset/imikolov.py) — generator API over text.Imikolov."""
from ..text import Imikolov


def _reader(mode):
    def reader():
        ds = Imikolov(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
