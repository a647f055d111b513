"""dataset.conll05 (port of ``paddle_tpu/dataset/conll05.py``; reference
dataset/conll05.py) — generator API over text.Conll05st."""
from ..text import Conll05st


def _reader(mode):
    def reader():
        ds = Conll05st(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
