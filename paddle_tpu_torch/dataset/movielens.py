"""dataset.movielens (port of ``paddle_tpu/dataset/movielens.py``; reference
dataset/movielens.py) — generator API over text.Movielens."""
from ..text import Movielens


def _reader(mode):
    def reader():
        ds = Movielens(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
