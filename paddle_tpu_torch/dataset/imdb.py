"""dataset.imdb (port of ``paddle_tpu/dataset/imdb.py``; reference
dataset/imdb.py) — generator API over text.Imdb."""
from ..text import Imdb


def _reader(mode):
    def reader():
        ds = Imdb(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
