"""dataset.wmt14 (port of ``paddle_tpu/dataset/wmt14.py``; reference
dataset/wmt14.py) — generator API over text.WMT14."""
from ..text import WMT14


def _reader(mode):
    def reader():
        ds = WMT14(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
