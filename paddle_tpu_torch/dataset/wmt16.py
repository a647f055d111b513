"""dataset.wmt16 (port of ``paddle_tpu/dataset/wmt16.py``; reference
dataset/wmt16.py) — generator API over text.WMT16."""
from ..text import WMT16


def _reader(mode):
    def reader():
        ds = WMT16(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
