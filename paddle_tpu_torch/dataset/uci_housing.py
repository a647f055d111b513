"""dataset.uci_housing (port of ``paddle_tpu/dataset/uci_housing.py``;
reference dataset/uci_housing.py) — generator API over text.UCIHousing."""
from ..text import UCIHousing


def _reader(mode):
    def reader():
        ds = UCIHousing(mode=mode)
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (list, tuple)) else (ds[i],)
    return reader


def train():
    return _reader("train")


def test():
    return _reader("test")
