"""dataset.common (port of ``paddle_tpu/dataset/common.py``; reference
dataset/common.py): shared paths + md5 utils."""
from __future__ import annotations

import hashlib

from ..io import data_home as _data_home

DATA_HOME = _data_home()  # one cache root shared with paddle.io


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    raise RuntimeError(
        "paddle_tpu_torch.dataset runs with zero network egress; datasets "
        "load from local files or synthesize deterministic fallbacks")
