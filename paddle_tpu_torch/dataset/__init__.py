"""paddle.dataset — the v1 generator-style dataset namespace (port of
``paddle_tpu/dataset/``; reference python/paddle/dataset/): each sub-module
exposes ``train()``/``test()`` reader creators yielding plain numpy samples.
Backed by this framework's class-based datasets (vision.datasets / text
datasets with synthetic fallbacks — no network egress here), so v1 training
scripts keep working."""
from . import (  # noqa: F401
    cifar, common, conll05, imdb, imikolov, mnist, movielens, uci_housing,
    wmt14, wmt16,
)

__all__ = ["mnist", "cifar", "imdb", "imikolov", "uci_housing", "movielens",
           "conll05", "wmt14", "wmt16", "common"]
