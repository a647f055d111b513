from .activation import GELU
from .common import Dropout, Embedding, Linear
from .layers import Layer, LayerList
from .norm import LayerNorm

__all__ = ["Layer", "LayerList", "Dropout", "Embedding", "Linear",
           "LayerNorm", "GELU"]
