from . import functional
from .layer import Dropout, Embedding, LayerNorm, Linear, layer_norm

__all__ = ["functional", "Dropout", "Embedding", "LayerNorm", "Linear", "layer_norm"]
