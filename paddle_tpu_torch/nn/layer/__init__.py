from .common import Dropout, Embedding, Linear
from .norm import LayerNorm, layer_norm

__all__ = ["Dropout", "Embedding", "Linear", "LayerNorm", "layer_norm"]
