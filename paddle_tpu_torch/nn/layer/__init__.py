from .common import Embedding, Linear
from .norm import LayerNorm, layer_norm

__all__ = ["Embedding", "Linear", "LayerNorm", "layer_norm"]
