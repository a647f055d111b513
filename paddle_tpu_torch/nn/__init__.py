from .layer import Embedding, LayerNorm, Linear, layer_norm

__all__ = ["Embedding", "LayerNorm", "Linear", "layer_norm"]
