from .activation import gelu, silu, tanh
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import layer_norm

__all__ = ["scaled_dot_product_attention", "flash_attention", "dropout",
           "linear", "embedding", "gelu", "tanh", "silu",
           "layer_norm", "cross_entropy", "fused_linear_cross_entropy"]
