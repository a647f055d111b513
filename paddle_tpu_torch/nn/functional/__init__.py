from .activation import gelu
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, linear
from .loss import cross_entropy, fused_linear_cross_entropy
from .norm import layer_norm

__all__ = ["scaled_dot_product_attention", "flash_attention", "dropout",
           "linear", "gelu", "layer_norm", "cross_entropy",
           "fused_linear_cross_entropy"]
