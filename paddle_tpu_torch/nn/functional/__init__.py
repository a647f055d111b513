from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout
from .loss import cross_entropy, fused_linear_cross_entropy

__all__ = ["scaled_dot_product_attention", "flash_attention", "dropout",
           "cross_entropy", "fused_linear_cross_entropy"]
