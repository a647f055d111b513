"""paddle.nn.functional (port of ``paddle_tpu/nn/functional/__init__.py``):
the same names from the same modules."""
from .activation import (celu, elu, elu_, gelu, glu, gumbel_softmax,  # noqa: F401
                         hardshrink, hardsigmoid, hardswish, hardtanh,
                         leaky_relu, log_sigmoid, log_softmax, maxout, mish,
                         prelu, relu, relu6, relu_, rrelu, selu, sigmoid,
                         silu, softmax, softmax_, softplus, softshrink,
                         softsign, swish, tanh, tanhshrink, thresholded_relu)
from .attention import flash_attention, scaled_dot_product_attention  # noqa: F401
from .common import (alpha_dropout, bilinear, channel_shuffle,  # noqa: F401
                     class_center_sample, cosine_similarity, dropout,
                     dropout2d, dropout3d, embedding, fold, interpolate,
                     label_smooth, linear, normalize, one_hot, pad,
                     pixel_shuffle, pixel_unshuffle, unfold, upsample)
from .conv import (conv1d, conv1d_transpose, conv2d,  # noqa: F401
                   conv2d_transpose, conv3d, conv3d_transpose)
from .loss import (binary_cross_entropy,  # noqa: F401
                   binary_cross_entropy_with_logits, cosine_embedding_loss,
                   cross_entropy, ctc_loss, fused_linear_cross_entropy,
                   hinge_embedding_loss, hsigmoid_loss, kl_div, l1_loss,
                   log_loss, margin_cross_entropy, margin_ranking_loss,
                   mse_loss, nll_loss, sigmoid_focal_loss, smooth_l1_loss,
                   softmax_with_cross_entropy, square_error_cost,
                   triplet_margin_loss)
from .norm import (batch_norm, group_norm, instance_norm,  # noqa: F401
                   layer_norm, local_response_norm, spectral_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,  # noqa: F401
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
from .sparse_attention import sparse_attention  # noqa: F401
from .vision import (affine_grid, dice_loss, gather_tree,  # noqa: F401
                     grid_sample, max_unpool1d, max_unpool2d, max_unpool3d,
                     npair_loss, pairwise_distance, sequence_mask,
                     temporal_shift, zeropad2d)
