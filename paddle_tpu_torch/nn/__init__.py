"""paddle.nn (port of ``paddle_tpu/nn/__init__.py``): the same names."""
from . import functional, initializer, utils  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue, clip_grad_norm_)
from .layer.activation import (CELU, ELU, GELU, GLU, SELU,  # noqa: F401
                               Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
                               LeakyReLU, LogSigmoid, LogSoftmax, Maxout,
                               Mish, PReLU, ReLU, ReLU6, RReLU, Sigmoid,
                               Silu, Softmax, Softplus, Softshrink, Softsign,
                               Swish, Tanh, Tanhshrink, ThresholdedReLU)
from .layer.common import (AlphaDropout, Bilinear, ChannelShuffle,  # noqa: F401
                           CosineSimilarity, Dropout, Dropout2D, Dropout3D,
                           Embedding, Flatten, Fold, Identity, LayerDict,
                           LayerList, Linear, Pad1D, Pad2D, Pad3D,
                           ParameterList, PixelShuffle, PixelUnshuffle,
                           Sequential, Unfold, Upsample, UpsamplingBilinear2D,
                           UpsamplingNearest2D, ZeroPad2D)
from .layer.conv import (Conv1D, Conv1DTranspose, Conv2D,  # noqa: F401
                         Conv2DTranspose, Conv3D, Conv3DTranspose)
from .layer.layers import Layer  # noqa: F401
from .layer.loss import (BCELoss, BCEWithLogitsLoss,  # noqa: F401
                         CosineEmbeddingLoss, CrossEntropyLoss, CTCLoss,
                         HingeEmbeddingLoss, KLDivLoss, L1Loss,
                         MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                         TripletMarginLoss)
from .layer.norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                         BatchNorm3D, GroupNorm, InstanceNorm1D,
                         InstanceNorm2D, InstanceNorm3D, LayerNorm,
                         LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .layer.pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,  # noqa: F401
                            AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                            AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                            AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                            MaxPool3D)
from .layer.rnn import (GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell,  # noqa: F401
                        RNNCellBase, SimpleRNN, SimpleRNNCell)
from .layer.transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                                TransformerDecoder, TransformerDecoderLayer,
                                TransformerEncoder, TransformerEncoderLayer)
from .param_attr import ParamAttr  # noqa: F401
