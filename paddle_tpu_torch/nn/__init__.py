from . import functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_)
from .layer import (GELU, Dropout, Embedding, Layer, LayerList, LayerNorm,
                    Linear)
from .param_attr import ParamAttr

__all__ = ["functional", "initializer", "Layer", "LayerList", "Dropout",
           "Embedding", "LayerNorm", "Linear", "GELU", "ParamAttr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]
