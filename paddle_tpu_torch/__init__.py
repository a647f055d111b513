"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module paths and names so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only — never ``jax`` and never
``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the Paddle API the training loop
is written against: the dtypes, ``Tensor`` (which is ``torch.Tensor``: no
wrapper class), ``Parameter``, ``to_tensor``, the places and
``set_device``, grad mode, ``grad``, the op subset, ``nn`` (``Layer``,
initializers, ``ParamAttr``, the grad clips) and ``optimizer`` (with the
``lr`` schedulers), and the runtime around a user's own loop: ``amp``
(``auto_cast``, ``decorate``, ``GradScaler``), ``io`` (datasets, samplers,
``DataLoader``, ``DevicePrefetcher``), ``save``/``load`` (checkpoints either
package reads), ``fault`` (the stability sentinel, the preemption guard,
retry, the HBM admission and the out-of-memory ladder) and
``distributed`` (``init_parallel_env``, the collectives, ``DataParallel``,
``HybridParallelEngine``). Under it, kernels written by hand in CUDA C++
(``ops/kernels/csrc``) serve and train:

- serving: ``serving.Engine`` over the paged builders in
  ``models.generation``, with the paged-attention decode read and the
  weight-only int8 LM-head matmul;
- training: ``models.GPTForPretraining.loss`` (fused LM-head cross-entropy)
  in the eager loop or through ``jit.compile_train_step``, attention in the
  flash-attention forward, dQ and dK/dV kernels.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``set_device("cpu")`` or ``device="cpu"``); on the CPU every kernel wrapper
runs its plain PyTorch version.
"""
from . import amp, autograd, distributed, io, jit, nn, optimizer, utils
from .autograd import grad
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.engine import (enable_grad, grad_enabled, no_grad,
                          set_grad_enabled)
from .core.place import (CPUPlace, CUDAPlace, Place, TPUPlace, get_device,
                         is_compiled_with_cuda, resolve_device, set_device)
from .core.random import seed
from .distributed.parallel import DataParallel
from .core.tensor import Parameter, Tensor, to_tensor
from .framework.flags import flag, get_flags, set_flags
from .framework.io import load, save
from .nn import ParamAttr
from .ops.creation import (arange, assign, clone, empty, empty_like, eye,
                           full, full_like, normal, ones, ones_like, rand,
                           randint, randn, tril, triu, uniform, zeros,
                           zeros_like)
from .ops.manipulation import (argsort, broadcast_to, chunk, concat, expand,
                               flatten, gather, gather_nd, index_select,
                               masked_fill, repeat_interleave, reshape, slice,
                               sort, split, squeeze, stack, take_along_axis,
                               tile, topk, transpose, unbind, unsqueeze, where)
from .ops.math import (abs, add, allclose, argmax, argmin, cast, clip, cumsum,
                       divide, equal, exp, greater_equal, greater_than,
                       less_equal, less_than, log, matmul, max, maximum, mean,
                       min, minimum, multiply, not_equal, pow, prod, rsqrt,
                       scale, sigmoid, sqrt, square, subtract, sum, tanh)

from .core import dispatch as _dispatch

_dispatch._sync_scan()  # FLAGS_check_nan_inf from the environment

bool = bool_  # noqa: A001 (paddle.bool)
is_grad_enabled = grad_enabled

__all__ = [
    "amp", "autograd", "distributed", "io", "jit", "nn", "optimizer",
    "utils", "grad", "DataParallel",
    "bool", "save", "load",
    "bfloat16", "complex64", "complex128", "float16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "get_default_dtype",
    "set_default_dtype", "enable_grad", "grad_enabled", "is_grad_enabled",
    "no_grad", "set_grad_enabled", "CPUPlace", "CUDAPlace", "Place",
    "TPUPlace", "get_device", "is_compiled_with_cuda", "resolve_device",
    "set_device", "seed", "Parameter", "Tensor", "to_tensor", "flag",
    "get_flags", "set_flags", "ParamAttr",
    "arange", "assign", "clone", "empty", "empty_like", "eye", "full",
    "full_like", "normal", "ones", "ones_like", "rand", "randint", "randn",
    "tril", "triu", "uniform", "zeros", "zeros_like",
    "argsort", "broadcast_to", "chunk", "concat", "expand", "flatten",
    "gather", "gather_nd", "index_select", "masked_fill", "repeat_interleave",
    "reshape", "slice", "sort", "split", "squeeze", "stack",
    "take_along_axis", "tile", "topk", "transpose", "unbind", "unsqueeze",
    "where",
    "abs", "add", "allclose", "argmax", "argmin", "cast", "clip", "cumsum",
    "divide", "equal", "exp", "greater_equal", "greater_than", "less_equal",
    "less_than", "log", "matmul", "max", "maximum", "mean", "min", "minimum",
    "multiply", "not_equal", "pow", "prod", "rsqrt", "scale", "sigmoid",
    "sqrt", "square", "subtract", "sum", "tanh",
]
