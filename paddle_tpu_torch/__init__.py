"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module paths and names so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only — never ``jax`` and never
``paddle_tpu``.

``import paddle_tpu_torch as paddle`` gives the Paddle API the training loop
is written against: the dtypes, ``Tensor`` (which is ``torch.Tensor``: no
wrapper class), ``Parameter``, ``to_tensor``, the places and
``set_device``, grad mode, ``grad``, the op surface (the reference's
math, manipulation, creation, table, linalg, misc and extra ops at the top
level; ``fft``, ``signal``, ``sparse``, ``distribution``, ``linalg`` and
``tensor`` as modules; ``ops.registry.all_ops()`` names them all),
``nn`` (``Layer``, initializers, ``ParamAttr``, the grad clips) and
``optimizer`` (with the ``lr`` schedulers), and the runtime around a
user's own loop: ``amp``
(``auto_cast``, ``decorate``, ``GradScaler``), ``io`` (datasets, samplers,
``DataLoader``, ``DevicePrefetcher``), ``save``/``load`` (checkpoints either
package reads), ``fault`` (the stability sentinel, the preemption guard,
retry, the HBM admission and the out-of-memory ladder) and
``distributed`` (``init_parallel_env``, the collectives, ``DataParallel``,
``HybridParallelEngine``), and the high-level API: ``Model`` (with
``callbacks``, ``summary`` and ``flops``), ``metric`` and ``vision``
(``models``, ``transforms``, ``datasets`` and the detection ``ops``), and
deployment: ``jit.to_static``/``save``/``load``, ``static`` (``InputSpec``,
``Program``, ``save_inference_model``) and ``inference`` (``Config``,
``Predictor``; a C API over it in ``inference/csrc``), ``quantization``
(QAT, PTQ and the int8 serving layers) and ``incubate`` (the fused
layers, ASP, custom ops, DistributedFusedLamb, LookAhead/ModelAverage and
the host-embedding parameter server), and the rest of the reference's
surface: ``text`` (``FasterTokenizer`` on the native ``tokenizer.cc``,
``viterbi_decode``, the text datasets), the v1 data modules (``dataset``,
``reader``, ``batch``), ``device``, ``utils.dlpack``, ``hub``, ``onnx``
and ``analysis`` (the linter and the lock and thread checks over the
port's own sources). Under it, kernels written by hand
in CUDA C++ (``ops/kernels/csrc``) serve and train:

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
import torch as _torch

from . import amp, autograd, distributed, io, jit, nn, optimizer, utils
from .autograd import grad
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.engine import (enable_grad, grad_enabled, no_grad,
                          set_grad_enabled)
from .core.place import (CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,
                         IPUPlace, MLUPlace, NPUPlace, Place, TPUPlace,
                         XPUPlace, get_device, is_compiled_with_cuda,
                         is_compiled_with_tpu, resolve_device, set_device)
from .core.random import get_rng_state, program_rng, seed, set_rng_state
from .distributed.parallel import DataParallel
from .core.tensor import Parameter, Tensor, to_tensor
from .framework.flags import flag, get_flags, set_flags
from .framework.io import load, save
from .nn import ParamAttr
from . import ops as _ops  # attaches the tensor methods torch lacks
from .ops.creation import (
    zeros, ones, full, empty, zeros_like, ones_like, full_like, empty_like,
    arange, linspace, logspace, eye, diag, diagflat, tril, triu, meshgrid,
    assign, clone, numel, rand, randn, randint, randint_like, randperm,
    uniform, normal, gaussian, standard_normal, bernoulli, multinomial,
    shard_index,
)
from .ops.math import (
    add, subtract, multiply, divide, floor_divide, remainder, mod, pow,
    maximum, minimum, fmax, fmin, atan2, exp, expm1, log, log2, log10, log1p,
    sqrt, rsqrt, abs, sign, floor, ceil, round, trunc, frac, sin, cos, tan,
    asin, acos, atan, sinh, cosh, tanh, asinh, acosh, atanh, erf, erfinv,
    reciprocal, square, digamma, lgamma, sigmoid, clip, lerp, nan_to_num,
    stanh, isnan, isinf, isfinite, equal, not_equal, greater_than,
    greater_equal, less_than, less_equal, logical_and, logical_or,
    logical_not, logical_xor, bitwise_and, bitwise_or, bitwise_xor,
    bitwise_not, equal_all, allclose, isclose, sum, mean, max, min, prod,
    amax, amin, all, any, std, var, median, quantile, nanmean, nansum,
    logsumexp, argmax, argmin, cumsum, cumprod, cummax, cummin, logcumsumexp,
    matmul, mm, dot, inner, outer, addmm, bmm, kron, trace, diagonal, mv,
    dist, cast, scale, increment, neg, heaviside, hypot, copysign, nextafter,
    gcd, lcm, ldexp, floor_mod,
)
from .ops.manipulation import (
    reshape, reshape_, transpose, t, concat, stack, split, chunk, unbind,
    unstack, squeeze, unsqueeze, flatten, expand, expand_as, broadcast_to,
    broadcast_shape, broadcast_tensors, tile, repeat_interleave, flip, roll,
    rot90, gather, gather_nd, take_along_axis, put_along_axis, scatter,
    scatter_nd, scatter_nd_add, index_select, index_sample, index_add,
    masked_select, masked_fill, where, nonzero, slice, strided_slice, crop,
    topk, sort, argsort, searchsorted, unique, unique_consecutive, bincount,
    histogram, atleast_1d, atleast_2d, atleast_3d, as_real, as_complex, real,
    imag, conj, moveaxis, swapaxes,
)
from .ops import generated as _generated
from .ops import inplace as _inplace
from .ops.extra import (einsum, histogramdd, segment_max, segment_mean,
                        segment_min, segment_sum)
from .ops.misc import (
    is_tensor, is_floating_point, is_integer, is_complex, is_empty, rank,
    shape, tolist, reverse, multiplex, mode, poisson, set_printoptions,
    create_parameter, disable_signal_handler, is_compiled_with_cinn,
    is_compiled_with_rocm, is_compiled_with_xpu, is_compiled_with_npu,
    is_compiled_with_mlu, is_compiled_with_ipu, get_cuda_rng_state,
    set_cuda_rng_state,
)
from .linalg import (cholesky, cholesky_solve, cond, cov, eig, eigvals,
                     eigvalsh, inverse, lstsq, lu, multi_dot, norm, qr,
                     triangular_solve)
from . import distribution, fft, linalg, signal, sparse, tensor
from . import callbacks, metric, vision
from . import inference, static
from . import incubate, quantization
from .hapi.flops import flops
from .hapi.model import Model, summary
from . import fault, profiler
from . import dataset, device, hub, onnx, reader, text
from .batch import batch
from .io import DataLoader
from .nn.layer.common import ParameterList

# the table ops join the top level without replacing a hand-written one
_GENERATED_TOP = [n for n in _generated.GENERATED if n not in globals()]
globals().update({n: _generated.GENERATED[n] for n in _GENERATED_TOP})

# the v1 top-level in-place names (paddle.tanh_ and the rest) that exist
_INPLACE_TOP = [n for n in ("scatter_", "squeeze_", "tanh_", "unsqueeze_",
                            "relu_", "clip_", "exp_", "sqrt_", "subtract_",
                            "add_") if n in _inplace.INPLACE_OPS]
globals().update({n: _inplace.INPLACE_OPS[n] for n in _INPLACE_TOP})

from .core import dispatch as _dispatch

_dispatch._sync_scan()  # FLAGS_check_nan_inf from the environment

bool = bool_  # noqa: A001 (paddle.bool)
is_grad_enabled = grad_enabled
__version__ = "0.1.0"


# paddle.dtype: the type of the port's dtypes, for isinstance checks (the
# reference's is np.dtype, the type of its own)
dtype = _torch.dtype


def get_cudnn_version():
    """cuDNN's version as an int where CUDA has cuDNN, else None (the
    original Paddle's contract)."""
    return _torch.backends.cudnn.version()


def __getattr__(name):
    # cost_model imports the kernel registry's autotune and tuning DB, which
    # a process that never asks for it keeps unimported
    if name == "cost_model":
        import importlib

        return importlib.import_module(f"{__name__}.cost_model")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def disable_static(place=None):
    """Eager is the only mode (reference: paddle.disable_static)."""


def enable_static():
    """Accepted for the reference's API: programs are traced callables
    (``static``), so there is no mode to enter."""


def in_dynamic_mode():
    return True


__all__ = [
    "amp", "autograd", "distributed", "io", "jit", "nn", "optimizer",
    "utils", "grad", "DataParallel", "distribution", "fft",
    "linalg", "signal", "sparse", "tensor", "callbacks", "metric", "vision",
    "Model", "summary", "flops", "static", "inference", "incubate",
    "quantization", "cost_model", "fault", "profiler", "dataset", "device",
    "hub", "onnx", "reader", "text", "batch", "DataLoader", "ParameterList",
    "dtype", "get_cudnn_version", "get_rng_state", "set_rng_state",
    "program_rng", "CUDAPinnedPlace", "IPUPlace", "MLUPlace", "NPUPlace",
    "XPUPlace", "CustomPlace", "is_compiled_with_tpu",
    "enable_static", "disable_static", "in_dynamic_mode",
    "bool", "save", "load",
    "bfloat16", "complex64", "complex128", "float16", "float32", "float64",
    "int8", "int16", "int32", "int64", "uint8", "get_default_dtype",
    "set_default_dtype", "enable_grad", "grad_enabled", "is_grad_enabled",
    "no_grad", "set_grad_enabled", "CPUPlace", "CUDAPlace", "Place",
    "TPUPlace", "get_device", "is_compiled_with_cuda", "resolve_device",
    "set_device", "seed", "Parameter", "Tensor", "to_tensor", "flag",
    "get_flags", "set_flags", "ParamAttr",
    *[n for mod in (_ops.creation, _ops.math, _ops.manipulation,
                    _ops.misc) for n in mod.__all__ if n in globals()],
    "einsum", "histogramdd", "segment_max", "segment_mean", "segment_min",
    "segment_sum", "cholesky", "cholesky_solve", "cond", "cov", "eig",
    "eigvals", "eigvalsh", "inverse", "lstsq", "lu", "multi_dot", "norm",
    "qr", "triangular_solve", *_GENERATED_TOP, *_INPLACE_TOP,
]
__all__ = list(dict.fromkeys(__all__))
