"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module paths and names so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only — never ``jax`` and never
``paddle_tpu``.

The first slice is the GPT serving path: ``serving.Engine`` over the paged
builders in ``models.generation``, with two kernels written by hand in CUDA
C++ (``ops/kernels/csrc``): the paged-attention decode read and the
weight-only int8 LM-head matmul. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version.
"""
from .core.place import resolve_device
from .framework.flags import flag, get_flags, set_flags

__all__ = ["resolve_device", "flag", "get_flags", "set_flags"]
