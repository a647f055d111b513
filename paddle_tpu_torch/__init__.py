"""PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package ``paddle_tpu`` stays the reference; this package keeps its
module paths and names so each counterpart is easy to find. It imports
``torch``, numpy and the standard library only — never ``jax`` and never
``paddle_tpu``.

Two paths are ported, each with kernels written by hand in CUDA C++
(``ops/kernels/csrc``):

- serving: ``serving.Engine`` over the paged builders in
  ``models.generation``, with the paged-attention decode read and the
  weight-only int8 LM-head matmul;
- training: ``models.GPTForPretraining.loss`` (fused LM-head cross-entropy)
  through ``jit.compile_train_step`` with ``optimizer.AdamW``, attention in
  the flash-attention forward, dQ and dK/dV kernels.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on
the CPU every kernel wrapper runs its plain PyTorch version.
"""
from . import jit, nn, optimizer
from .core.place import resolve_device
from .core.random import seed
from .framework.flags import flag, get_flags, set_flags

__all__ = ["resolve_device", "seed", "flag", "get_flags", "set_flags", "jit",
           "nn", "optimizer"]
