"""Hand-written Hopper kernels of the serving slice and their launch counts.

Each kernel module keeps a plain PyTorch version beside its wrapper; the
wrapper runs the plain version for CPU tensors and the CUDA kernel (built
from ``csrc/`` at first use, see ``_build``) for CUDA tensors.
"""
from . import int8_matmul as _int8_mod
from . import paged_attention as _paged_mod
from ._build import build
from .int8_matmul import int8_matmul, int8_matmul_plain
from .paged_attention import paged_attention_rows, paged_attention_rows_plain

_MODULES = {"paged_attention_rows": _paged_mod, "int8_matmul": _int8_mod}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


__all__ = ["build", "int8_matmul", "int8_matmul_plain",
           "paged_attention_rows", "paged_attention_rows_plain",
           "launch_counts", "reset_launch_counts"]
