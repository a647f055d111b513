"""Hand-written Hopper kernels of the port, their launch counts and the
kernel registry.

Each kernel module keeps a plain PyTorch version beside its wrapper; the
wrapper runs the plain version for CPU tensors and the CUDA kernel (built
from ``csrc/`` at first use, see ``_build``) for CUDA tensors.

The registry (``registry.py``, port of ``paddle_tpu/ops/kernels``):
:func:`register_kernel` / :func:`get_kernel` / :func:`kernel_names` /
:func:`resolve_config` (and :func:`launch_config`, the call sites' form of
it), and each kernel's ``*_key`` helper. Importing this
package registers every spec (``flash_attention`` and ``fused_ce`` in
``builtin``, ``paged_attention`` and ``int8_matmul`` in their modules). It
does NOT import ``autotune`` or ``db``: ``resolve_config`` imports them only
when ``FLAGS_kernel_autotune`` is ``ondemand`` or ``search``.
"""
from . import builtin  # noqa: F401  (registers flash_attention, fused_ce)
from . import flash_attention as _flash_mod
from . import int8_matmul as _int8_mod
from . import int8_matmul as int8_matmul_mod  # noqa: F401 (the reference's name)
from . import paged_attention as _paged_mod
from ._build import build
from .builtin import flash_attention_key, fused_ce_key
from .flash_attention import (flash_attention_array, flash_attention_dkv,
                              flash_attention_dq, flash_attention_fwd,
                              flash_attention_bwd_plain,
                              flash_attention_plain)
from .int8_matmul import int8_matmul, int8_matmul_key, int8_matmul_plain
from .paged_attention import (paged_attention_key, paged_attention_rows,
                              paged_attention_rows_plain)
from .registry import (KernelSpec, get_kernel, kernel_names, launch_config,
                       register_kernel, resolve_config)

_MODULES = {"paged_attention_rows": _paged_mod, "int8_matmul": _int8_mod}


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last ``reset_launch_counts``."""
    return {**{name: mod.launches for name, mod in _MODULES.items()},
            **_flash_mod.launches}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
    for name in _flash_mod.launches:
        _flash_mod.launches[name] = 0


__all__ = ["KernelSpec", "register_kernel", "get_kernel", "kernel_names",
           "resolve_config", "launch_config", "paged_attention_key", "int8_matmul_key",
           "flash_attention_key", "fused_ce_key",
           "build", "int8_matmul", "int8_matmul_plain",
           "paged_attention_rows", "paged_attention_rows_plain",
           "flash_attention_array", "flash_attention_plain",
           "flash_attention_bwd_plain",
           "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
           "launch_counts", "reset_launch_counts"]
