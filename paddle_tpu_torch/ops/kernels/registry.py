"""Kernel registry (port of ``paddle_tpu/ops/kernels/registry.py``): every
tunable kernel of the port behind one config-resolution door.

Each registered kernel declares (a) a **default config** equal to the
launch it made before this layer existed, and (b) a **config space** of the
axes its kernel really has (the paged kernel's cluster size, the int8
head's weight rows a block, the fused CE's row block). Call sites ask
:func:`resolve_config` for the config to launch with:

- ``FLAGS_kernel_autotune=off`` (default): a dict probe returning a copy of
  the declared defaults; no autotuner, no tuning-DB I/O, no verifier,
  nothing imported beyond this module (the inert-layer contract, held by
  ``tests/test_torch_kernel_registry.py``).
- ``ondemand``: winners persisted in the on-disk tuning DB (``db.py``) are
  used when present; a miss falls back to the defaults. Never searches.
- ``search``: a DB miss runs a measured-timing search over the config space
  (``autotune.py``) and persists the verified winner.

The reference resolves once at trace time; the port runs eagerly, so its
call sites resolve on every launch, through :func:`launch_config`: with
``off`` that is one flag read and the spec's own (read-only) defaults, no
key built; with ``ondemand``/``search`` the key is built and the autotuner
memoises each ``(kernel, key)`` in the process.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from ...framework import flags

__all__ = ["KernelSpec", "register_kernel", "get_kernel", "kernel_names",
           "resolve_config", "launch_config", "dtype_name", "pow2"]

_TUNING = ("ondemand", "search")

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}


def dtype_name(dtype) -> str:
    """The reference's dtype string in a key (``"bfloat16"``, never
    ``"torch.bfloat16"``), from a torch dtype or a name."""
    name = _DTYPE_NAMES.get(dtype)
    return name if name is not None else str(dtype).replace("torch.", "")


def pow2(n: int) -> int:
    """The least power of two >= n (1 for n <= 1): a key's bucketed axis."""
    n = int(n)
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel.

    ``runner(key)`` returns ``make(config) -> step`` where ``step()`` runs
    the kernel once on inputs shaped like ``key`` and returns its output:
    the autotuner's measurement and verification harness. ``valid`` filters
    configs that cannot launch for ``key``. ``source`` names the kernel's
    ``csrc/<source>.cu``, whose digest keys its tuning-DB entries (None for
    a kernel without one). Runner and valid are only touched in
    ``ondemand``/``search``.
    """

    name: str
    defaults: Mapping[str, Any]
    space: Mapping[str, Tuple[Any, ...]]
    runner: Optional[Callable[[tuple], Callable[[dict], Callable[[], Any]]]] = None
    valid: Optional[Callable[[dict, tuple], bool]] = None
    source: Optional[str] = None


_REGISTRY: Dict[str, KernelSpec] = {}


def register_kernel(name: str, *, defaults: Mapping[str, Any],
                    space: Mapping[str, Tuple[Any, ...]],
                    runner=None, valid=None, source=None) -> KernelSpec:
    """Register (or re-register: last wins, so tests can stub) a kernel."""
    spec = KernelSpec(name=name,
                      defaults=types.MappingProxyType(dict(defaults)),
                      space={k: tuple(v) for k, v in space.items()},
                      runner=runner, valid=valid, source=source)
    _REGISTRY[name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    return _REGISTRY[name]


def kernel_names():
    return sorted(_REGISTRY)


def resolve_config(name: str, key: tuple = ()) -> Dict[str, Any]:
    """The one config-resolution door every registered call site goes
    through. ``key`` is the kernel's shape bucket (each kernel's ``*_key``
    helper); the DB keys an entry on it, the device, the torch and CUDA
    versions and the kernel source's digest (``db.py``)."""
    spec = _REGISTRY[name]
    mode = flags.flag("FLAGS_kernel_autotune", "off")
    if mode not in _TUNING:
        # inert layer: a dict probe, nothing else
        return dict(spec.defaults)
    from . import autotune

    return autotune.resolve(spec, tuple(key), mode)


def launch_config(name: str, key_fn: Callable[..., tuple],
                  *args) -> Mapping[str, Any]:
    """The config a call site launches with, on every launch: with
    ``FLAGS_kernel_autotune`` off the spec's read-only defaults themselves
    (no key built, nothing copied); else ``resolve_config(name,
    key_fn(*args))``. The caller only reads it."""
    if flags._FLAGS.get("FLAGS_kernel_autotune", "off") not in _TUNING:
        return _REGISTRY[name].defaults
    return resolve_config(name, key_fn(*args))
