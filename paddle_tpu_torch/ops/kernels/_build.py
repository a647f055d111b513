"""Build the CUDA C++ kernels in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``paddle_tpu_torch/_build/`` (listed in
``.gitignore``), under a file name that carries the source's hash, so an
edited source is rebuilt and an unchanged one is loaded as it is. The
library is loaded with ``ctypes``: pointers and the stream go as
``c_void_p``, ints as ``c_int``. Every C entry returns ``cudaGetLastError()``
after its launch and the wrapper raises if that is not 0.

A build failure raises. It never turns into "use the plain version".
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded_by: _lock


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (set NVCC or put the CUDA toolkit's bin on PATH); "
        "the CUDA kernels are built from source at first use")


def source_digest(name: str) -> str:
    """sha1 (12 hex digits) of ``csrc/<name>.cu`` and the nvcc flags: the
    library's file name carries it, and the tuning DB keys its entries on
    it, so an edited kernel is rebuilt and never takes an old build's
    tuned config."""
    src = (CSRC / f"{name}.cu").read_bytes()
    return hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every named kernel source that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns, per name,
    ``{"seconds", "ptxas", "cached"}`` (``ptxas`` is nvcc's ``-Xptxas -v``
    report); raises on any failed compile."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, log = {}, {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name)
        if out.exists():
            log[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        log[name] = {"seconds": round(time.monotonic() - t0, 3),
                     "ptxas": text, "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return log


def open_library(path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library at ``path``, with ``argtypes``/``restype`` set from
    ``signatures`` (C entry name -> (argtypes tuple, restype)) and for every
    library's ``pt_error_string``."""
    lib = ctypes.CDLL(str(path))
    sigs = dict(signatures, pt_error_string=((ctypes.c_int,), ctypes.c_char_p))
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = restype
    return lib


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first call); see
    ``open_library``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = open_library(_target(name), signatures)
        return lib


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t``."""
    if rc:
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({lib.pt_error_string(rc).decode()})")
