"""Build and load the port's C inference API (``csrc/paddle_tpu_c.{h,cc}``)
and its demo host (``csrc/capi_demo.cc``).

Both are built with g++ at first use into ``paddle_tpu_torch/_build/``
(listed in ``.gitignore``), under names that carry the sha1 of the sources
and the flags, as ``core/native.py`` builds the host runtime: the library
``libpaddle_tpu_torch_c-<hash>.so`` with ``python3-config --includes`` and
``--ldflags --embed`` of this interpreter, the demo linked to it. The
library starts an embedded interpreter as this one (its executable is
compiled in), so a host outside Python finds the same packages. A failed
build raises; nothing falls back.

``lib()`` loads the library with its ctypes signatures; from inside Python
its calls attach to the running interpreter. ``create_predictor(prefix,
device)`` is what the C layer calls to make a predictor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

__all__ = ["build", "build_demo", "lib", "create_predictor"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None  # guarded_by: _lock

_P, _S, _I, _I64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_int64)
_SIGS = {
    "PD_Init": ((_S,), _I),
    "PD_PredictorCreate": ((_S,), _P),
    "PD_PredictorCreateOnDevice": ((_S, _S), _P),
    "PD_PredictorSetInputFloat": (
        (_P, _S, ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_I64), _I),
        _I),
    "PD_PredictorRun": ((_P,), _I),
    "PD_PredictorOutputNumel": ((_P, _S), _I64),
    "PD_PredictorOutputShape": (
        (_P, _S, ctypes.POINTER(_I64), ctypes.POINTER(_I)), _I),
    "PD_PredictorGetOutputFloat": (
        (_P, _S, ctypes.POINTER(ctypes.c_float), _I64), _I),
    "PD_PredictorInputName": ((_P, _I), _S),
    "PD_PredictorOutputName": ((_P, _I), _S),
    "PD_PredictorDestroy": ((_P,), None),
    "PD_LastError": ((), _S),
}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found (set CXX): the C inference API is "
                       "built from inference/csrc at first use")


def _python_config() -> str:
    """This interpreter's ``python3-config``: beside its executable, else
    ``python<version>-config`` or ``python3-config`` on PATH."""
    ver = sysconfig.get_config_var("VERSION")
    here = Path(sys.executable).parent
    for cand in (here / f"python{ver}-config", here / "python3-config",
                 shutil.which(f"python{ver}-config"),
                 shutil.which("python3-config")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("python3-config not found: the C inference API "
                       "compiles against this interpreter's headers")


def _py_flags():
    """(compile flags, link flags) from ``python3-config``; raises unless
    they name this interpreter's version."""
    cfg = _python_config()

    def run(*args):
        out = subprocess.run([cfg, *args], capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"{cfg} {' '.join(args)} failed: "
                               f"{out.stderr}")
        return out.stdout.split()

    inc = run("--includes")
    ldf = run("--ldflags", "--embed")
    ver = sysconfig.get_config_var("VERSION")
    if not any(f"python{ver}" in f for f in inc):
        raise RuntimeError(f"{cfg} --includes {inc} is not python{ver}'s")
    libdir = sysconfig.get_config_var("LIBDIR")
    return inc, ldf + ([f"-Wl,-rpath,{libdir}"] if libdir else [])


def _digest(*names, extra=b"") -> str:
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode() + extra
                     + sys.executable.encode())
    for n in names:
        h.update(n.encode() + (CSRC / n).read_bytes())
    return h.hexdigest()[:12]


def _compile(cmd, out: Path) -> Path:
    """Run ``cmd`` (its output file last) into a tmp file, then rename it
    onto ``out``; raises on a failed compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    proc = subprocess.run([*cmd, str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"C inference API build failed "
                           f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """The library's path in ``_build/``, compiled unless it is there."""
    out = BUILD_DIR / (f"libpaddle_tpu_torch_c-"
                       f"{_digest('paddle_tpu_c.h', 'paddle_tpu_c.cc')}.so")
    if out.exists():
        return out
    inc, ldf = _py_flags()
    exe = sys.executable.replace("\\", "\\\\").replace('"', '\\"')
    return _compile([_cxx(), *CXX_FLAGS, "-shared", *inc,
                     f'-DPTT_PYTHON_EXECUTABLE="{exe}"',
                     str(CSRC / "paddle_tpu_c.cc"), *ldf, "-o"], out)


def build_demo() -> Path:
    """The ``capi_demo`` binary, linked to the library (by its path, with
    an rpath to ``_build/``), compiled unless it is there."""
    so = build()
    out = BUILD_DIR / f"capi_demo-{_digest('capi_demo.cc', extra=so.name.encode())}"
    if out.exists():
        return out
    return _compile([_cxx(), *CXX_FLAGS, f"-I{CSRC}",
                     str(CSRC / "capi_demo.cc"), str(so),
                     f"-Wl,-rpath,{BUILD_DIR}", "-o"], out)


def lib() -> ctypes.CDLL:
    """The loaded library (built on the first call) with its signatures."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            for fn, (argtypes, restype) in _SIGS.items():
                getattr(L, fn).argtypes = list(argtypes)
                getattr(L, fn).restype = restype
            _lib = L
        return _lib


def create_predictor(prefix: str, device=None):
    """A ``Predictor`` of the artifact at ``prefix`` on ``device`` ("cpu",
    "cuda", "cuda:<id>"; None: the card): ``PD_PredictorCreate*``'s body."""
    from . import Config, Predictor

    cfg = Config(prefix)
    if device is not None:
        import torch

        dev = torch.device(device)
        if dev.type == "cpu":
            cfg.disable_gpu()
        elif dev.type == "cuda":
            cfg.enable_use_gpu(device_id=dev.index or 0)
        else:
            raise ValueError(f"PD_PredictorCreateOnDevice: device {device!r}"
                             " is not cpu or cuda")
    return Predictor(cfg)
