"""ctypes bindings to the port's native host runtime (port of
``paddle_tpu/core/native.py``).

The C++ sources are the port's own, in ``core/csrc/``: ``trace.cc`` (the
profiler's event ring and span ring), ``queue.cc`` (the bounded blocking
byte queue of the ``DataLoader``'s thread workers), ``arena.cc`` (the
host staging arena), ``embed.cc`` (the host embedding's unique, gather,
duplicate-id merge and sparse SGD/Adagrad updates) and ``tokenizer.cc``
(``text.FasterTokenizer``'s BasicTokenizer and WordPiece), with the
reference's C ABI (``ptt_*``, ``ptq_*``, ``pta_*``, ``pte_*``, ``ptk_*``). They are built together at
first use with ``g++ -O2 -fPIC -std=c++17 -pthread -shared`` into
``paddle_tpu_torch/_build/`` (listed in ``.gitignore``), under a file name
that carries the sources' hash, so an edited source is rebuilt and an
unchanged one loaded as it is.

A build or load failure raises at the first call that needs the library;
nothing falls back to a Python sink. The reference's rendezvous store is
``distributed/coord.py``'s adapter of torch's ``TCPStore``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["lib", "build", "library_path", "HAS_SPANS", "NativeQueue"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("trace.cc", "queue.cc", "arena.cc", "embed.cc", "tokenizer.cc")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-pthread", "-shared"]

_lib = None
_lock = threading.Lock()

# True once the loaded library is the port's: its trace ring always carries
# the span ring (the name is the reference's)
HAS_SPANS = False

_P, _I64, _U32, _U64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,
                        ctypes.c_uint64)
_SIGS = {
    # queue.cc
    "ptq_create": ((_I64,), _P),
    "ptq_push": ((_P, ctypes.c_char_p, _I64), ctypes.c_int),
    "ptq_pop_size": ((_P,), _I64),
    "ptq_pop_into": ((_P, _P, _I64), _I64),
    "ptq_close": ((_P,), None),
    "ptq_size": ((_P,), _I64),
    "ptq_destroy": ((_P,), None),
    # trace.cc
    "ptt_create": ((_I64,), _P),
    "ptt_destroy": ((_P,), None),
    "ptt_intern": ((_P, ctypes.c_char_p), _U32),
    "ptt_now_ns": ((), _U64),
    "ptt_record": ((_P, _U32, _U32, _U64, _U64), None),
    "ptt_drain": ((_P, _P, _I64), _I64),
    "ptt_span_record": ((_P, _U32, _U32, _U64, _U64, _U64, _U64), None),
    "ptt_span_drain": ((_P, _P, _I64), _I64),
    "ptt_name": ((_P, _U32), ctypes.c_char_p),
    "ptt_reset": ((_P,), None),
    "ptt_dropped": ((_P, ctypes.c_int32), _I64),
    # arena.cc
    "pta_create": ((_I64,), _P),
    "pta_destroy": ((_P,), None),
    "pta_alloc": ((_P, _I64), _P),
    "pta_free": ((_P, _P), None),
    "pta_bytes": ((_P,), _I64),
    "pta_reused": ((_P,), _I64),
    # embed.cc
    "pte_unique": ((_P, _I64, _P, _P, _I64), _I64),
    "pte_gather_f32": ((_P, _I64, _I64, _P, _I64, _P, _I64), ctypes.c_int),
    "pte_sgd_f32": ((_P, _I64, _I64, _P, _I64, _P, ctypes.c_float, _I64),
                    ctypes.c_int),
    "pte_adagrad_f32": ((_P, _P, _I64, _I64, _P, _I64, _P, ctypes.c_float,
                         ctypes.c_float, _I64), ctypes.c_int),
    "pte_merge_f32": ((_P, _I64, _P, _I64, _P, _P, _I64), _I64),
    # tokenizer.cc
    "ptk_create": ((ctypes.c_char_p, ctypes.c_int), _P),
    "ptk_destroy": ((_P,), None),
    "ptk_vocab_size": ((_P,), _I64),
    "ptk_token_id": ((_P, ctypes.c_char_p), _I64),
    "ptk_encode": ((_P, ctypes.c_char_p, _P, _I64), _I64),
}


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), shutil.which("g++")):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("g++ not found (set CXX): the port's native runtime "
                       "is built from core/csrc at first use")


def library_path() -> Path:
    """The library's path in ``_build/``: its name carries the sha1 of the
    sources and the flags."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"libpaddle_tpu_torch_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the sources into :func:`library_path` unless it is there;
    the library appears by one rename, so processes that build at once never
    load a half-written file. Raises on a failed compile."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp),
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native runtime build failed ({' '.join(cmd)}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded native runtime, built on the first call; raises when it
    cannot be built or loaded."""
    global _lib, HAS_SPANS
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(str(build()))
            for fn, (argtypes, restype) in _SIGS.items():
                getattr(L, fn).argtypes = list(argtypes)
                getattr(L, fn).restype = restype
            HAS_SPANS = True
            _lib = L
    return _lib


class NativeQueue:
    """Bounded blocking queue of byte strings in C++: ``push`` blocks while
    ``capacity`` buffers wait and returns False once closed; ``pop`` blocks
    for the next buffer and returns None once closed and drained. The GIL
    is released while either waits or copies."""

    def __init__(self, capacity: int):
        self._L = lib()
        self._q = self._L.ptq_create(int(capacity))

    def push(self, data: bytes) -> bool:
        return self._L.ptq_push(self._q, data, len(data)) == 0

    def pop(self):
        n = self._L.ptq_pop_size(self._q)
        if n <= 0:
            return None
        buf = ctypes.create_string_buffer(int(n))
        got = self._L.ptq_pop_into(self._q, buf, n)
        if got <= 0:
            return None
        return buf.raw[:int(got)]

    def close(self):
        self._L.ptq_close(self._q)

    def __len__(self):
        return int(self._L.ptq_size(self._q))

    def __del__(self):
        q, self._q = getattr(self, "_q", None), None
        if q:
            self._L.ptq_destroy(q)
