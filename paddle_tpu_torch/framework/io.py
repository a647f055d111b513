"""File writes other processes may read (the port's copy of the reference's
``paddle_tpu/framework/io.py`` ``atomic_open``)."""
from __future__ import annotations

import contextlib
import itertools
import os
import threading

__all__ = ["atomic_open"]

_tmp_seq = itertools.count(1)  # same-process same-path writers get unique tmps


@contextlib.contextmanager
def atomic_open(path: str, mode: str = "w"):
    """Open a tmp file beside ``path``, flush and fsync it, and ``os.replace``
    it over ``path`` on a clean exit (removed on error). A reader, at any
    time or after a kill mid-write, sees the old content or the whole new
    write, never a torn file. The tmp name carries the pid, the thread id
    and a sequence number, so two threads writing one path never truncate
    each other's tmp."""
    tmp = f"{path}.tmp{os.getpid()}-{threading.get_ident()}-{next(_tmp_seq)}"
    try:
        with open(tmp, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
