"""paddle.reader — legacy reader decorators (port of
``paddle_tpu/reader/__init__.py``; reference
python/paddle/reader/decorator.py). Pure-python generator combinators over
"reader creators" (zero-arg callables returning iterators); kept for v1 API
compatibility — new code feeds paddle.io.DataLoader directly.
"""
from __future__ import annotations

import itertools
import random as _random
from queue import Queue
from threading import Thread

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "ComposeNotAligned"]


class ComposeNotAligned(ValueError):
    pass


def cache(reader):
    """Cache the first full pass in memory; later passes replay it
    (decorator.py:52). Only a COMPLETE pass is committed — a reader that
    raises mid-pass leaves the cache empty so a retry starts clean."""
    state = {}

    def impl():
        if "data" not in state:
            state["data"] = list(reader())  # commits only on full success
        return iter(state["data"])

    return impl


def map_readers(func, *readers):
    """Apply ``func`` across the zipped outputs of ``readers``
    (decorator.py:92)."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (decorator.py:134): fill a buf_size window, yield in
    random order."""

    def impl():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return impl


def chain(*readers):
    """Concatenate readers sequentially (decorator.py:183)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, check_alignment=True):
    """Zip readers into flattened tuples (decorator.py:246)."""

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        it = itertools.zip_longest(*rs) if check_alignment else zip(*rs)
        for outputs in it:
            if check_alignment and any(o is None for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned (different lengths)")
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Read ahead into a bounded queue on a worker thread (decorator.py:306)."""

    end = object()

    def impl():
        q = Queue(maxsize=size)

        def fill():
            try:
                for d in reader():
                    q.put(d)
                q.put(end)
            except BaseException as exc:  # propagate instead of hanging
                q.put(exc)

        t = Thread(target=fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is end:
                return
            if isinstance(e, BaseException):
                raise e
            yield e

    return impl


def firstn(reader, n):
    """First n items (decorator.py:360)."""

    def impl():
        for i, item in enumerate(reader()):
            if i >= n:
                return
            yield item

    return impl


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (decorator.py:372)."""

    end = object()

    def impl():
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)

        def feed():
            try:
                for i, d in enumerate(reader()):
                    in_q.put((i, d))
            except BaseException as exc:
                out_q.put(exc)
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                e = in_q.get()
                if e is end:
                    out_q.put(end)
                    return
                i, d = e
                try:
                    out_q.put((i, mapper(d)))
                except BaseException as exc:  # re-raised by the consumer
                    out_q.put(exc)
                    out_q.put(end)
                    return

        Thread(target=feed, daemon=True).start()
        workers = [Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()
        finished = 0
        pending = {}
        next_i = 0
        while finished < process_num:
            e = out_q.get()
            if e is end:
                finished += 1
                continue
            if isinstance(e, BaseException):
                raise e
            if not order:
                yield e[1]
                continue
            pending[e[0]] = e[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        while order and next_i in pending:
            yield pending.pop(next_i)
            next_i += 1

    return impl
