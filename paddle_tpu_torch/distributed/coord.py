"""Coordination substrate (port of ``paddle_tpu/distributed/coord.py``): a
key-value store shared by the ranks and a two-phase commit barrier over it.

The watchdog, the coordinated checkpoint and the stability sentinel's
verdict barrier need a small store every rank reaches. :class:`FileStore`
keeps the reference's ``set/get/add/delete_key`` surface over a shared
directory (single-host jobs started by ``spawn`` or ``launch``), and
:class:`TCPStore` gives the same surface over ``torch.distributed.TCPStore``
(the counterpart of the reference's native store). Every wait here carries
a deadline, so a dead store can never be the reason recovery itself hangs.

:class:`CommitBarrier` is the two-phase barrier behind
``checkpoint.CoordinatedCheckpoint``: phase 1 collects one ack per rank
(each rank's shard is written, CRC'd and durable), phase 2 publishes one
commit record that every rank observes. A crash at any point before phase 2
leaves the step uncommitted on every rank, so a resume can never mix steps.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Optional

__all__ = [
    "FileStore", "TCPStore", "CommitBarrier", "DeadlineExceeded", "wait_for",
    "store_from_env",
]


class DeadlineExceeded(TimeoutError):
    """A coordinated wait ran past its deadline. Carries ``what`` (which
    wait) and ``waited_s`` so the flight dump / error names the stall."""

    def __init__(self, what: str, waited_s: float, detail: str = ""):
        super().__init__(
            f"deadline exceeded after {waited_s:.1f}s waiting for {what}"
            + (f" ({detail})" if detail else "")
        )
        self.what = what
        self.waited_s = waited_s


def wait_for(
    poll: Callable[[], bool],
    what: str,
    timeout_s: float,
    interval_s: float = 0.05,
    on_timeout: Optional[Callable[[], None]] = None,
) -> None:
    """Poll ``poll()`` until truthy or ``timeout_s`` elapses. The
    interruptible-wait analogue of watchdog.guard for store round-trips:
    polling loops need no monitor thread — the loop itself owns the clock.
    ``timeout_s<=0`` means no deadline (poll forever)."""
    t0 = time.monotonic()
    while not poll():
        if timeout_s > 0 and time.monotonic() - t0 > timeout_s:
            if on_timeout is not None:
                on_timeout()
            raise DeadlineExceeded(what, time.monotonic() - t0)
        time.sleep(interval_s)


class FileStore:
    """TCPStore-shaped KV over a shared directory (single host / shared fs).

    Writes are atomic (tmp + ``os.replace``); ``add`` uses a lock directory
    (``os.mkdir`` is atomic on POSIX) so concurrent increments from N ranks
    serialize. Keys map to files with ``/`` escaped, so the store survives
    arbitrary key grammars without creating directory trees.
    """

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        os.makedirs(self.path, exist_ok=True)

    def _file(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "%2f"))

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        f = self._file(key)
        fd, tmp = tempfile.mkstemp(dir=self.path, prefix=".tmp_")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(value)
            os.replace(tmp, f)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str):
        try:
            with open(self._file(key), "rb") as fh:
                return fh.read()
        except OSError:
            return None

    def add(self, key: str, amount: int = 1) -> int:
        lock = self._file(key) + ".lock"
        deadline = time.monotonic() + 30.0
        while True:
            try:
                os.mkdir(lock)
                break
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"FileStore.add: lock stuck for {key!r}")
                time.sleep(0.002)
        try:
            raw = self.get(key)
            cur = int(raw) if raw else 0
            cur += int(amount)
            self.set(key, str(cur))
            return cur
        finally:
            os.rmdir(lock)

    def delete_key(self, key: str) -> None:
        try:
            os.remove(self._file(key))
        except OSError:
            pass

    def keys(self):
        """All keys currently present (FileStore extension, used by the
        progress table to enumerate ranks)."""
        out = []
        for name in os.listdir(self.path):
            if name.startswith(".tmp_") or name.endswith(".lock"):
                continue
            out.append(name.replace("%2f", "/"))
        return out

    def close(self) -> None:
        pass


class TCPStore:
    """The reference's native TCP store surface (``set/get/add/wait/
    delete_key``; ``paddle_tpu/core/native.py``) over
    ``torch.distributed.TCPStore``. The master binds ``port`` (0 picks a
    free one, read back from :attr:`port`); the others connect to it.

    ``get`` returns None for a missing key as the native store does
    (torch's own ``get`` would block until its timeout): it asks
    ``check`` first. ``wait`` blocks at most ``timeout`` seconds (the
    store's timeout by default) and raises :class:`DeadlineExceeded`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 23456,
                 world_size: Optional[int] = None, is_master: bool = False,
                 timeout: float = 30.0):
        from datetime import timedelta

        import torch.distributed as dist

        self.host = host
        self.timeout = float(timeout)
        self._s = dist.TCPStore(host, int(port), world_size,
                                bool(is_master),
                                timedelta(seconds=self.timeout),
                                wait_for_workers=False)
        self.port = int(self._s.port)

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._s.set(key, value)

    def get(self, key: str, max_bytes=None):
        if not self._s.check([key]):
            return None
        return self._s.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        return int(self._s.add(key, int(amount)))

    def wait(self, key: str, timeout: Optional[float] = None):
        t = self.timeout if timeout is None else float(timeout)
        wait_for(lambda: self._s.check([key]), f"TCPStore key {key!r}", t,
                 interval_s=0.01)
        return self._s.get(key)

    def delete_key(self, key: str) -> None:
        self._s.delete_key(key)

    def close(self) -> None:
        self._s = None


def store_from_env() -> Optional[FileStore]:
    """The rank-shared store named by ``PADDLE_TPU_STORE_DIR`` (set by spawn
    / the chaos harness for its children), or None."""
    d = os.environ.get("PADDLE_TPU_STORE_DIR")
    return FileStore(d) if d else None


class CommitBarrier:
    """Two-phase commit over a store (TCPStore or FileStore).

    Phase 1 — ``ack(tag)``: this rank's local work for ``tag`` (a checkpoint
    step) is durable. Phase 2 — rank 0 waits for ``world_size`` acks and
    publishes the commit record; every other rank waits for it. Distinct
    tags are independent, so a retried save at a later step never collides
    with litter from a crashed earlier attempt.
    """

    def __init__(self, store, world_size: int, rank: int, prefix: str = "commit"):
        self.store = store
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.prefix = prefix

    def _ack_key(self, tag) -> str:
        return f"{self.prefix}/{tag}/acks"

    def _commit_key(self, tag) -> str:
        return f"{self.prefix}/{tag}/commit"

    def ack(self, tag) -> int:
        return self.store.add(self._ack_key(tag), 1)

    def reset(self, tag) -> None:
        """Clear litter a crashed earlier attempt left behind for ``tag``
        (stale acks / commit record). Rank 0 calls this when it ENTERS a
        save attempt, before serializing: without it, a relaunched job
        replaying to the same step would find the dead attempt's acks and
        commit before every rank of the new attempt has written durably —
        a torn checkpoint with a valid marker. Peers ack only after their
        own serialize+write completes, so in a lockstep world the reset
        strictly precedes this attempt's acks; losing that race merely
        times the save out (uncommitted, safe, retried next interval)."""
        self.store.delete_key(self._ack_key(tag))
        self.store.delete_key(self._commit_key(tag))

    def acks(self, tag) -> int:
        raw = self.store.get(self._ack_key(tag))
        return int(raw) if raw else 0

    def committed(self, tag) -> bool:
        return self.store.get(self._commit_key(tag)) is not None

    def commit(self, tag, timeout_s: float, payload: Optional[dict] = None) -> dict:
        """Run this rank's side of the two-phase commit for ``tag``. Returns
        the commit record. Raises :class:`DeadlineExceeded` when the other
        ranks never arrive — the caller (coordinated save) treats that as a
        failed, UNcommitted save and walks on."""
        if self.rank == 0:
            wait_for(
                lambda: self.acks(tag) >= self.world_size,
                f"commit barrier acks ({self.prefix}/{tag})",
                timeout_s,
            )
            rec = {"tag": str(tag), "ts": time.time(),
                   "world_size": self.world_size, **(payload or {})}
            self.store.set(self._commit_key(tag), json.dumps(rec))
            return rec
        wait_for(
            lambda: self.committed(tag),
            f"commit marker ({self.prefix}/{tag})",
            timeout_s,
        )
        return json.loads(self.store.get(self._commit_key(tag)))
