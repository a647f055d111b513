"""Fixed-size KV block pool — the paged-cache allocator (port of
``paddle_tpu/serving/pool.py``; host-only bookkeeping).

The device holds ONE preallocated pool of ``num_blocks`` KV blocks per engine
(``(layers, num_blocks, block_size, kv_heads, head_dim)`` for K and V);
sequences own ``ceil(len / block_size)`` block ids each, recorded in a
per-sequence block table.

Block 0 is the reserved TRASH block: padding rows of a bucketed batch and
padded tail entries of short rows point their table slots at it, so the
step functions can scatter unconditionally — trash is written freely and
never read as live context.

Allocating more than is free returns ``None`` (the scheduler turns that into
backpressure or preemption), freeing an unowned id raises (double-free), and
``check()`` asserts conservation. Blocks are refcounted: ``share`` bumps an
owned block and ``free`` drops one reference. Engine-thread only.

Under device-memory pressure the scheduler PARKS blocks: :meth:`park` moves
free blocks to a set ``alloc`` cannot see, so admission backs off to a
smaller working set; :meth:`unpark` returns them. Parking draws only from
the free list, so a block with live references is never parked.

The bookkeeping is snapshottable: :meth:`snapshot` captures the free list,
refcounts and parked set with a CRC over their canonical encoding (the
reference's, ``zlib.crc32`` of a ``repr``), and :meth:`restore` rebuilds a
pool from a capture or raises :class:`SnapshotError` for a torn or tampered
one.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional

from ..profiler import counter_inc

__all__ = ["PagePool", "SnapshotError", "TRASH_BLOCK"]

TRASH_BLOCK = 0

POOL_SNAPSHOT_VERSION = 1


class SnapshotError(RuntimeError):
    """A serving-state snapshot failed validation (a torn capture, tampering,
    or an incompatible target): callers fall back to re-prefill rather than
    serve from suspect KV state."""


def _pool_crc(num_blocks: int, free, ref, parked) -> int:
    payload = (num_blocks, tuple(free), tuple(sorted(ref.items())),
               tuple(parked))
    return zlib.crc32(repr(payload).encode())


class PagePool:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("PagePool needs >= 2 blocks (block 0 is trash)")
        self.num_blocks = int(num_blocks)
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: List[int] = list(range(self.num_blocks - 1, TRASH_BLOCK, -1))
        self._ref: Dict[int, int] = {}  # owned block id -> reference count
        # withdrawn from circulation under memory pressure (park()): invisible
        # to alloc, still conserved by check()
        self._parked: List[int] = []

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids, or None when the pool can't cover them (nothing
        is partially allocated)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        counter_inc("serve_pages_allocated", n)
        return ids

    def share(self, ids) -> None:
        """Bump the refcount of already-owned blocks; sharing an unowned id
        raises."""
        for b in ids:
            if b not in self._ref:
                raise RuntimeError(f"PagePool: share of unowned block id {b}")
        for b in ids:
            self._ref[b] += 1
        if ids:
            counter_inc("serve_pages_shared", len(ids))

    def refcount(self, bid: int) -> int:
        """Current reference count of a block (0 = not owned)."""
        return self._ref.get(bid, 0)

    def free(self, ids) -> None:
        """Drop one reference per id; a block returns to the free list when
        its count hits zero. Freeing an unowned id raises (double-free)."""
        released = 0
        for b in ids:
            if b not in self._ref:
                raise RuntimeError(f"PagePool: double-free or foreign block id {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                self._free.append(b)
                released += 1
        counter_inc("serve_pages_freed", released)

    @property
    def parked_blocks(self) -> int:
        return len(self._parked)

    def park(self, n: int) -> int:
        """Withdraw up to ``n`` FREE blocks from circulation (memory-pressure
        headroom shrink); running sequences keep what they own. One free
        block always stays, so a lone sequence can still grow. Returns how
        many were parked."""
        if n < 0:
            raise ValueError(f"park({n})")
        take = max(min(int(n), len(self._free) - 1), 0)
        for _ in range(take):
            self._parked.append(self._free.pop())
        if take:
            counter_inc("serve_pages_parked", take)
        return take

    def unpark(self, n: Optional[int] = None) -> int:
        """Return parked blocks to the free list (all of them by default)."""
        take = len(self._parked) if n is None \
            else min(int(n), len(self._parked))
        for _ in range(take):
            self._free.append(self._parked.pop())
        if take:
            counter_inc("serve_pages_unparked", take)
        return take

    def damage(self) -> None:
        """Break conservation on purpose (the ``serve.pool_corrupt``
        injection point): an owned block is forgotten, so its next ``free``
        (or ``check``) raises."""
        if self._ref:
            self._ref.pop(next(iter(self._ref)))
        elif self._free:
            self._free.append(self._free[-1])
        counter_inc("serve_pool_damaged")

    def check(self) -> None:
        """Conservation: every non-trash block is exactly one of free, owned
        or parked, and every owned block has a refcount >= 1."""
        if len(self._free) + len(self._ref) + len(self._parked) \
                != self.num_blocks - 1:
            raise RuntimeError(
                f"PagePool leak: {len(self._free)} free + {len(self._ref)} "
                f"owned + {len(self._parked)} parked != {self.num_blocks - 1}")
        circulating = set(self._free) | set(self._parked)
        if len(circulating) != len(self._free) + len(self._parked) \
                or circulating & set(self._ref):
            raise RuntimeError("PagePool: block in two states at once")
        if TRASH_BLOCK in circulating or TRASH_BLOCK in self._ref:
            raise RuntimeError("PagePool: trash block entered circulation")
        if any(c < 1 for c in self._ref.values()):
            raise RuntimeError("PagePool: owned block with refcount < 1")

    # -- snapshot / restore ---------------------------------------------------
    def snapshot(self) -> dict:
        """O(blocks) capture of the bookkeeping, with a CRC over its
        canonical encoding. Taken at a scheduler step boundary or from a dead
        scheduler's frozen state (the pool is engine-thread only)."""
        snap = {"version": POOL_SNAPSHOT_VERSION,
                "num_blocks": self.num_blocks,
                "free": list(self._free),
                "ref": dict(self._ref),
                "parked": list(self._parked)}
        snap["crc"] = _pool_crc(self.num_blocks, self._free, self._ref,
                                self._parked)
        return snap

    @classmethod
    def restore(cls, snap: dict) -> "PagePool":
        """A pool rebuilt from :meth:`snapshot`, or :class:`SnapshotError`:
        the CRC, id ranges, duplicates, conservation and refcounts must all
        hold, or the capture is rejected whole."""
        try:
            if snap.get("version") != POOL_SNAPSHOT_VERSION:
                raise SnapshotError(
                    f"pool snapshot version {snap.get('version')!r} "
                    f"!= {POOL_SNAPSHOT_VERSION}")
            num_blocks = int(snap["num_blocks"])
            free = [int(b) for b in snap["free"]]
            ref = {int(b): int(c) for b, c in snap["ref"].items()}
            parked = [int(b) for b in snap["parked"]]
        except SnapshotError:
            raise
        except Exception as e:
            raise SnapshotError(f"malformed pool snapshot: {e!r}") from e
        if _pool_crc(num_blocks, free, ref, parked) != snap.get("crc"):
            raise SnapshotError("pool snapshot CRC mismatch (torn capture)")
        ids = free + list(ref) + parked
        if any(b <= TRASH_BLOCK or b >= num_blocks for b in ids):
            raise SnapshotError("pool snapshot: block id out of range")
        if len(set(ids)) != len(ids):
            raise SnapshotError("pool snapshot: block in two states at once")
        pool = cls(num_blocks)
        pool._free = free
        pool._ref = ref
        pool._parked = parked
        try:
            pool.check()
        except RuntimeError as e:
            raise SnapshotError(f"pool snapshot failed check(): {e}") from e
        counter_inc("serve_pool_restores")
        return pool
