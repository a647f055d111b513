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
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..profiler import counter_inc

__all__ = ["PagePool", "TRASH_BLOCK"]

TRASH_BLOCK = 0


class PagePool:
    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("PagePool needs >= 2 blocks (block 0 is trash)")
        self.num_blocks = int(num_blocks)
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: List[int] = list(range(self.num_blocks - 1, TRASH_BLOCK, -1))
        self._ref: Dict[int, int] = {}  # owned block id -> reference count

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

    def check(self) -> None:
        """Conservation: every non-trash block is exactly one of free or
        owned, and every owned block has a refcount >= 1."""
        if len(self._free) + len(self._ref) != self.num_blocks - 1:
            raise RuntimeError(
                f"PagePool leak: {len(self._free)} free + {len(self._ref)} "
                f"owned != {self.num_blocks - 1}")
        free = set(self._free)
        if len(free) != len(self._free) or free & set(self._ref):
            raise RuntimeError("PagePool: block in two states at once")
        if TRASH_BLOCK in free or TRASH_BLOCK in self._ref:
            raise RuntimeError("PagePool: trash block entered circulation")
        if any(c < 1 for c in self._ref.values()):
            raise RuntimeError("PagePool: owned block with refcount < 1")
