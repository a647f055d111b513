"""Gradient bucketing for data-parallel sync (port of
``paddle_tpu/distributed/fleet/grad_buckets.py``).

The reference's C++ Reducer (``paddle/fluid/imperative/reducer.cc``) fills
dtype-homogeneous, ``comm_buffer_size``-capped buckets in REVERSE
registration order, so the first bucket to fill is the last layer's, whose
backward finishes first. The plan coalesces per-parameter gradients into a
handful of large flat tensors, so the sync is a few big all-reduces instead
of hundreds of small ones. Every bucket is padded to a multiple of
``nranks * block`` elements, so it splits into whole per-rank shards of
whole quantization blocks. The geometry (buckets, offsets, padding) is
the reference's; ``flatten``/``unflatten`` work on torch tensors. For the
ZeRO-1 sharded weight update (``meta_optimizers``) a bucket also carries
each parameter's decay gate (``wds``; it may vary inside a bucket) and the
lr multiplier it shares (``plr``; a change of it starts a new bucket), and
the plan gives the shard size and the reduce-scatter and all-gather bytes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# Default bucket cap: the reference DataParallel's comm_buffer_size=25 (MB).
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024
# Quantization/shard granularity. Buckets are padded to a multiple of
# nranks*block so shards and blocks always divide evenly.
DEFAULT_BLOCK = 128


class Bucket:
    """One fused sync unit: a contiguous run of params (reverse-backward
    order) sharing one dtype."""

    __slots__ = ("indices", "shapes", "sizes", "offsets", "dtype", "size",
                 "padded", "wds", "plr")

    def __init__(self, indices, shapes, sizes, offsets, dtype, size, padded,
                 wds=None, plr=1.0):
        self.indices = tuple(indices)    # positions into the plan's param list
        self.shapes = tuple(shapes)
        self.sizes = tuple(sizes)
        self.offsets = tuple(int(o) for o in offsets)
        self.dtype = dtype               # a torch dtype
        self.size = int(size)            # live elements (sum of sizes)
        self.padded = int(padded)        # flat length incl. padding
        self.wds = tuple(float(w) for w in (wds or [1.0] * len(self.indices)))
        self.plr = float(plr)            # the bucket's lr multiplier

    @property
    def itemsize(self):
        return torch.empty((), dtype=self.dtype).element_size()

    @property
    def wd_scale(self):
        """The decay gate when every parameter of the bucket has the same,
        else None (``BucketPlan.wd_vector`` gives the gate an element)."""
        return self.wds[0] if len(set(self.wds)) <= 1 else None

    def key(self):
        return (self.indices, str(self.dtype).replace("torch.", ""),
                self.padded, self.wds, self.plr)


class BucketPlan:
    """Static bucket geometry for a fixed parameter list. ``nranks`` is the
    DP world the buckets are synced over (1 = bucketing alone, no shard
    constraint beyond block alignment)."""

    def __init__(self, buckets: Sequence[Bucket], nranks: int, block: int):
        self.buckets = list(buckets)
        self.nranks = int(nranks)
        self.block = int(block)
        self.signature = (self.nranks, self.block,
                          tuple(b.key() for b in self.buckets))

    def __len__(self):
        return len(self.buckets)

    def flatten(self, bucket: Bucket, tensors):
        """Concatenate the bucket's tensors (reverse-backward order) into one
        padded 1-D tensor of the bucket dtype."""
        parts = [t.reshape(-1).to(bucket.dtype) for t in tensors]
        pad = bucket.padded - bucket.size
        if pad:
            parts.append(parts[0].new_zeros((pad,)))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    def unflatten(self, bucket: Bucket, flat):
        """Views of a flat bucket, one per parameter (plan order)."""
        return [flat[off:off + sz].view(shape) for off, sz, shape in
                zip(bucket.offsets, bucket.sizes, bucket.shapes)]

    def shard_size(self, bucket: Bucket) -> int:
        return bucket.padded // self.nranks

    def wd_vector(self, bucket: Bucket):
        """The decay gate an element (float32, on the CPU) of a bucket whose
        parameters' gates differ; None when ``wd_scale`` holds. Padding
        takes 1.0."""
        if bucket.wd_scale is not None:
            return None
        parts = [np.full((sz,), w, np.float32)
                 for sz, w in zip(bucket.sizes, bucket.wds)]
        parts.append(np.ones((bucket.padded - bucket.size,), np.float32))
        return torch.from_numpy(np.concatenate(parts))

    def reduce_scatter_bytes(self, quantized: bool = False) -> int:
        """Per-replica payload bytes of one step's bucket reduce-scatters
        (one pass over each bucket)."""
        return self.sync_bytes(quantized) // 2

    def gather_bytes(self) -> int:
        """Per-replica bytes of the ZeRO-1 updated-parameter all-gather
        (full precision)."""
        return sum(b.padded * b.itemsize for b in self.buckets)

    def sync_bytes(self, quantized: bool = False) -> int:
        """Per-replica payload bytes of one step's bucket all-reduces, at a
        ring's two phases (reduce-scatter and all-gather); quantized
        buckets ship int8 and one f32 scale a block."""
        total = 0
        for b in self.buckets:
            if quantized:
                payload = b.padded * 1 + (b.padded // self.block) * 4
            else:
                payload = b.padded * b.itemsize
            total += payload * 2
        return total


def build_bucket_plan(
    params,
    nranks: int = 1,
    bucket_bytes: Optional[int] = None,
    block: int = DEFAULT_BLOCK,
    wd_of=None,
    plr_of=None,
) -> BucketPlan:
    """A plan over ``params`` (tensors): walk them in REVERSE registration
    order (last layer first — its gradient materializes first in backward)
    and split whenever the dtype or the lr multiplier (``plr_of(p)``)
    changes or the byte cap fills, as reducer.cc assembles its groups.
    ``wd_of(p)`` is each parameter's decay gate."""
    bucket_bytes = int(bucket_bytes or DEFAULT_BUCKET_BYTES)
    nranks = max(int(nranks), 1)
    align = nranks * int(block)
    params = list(params)
    n = len(params)

    metas = []  # (orig_index, shape, size, dtype, wd, plr), reverse order
    for rev_pos, p in enumerate(reversed(params)):
        shape = tuple(int(s) for s in p.shape)
        size = int(np.prod(shape)) if shape else 1
        wd = float(wd_of(p)) if wd_of is not None else 1.0
        plr = float(plr_of(p)) if plr_of is not None else 1.0
        metas.append((n - 1 - rev_pos, shape, size, p.dtype, wd, plr))

    buckets: List[Bucket] = []
    cur: list = []
    cur_bytes = 0

    def close():
        nonlocal cur, cur_bytes
        if not cur:
            return
        sizes = [m[2] for m in cur]
        offsets = list(np.cumsum([0] + sizes[:-1]).astype(int))
        size = int(sum(sizes))
        padded = int(-(-size // align) * align)
        buckets.append(Bucket([m[0] for m in cur], [m[1] for m in cur],
                              sizes, offsets, cur[0][3], size, padded,
                              [m[4] for m in cur], cur[0][5]))
        cur, cur_bytes = [], 0

    for m in metas:
        _, _, size, dt, _, plr = m
        nbytes = size * torch.empty((), dtype=dt).element_size()
        if cur and (dt != cur[0][3] or plr != cur[0][5]
                    or cur_bytes + nbytes > bucket_bytes):
            close()
        cur.append(m)
        cur_bytes += nbytes
    close()
    return BucketPlan(buckets, nranks, block)


__all__ = ["Bucket", "BucketPlan", "build_bucket_plan",
           "DEFAULT_BUCKET_BYTES", "DEFAULT_BLOCK"]
