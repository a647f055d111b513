"""Variable-length batching (port of ``paddle_tpu/io/ragged.py``).

Sequence lengths map to a small fixed set of bucket boundaries; every batch
holds sequences of one bucket padded to its boundary, so a step sees at most
``len(boundaries)`` distinct shapes, and masks (``ignore_index`` labels,
attention masks) carry the ragged structure through attention and loss.
numpy only: the batches become tensors in the loader.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import Sampler

__all__ = ["BucketSampler", "bucket_boundaries", "pad_to_bucket_collate"]


def bucket_boundaries(lengths, num_buckets: int = 8, multiple: int = 8):
    """Pick bucket boundaries from observed lengths: length quantiles rounded
    UP to a multiple (default 8), deduplicated. The last boundary always
    covers max(lengths)."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(0, 1, num_buckets + 1)[1:])
    bounds = sorted({int(-(-int(np.ceil(q)) // multiple) * multiple) for q in qs})
    top = int(-(-int(lengths.max()) // multiple) * multiple)
    if not bounds or bounds[-1] < top:
        bounds.append(top)
    return bounds


def _bucket_of(length: int, bounds: Sequence[int]) -> int:
    for i, b in enumerate(bounds):
        if length <= b:
            return i
    return len(bounds) - 1


class BucketSampler(Sampler):
    """Batch sampler that groups indices into length buckets; every yielded
    batch pads to ONE boundary, so a step sees at most ``len(boundaries)``
    distinct shapes.

    ``lengths``: per-index sequence lengths (array, list, or callable
    ``idx -> len``).
    """

    def __init__(self, lengths, batch_size: int, boundaries: Optional[Sequence[int]] = None,
                 num_buckets: int = 8, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, data_source=None):
        if callable(lengths):
            if data_source is None:
                raise ValueError("callable lengths needs data_source for its range")
            lengths = [lengths(i) for i in range(len(data_source))]
        self.lengths = np.asarray(lengths, np.int64)
        self.batch_size = int(batch_size)
        self.boundaries = list(boundaries) if boundaries is not None else bucket_boundaries(
            self.lengths, num_buckets
        )
        if self.lengths.max(initial=0) > self.boundaries[-1]:
            raise ValueError(
                f"max length {int(self.lengths.max())} exceeds last boundary "
                f"{self.boundaries[-1]}"
            )
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __iter__(self):
        order = np.arange(len(self.lengths))
        rng = None
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
            self.epoch += 1
        buckets: dict = {i: [] for i in range(len(self.boundaries))}
        batches = []
        for idx in order:
            b = _bucket_of(int(self.lengths[idx]), self.boundaries)
            buckets[b].append(int(idx))
            if len(buckets[b]) == self.batch_size:
                batches.append(buckets[b])
                buckets[b] = []
        if not self.drop_last:
            for b, rest in buckets.items():
                if rest:
                    batches.append(rest)
        if self.shuffle:
            rng.shuffle(batches)
        return iter(batches)

    def __len__(self):
        counts: dict = {}
        for L in self.lengths:
            b = _bucket_of(int(L), self.boundaries)
            counts[b] = counts.get(b, 0) + 1
        if self.drop_last:
            return sum(c // self.batch_size for c in counts.values())
        return sum(-(-c // self.batch_size) for c in counts.values())


def pad_to_bucket_collate(boundaries: Sequence[int], pad_value=0,
                          label_pad_value=-100, returns_label: bool = False):
    """Collate building padded batches whose width is the smallest boundary
    covering the batch (consistent with BucketSampler's grouping, so the two
    stay decoupled). Samples are 1-D id arrays, or (ids, label) pairs when
    ``returns_label`` — labels pad with ``ignore_index`` (-100) so the
    standard CE loss masks padding with no extra plumbing.

    Returns (padded, lengths) or (padded, labels, lengths)."""
    bounds = list(boundaries)

    def collate(batch):
        if returns_label:
            seqs = [np.asarray(s[0]) for s in batch]
            labels = [np.asarray(s[1]) for s in batch]
        else:
            seqs = [np.asarray(s) for s in batch]
            labels = None
        maxlen = max(s.shape[0] for s in seqs)
        width = bounds[_bucket_of(maxlen, bounds)]
        lengths = np.asarray([s.shape[0] for s in seqs], np.int64)
        out = np.full((len(seqs), width), pad_value, seqs[0].dtype)
        for i, s in enumerate(seqs):
            out[i, : s.shape[0]] = s
        if labels is None:
            return out, lengths
        lab = np.full((len(labels), width), label_pad_value,
                      np.asarray(labels[0]).dtype)
        for i, l in enumerate(labels):
            lab[i, : l.shape[0]] = l
        return out, lab, lengths

    return collate
