"""Host-offloaded giant embedding, the parameter server's capability
(port of ``paddle_tpu/incubate/host_embedding.py``).

Parity (capability, not design): the reference's brpc PS serves embedding
tables far larger than device memory (``memory_sparse_table.cc``, the
disk-backed ``ssd_sparse_table.cc``, ``the_one_ps.py:606``,
``distributed_lookup_table_op`` and the SelectedRows sparse rules of
``sparse_sgd_rule.cc``). Here the table lives in host memory (RAM, or a
sparse ``np.memmap`` whose logical size is bounded by the disk), each step
moves only the touched rows to the card, and the sparse optimizer update
is applied on the host to exactly those rows. The card holds O(unique ids
a batch x dim), never the table.

A step (PS pull, dense compute, push)::

    ids -> unique (host) -> table.gather(uniq) -> device leaf ``rows``
    -> out = rows[inverse]  (a select whose backward sums duplicate ids
       in input order)
    -> backward gives rows.grad (small, dense)
    -> apply_gradients(): host scatter-update of the touched rows

The host work runs on the port's native library (``core/csrc/embed.cc``:
multi-threaded unique, gather, duplicate-id merge and the SGD / row-wise
Adagrad scatter, bit-exact with numpy) while ``FLAGS_host_emb_native`` is
set, the default; a library that cannot be built raises. Only
``FLAGS_host_emb_native=0`` selects the numpy path, as an explicit choice.

Two accelerations, each off by default and bit-exact against the plain
synchronous path where the docstrings say so:

* the device hot-row cache (``FLAGS_host_emb_cache_rows`` or
  ``HostEmbedding(cache_rows=)``): the head of the id distribution lives
  on the card, admitted by a count-min frequency sketch. With SGD its
  buffer is an autograd leaf the forward gathers from, so the hot rows'
  gradients accumulate on it across micro-batches and the push is one
  device update; the eviction and ``flush()`` write rows back to the host
  table. The cache is clamped to ``FLAGS_host_emb_cache_frac`` of
  ``fault.memory.budget_bytes()`` and halved by a pressure handler;
* the pipelined pull and push: ``prefetch(ids)`` (or ``prefetch_iter``)
  hands the unique, gather and host-to-device copy (through pinned memory)
  to a PS worker thread, and ``FLAGS_host_emb_async_push`` sends the push
  to the same worker. The worker runs jobs in FIFO order, and a push
  patches the prefetched packs it overlaps, so the pipelined run gives the
  synchronous run's numbers. The worker holds only a weakref to the layer.

The reference pads its device packs to powers of two so XLA compiles a
bounded number of programs; PyTorch runs eagerly, so the port's packs keep
their exact sizes. The reference's forward gathers with ``r[iv]``, whose
gradient sums duplicate ids in input order on the CPU; on the card the
backward of a PyTorch gather sums them with atomics in no fixed order, so
the port's select has a backward of its own that adds each id's k-th
occurrence in round k, in input order, on any device.

The sharded table's pull and push go through the port's
``distributed.coord.TCPStore``: one coalesced payload a peer, split into
``FLAGS_host_emb_chunk_bytes`` messages over
``FLAGS_host_emb_transport_threads`` extra store connections. When those
connections cannot be opened the transport stays serial, as the
reference's does, and counts it in ``host_emb_transport_serial``.
"""
from __future__ import annotations

import ctypes
import os
import queue as _queue
import struct
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from .. import profiler as _prof
from ..core.place import resolve_device
from ..framework import flags as _flags
from ..nn.layer.layers import Layer
from ..profiler.spans import span as _span

__all__ = [
    "HostEmbeddingTable", "HostEmbedding", "ShardedHostEmbeddingTable",
    "HotRowCache", "sharded_host_embedding",
]


def sharded_host_embedding(num_embeddings, embedding_dim, store=None, **kw):
    """A HostEmbedding whose table is sharded across the trainer processes
    of the current job (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``;
    the rendezvous through ``store`` or a TCPStore at
    ``PADDLE_EMB_STORE_HOST``:``PADDLE_EMB_STORE_PORT``). A one-process job
    gets a plain host table, like ``the_one_ps.py`` switching between local
    and distributed tables."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if world <= 1:
        return HostEmbedding(num_embeddings, embedding_dim, **kw)
    store_addr = None
    if store is None:
        from ..distributed.coord import TCPStore

        host = os.environ.get("PADDLE_EMB_STORE_HOST", "127.0.0.1")
        port = int(os.environ.get("PADDLE_EMB_STORE_PORT", "23461"))
        store = TCPStore(host=host, port=port, is_master=(rank == 0))
        # the table opens extra transport connections only when it knows
        # the endpoint; a caller's store stays serial
        store_addr = (host, port)
    table = ShardedHostEmbeddingTable(
        num_embeddings, embedding_dim, store=store, rank=rank,
        world_size=world, optimizer=kw.pop("optimizer", "sgd"),
        init_std=kw.pop("init_std", 0.01), seed=kw.pop("seed", 0),
        path=kw.pop("path", None), name=kw.pop("name", None),
        store_addr=store_addr)
    return HostEmbedding(num_embeddings, embedding_dim, table=table, **kw)


# -- native kernel dispatch ---------------------------------------------------
def _native_ops():
    """The embed.cc kernel library while ``FLAGS_host_emb_native`` is set
    (built at first use; a failed build raises), else None."""
    if not _flags.flag("FLAGS_host_emb_native", True):
        return None
    from ..core import native

    return native.lib()


def _nthreads() -> int:
    n = int(_flags.flag("FLAGS_host_emb_threads", 16) or 0)
    return n if n > 0 else (os.cpu_count() or 1)


def _c_f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _unique(ids: np.ndarray):
    """np.unique(ids, return_inverse=True), natively unless the numpy path
    is selected."""
    ids = np.ascontiguousarray(ids, np.int64)
    L = _native_ops()
    if L is None or ids.size == 0:
        return np.unique(ids, return_inverse=True)
    uniq = np.empty(ids.size, np.int64)
    inv = np.empty(ids.size, np.int64)
    n = L.pte_unique(ids.ctypes.data, ids.size, uniq.ctypes.data,
                     inv.ctypes.data, _nthreads())
    if n < 0:
        raise IndexError("host embedding: negative id in lookup batch")
    return uniq[:n].copy(), inv


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (counter-based hashing RNG core)."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _merge_sparse_grads(ids_list, grads_list, dim: int):
    """Coalesce sparse grad pushes: concatenate and merge duplicate ids by
    summing their rows in input order (np.add.at, which the native kernel
    reproduces bit for bit). Returns (unique_ids, merged_grads)."""
    cat_ids = np.concatenate(ids_list) if ids_list \
        else np.empty((0,), np.int64)
    if cat_ids.size == 0:
        return cat_ids, np.empty((0, dim), np.float32)
    cat_grads = np.concatenate(grads_list, axis=0)
    L = _native_ops()
    if L is not None and cat_grads.dtype == np.float32:
        cat_ids = np.ascontiguousarray(cat_ids, np.int64)
        cat_grads = np.ascontiguousarray(cat_grads)
        uniq = np.empty(cat_ids.size, np.int64)
        merged = np.empty((cat_ids.size, dim), np.float32)
        n = L.pte_merge_f32(cat_ids.ctypes.data, cat_ids.size,
                            cat_grads.ctypes.data, dim, uniq.ctypes.data,
                            merged.ctypes.data, _nthreads())
        if n < 0:
            raise IndexError("host embedding: negative id in grad push")
        return uniq[:n].copy(), merged[:n].copy()
    uniq, inv = np.unique(cat_ids, return_inverse=True)
    if uniq.size == cat_ids.size:  # no duplicates: reorder only
        return uniq, cat_grads[np.argsort(cat_ids, kind="stable")]
    merged = np.zeros((uniq.size, dim), np.float32)
    np.add.at(merged, inv, cat_grads)
    return uniq, merged


def _hash_normal_rows(rows: np.ndarray, dim: int, seed: int,
                      std: float) -> np.ndarray:
    """N(0, std) values for the given row ids, deterministic per (row, col):
    splitmix64 counters -> two uniforms -> Box-Muller. A table carried from
    the reference depends on these bits."""
    idx = rows.astype(np.uint64)[:, None] * np.uint64(dim) \
        + np.arange(dim, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        h1 = _splitmix64(idx ^ np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
        h2 = _splitmix64(h1)
    # top 53 bits -> uniform in (0, 1]; u1 kept away from 0 for the log
    u1 = ((h1 >> np.uint64(11)).astype(np.float64) + 1.0) \
        / 9007199254740993.0
    u2 = (h2 >> np.uint64(11)).astype(np.float64) / 9007199254740992.0
    return (std * np.sqrt(-2.0 * np.log(u1))
            * np.cos(2.0 * np.pi * u2)).astype(np.float32)


# One cached probe a directory: does this filesystem report hole blocks
# honestly? Overlay mounts report st_blocks == file size from the moment
# of truncation, which makes st_blocks useless for "the lazy init keeps
# the table sparse"; the fallback counts initialized rows instead.
_fs_sparse_probe = {}


def _fs_reports_sparse_blocks(probe_dir: str) -> bool:
    probe_dir = probe_dir or "."
    if probe_dir in _fs_sparse_probe:
        return _fs_sparse_probe[probe_dir]
    import tempfile

    ok = False
    try:
        with tempfile.NamedTemporaryFile(dir=probe_dir) as f:
            f.truncate(4 * 1024 * 1024)
            # write ONE page through a mapping, like the table does: a
            # filesystem may report holes honestly at truncation yet
            # materialize them on the first write-through
            m = np.memmap(f.name, dtype=np.float32, mode="r+",
                          shape=(1024, 1024))
            m[0] = 1.0
            m.flush()
            del m
            ok = os.fstat(f.fileno()).st_blocks * 512 < 2 * 1024 * 1024
    except Exception:
        ok = False
    _fs_sparse_probe[probe_dir] = ok
    return ok


# -- host/device moves ----------------------------------------------------------
def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory and a copy that
    does not block the host, on the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_host_async(t: torch.Tensor):
    """Start ``t``'s copy to the host; :func:`_host` waits for it. On the
    card the copy lands in pinned memory behind an event, so the caller's
    thread does not wait for the device."""
    t = t.detach()
    if t.device.type != "cuda":
        return t, None
    h = t.to("cpu", non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return h, ev


def _host(pending) -> np.ndarray:
    t, ev = pending
    if ev is not None:
        ev.synchronize()
    return np.asarray(t.numpy(), np.float32)


# -- the select with an ordered backward --------------------------------------
def _dup_rounds(inv: np.ndarray):
    """The positions of ``inv`` grouped into rounds: round k holds every
    id's k-th occurrence (in input order), so a round's destinations are
    unique. Returns (positions, their ids, round bounds)."""
    n = inv.size
    order = np.argsort(inv, kind="stable")
    s = inv[order]
    first = np.ones(n, bool)
    first[1:] = s[1:] != s[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(n), 0))
    rank = np.arange(n) - start
    o2 = np.lexsort((order, rank))
    pos, r = order[o2], rank[o2]
    bounds = np.searchsorted(r, np.arange(int(r.max(initial=0)) + 2))
    return pos, inv[pos], bounds


class _SelectRows(torch.autograd.Function):
    """``rows[inverse]`` whose backward sums each row's gradient over its
    occurrences in input order (the reference's CPU scatter-add order), on
    any device: round k adds every id's k-th occurrence with unique
    destinations, so no two additions into a row race."""

    @staticmethod
    def forward(ctx, rows, inv_dev, rounds):
        ctx.nrows, ctx.rounds = rows.shape[0], rounds
        return rows.index_select(0, inv_dev.reshape(-1)).reshape(
            *inv_dev.shape, rows.shape[1])

    @staticmethod
    def backward(ctx, g):
        pos, dest, bounds = ctx.rounds
        g = g.reshape(-1, g.shape[-1])
        out = g.new_zeros((ctx.nrows, g.shape[1]))
        for b, e in zip(bounds[:-1], bounds[1:]):
            if e > b:
                out.index_add_(0, dest[b:e], g.index_select(0, pos[b:e]))
        return out, None, None


def _select(rows: torch.Tensor, inverse: np.ndarray) -> torch.Tensor:
    dev = rows.device
    pos, dest, bounds = _dup_rounds(inverse.reshape(-1))
    inv_dev = _to_device(inverse, dev)
    rounds = (_to_device(pos, dev), _to_device(dest, dev), bounds.tolist())
    return _SelectRows.apply(rows, inv_dev, rounds)


class HostEmbeddingTable:
    """Row store in host RAM or a memmap file (the file is sparse, so
    untouched rows occupy no physical pages)."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        dtype="float32",
        path: Optional[str] = None,
        init_std: float = 0.01,
        seed: int = 0,
        optimizer: str = "sgd",
        adagrad_eps: float = 1e-8,
    ):
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.dtype = np.dtype(dtype)
        self.init_std = float(init_std)
        self.seed = int(seed)
        self.optimizer = optimizer
        self.adagrad_eps = float(adagrad_eps)
        shape = (self.num_embeddings, self.embedding_dim)
        if path is not None:
            self.table = np.lib.format.open_memmap(
                path, mode="w+", dtype=self.dtype, shape=shape)
            self._accum = np.lib.format.open_memmap(
                path + ".accum", mode="w+", dtype=np.float32,
                shape=(self.num_embeddings,)) \
                if optimizer == "adagrad" else None
        else:
            self.table = np.zeros(shape, self.dtype)
            self._accum = np.zeros((self.num_embeddings,), np.float32) \
                if optimizer == "adagrad" else None
        # lazy per-row init: a row gets N(0, init_std) at its first touch
        # (deterministic per row), so a 20 GiB logical table costs nothing
        # until used, like the reference's sparse tables
        self._initialized = np.zeros(self.num_embeddings, bool)
        self._n_initialized = 0

    def _ensure_init(self, ids: np.ndarray):
        fresh = np.unique(ids[~self._initialized[ids]])
        if fresh.size == 0:
            return
        # one vectorized counter-based pass over the fresh block; the
        # values depend on the row only, not on touch order or sharding
        self.table[fresh] = _hash_normal_rows(
            fresh, self.embedding_dim, self.seed, self.init_std
        ).astype(self.dtype)
        self._initialized[fresh] = True
        self._n_initialized += int(fresh.size)

    def _native_table(self):
        """The kernel library when it can work on this table in place
        (float32, C-contiguous: RAM or memmap alike), else None."""
        if self.dtype != np.float32 or not self.table.flags.c_contiguous:
            return None
        return _native_ops()

    def gather(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64)
        self._ensure_init(ids)
        L = self._native_table()
        if L is None or ids.size == 0:
            return np.asarray(self.table[ids])
        out = np.empty((ids.size, self.embedding_dim), np.float32)
        rc = L.pte_gather_f32(self.table.ctypes.data, self.num_embeddings,
                              self.embedding_dim, ids.ctypes.data, ids.size,
                              out.ctypes.data, _nthreads())
        if rc != 0:
            raise IndexError("host embedding: id out of range in gather")
        return out

    def apply_update(self, ids: np.ndarray, grad: np.ndarray, lr: float):
        """SelectedRows-style sparse optimizer step on the touched rows
        (reference sparse_sgd_rule.cc: SGD / row-wise Adagrad). ``ids``
        must be unique (callers merge duplicates first)."""
        ids = np.ascontiguousarray(ids, np.int64)
        grad = _c_f32(grad)
        if ids.size == 0:
            return
        L = self._native_table()
        if L is not None:
            if self.optimizer == "adagrad":
                rc = L.pte_adagrad_f32(
                    self.table.ctypes.data, self._accum.ctypes.data,
                    self.num_embeddings, self.embedding_dim, ids.ctypes.data,
                    ids.size, grad.ctypes.data, ctypes.c_float(lr),
                    ctypes.c_float(self.adagrad_eps), _nthreads())
            else:
                rc = L.pte_sgd_f32(
                    self.table.ctypes.data, self.num_embeddings,
                    self.embedding_dim, ids.ctypes.data, ids.size,
                    grad.ctypes.data, ctypes.c_float(lr), _nthreads())
            if rc != 0:
                raise IndexError("host embedding: id out of range in update")
            return
        if self.optimizer == "adagrad":
            # a float64 cumsum forces a SEQUENTIAL per-row sum, the one
            # numpy reduction order the native kernel reproduces at any dim
            g2 = (grad.astype(np.float64) ** 2).cumsum(axis=1)[:, -1]
            g2 = (g2 / float(self.embedding_dim)).astype(np.float32)
            self._accum[ids] += g2
            scale = lr / (np.sqrt(self._accum[ids]) + self.adagrad_eps)
            self.table[ids] = (self.table[ids].astype(np.float32)
                               - scale[:, None] * grad).astype(self.dtype)
        else:  # sgd
            self.table[ids] = (self.table[ids].astype(np.float32)
                               - lr * grad).astype(self.dtype)

    def state_nbytes_physical(self) -> int:
        """Resident bytes of the backing file (0 blocks for untouched
        rows). Where ``st_blocks`` cannot see holes, the lazy-init count:
        initialized rows x row bytes + a header page."""
        if isinstance(self.table, np.memmap):
            if _fs_reports_sparse_blocks(os.path.dirname(self.table.filename)):
                return os.stat(self.table.filename).st_blocks * 512
            row = self.embedding_dim * self.dtype.itemsize
            return self._n_initialized * row + 4096
        return self.table.nbytes


# -- device hot-row cache -------------------------------------------------------
class HotRowCache:
    """Device-resident cache for the head of the id distribution.

    Admission is frequency-based: a 2-row count-min sketch counts how often
    each missed id appears across steps; ids seen at least ``min_count``
    times are admitted into free slots. Cached rows are read from the
    device buffer on pull and updated in place by the push; eviction and
    :meth:`flush` write rows (and Adagrad accumulators) back to the host
    table, so host and device together hold one authoritative copy of each
    row.

    The capacity is clamped to ``FLAGS_host_emb_cache_frac`` of
    ``fault.memory.budget_bytes()`` when that resolves, and a pressure
    handler (weakly owned) halves the cache; the shrink itself happens on
    the owner's thread at the next push.

    The buffers hold one extra row (index ``capacity``), never a real
    slot's, so a freshly shrunk buffer keeps the reference's layout.
    """

    def __init__(self, table: HostEmbeddingTable, capacity: int,
                 min_count: Optional[int] = None, device=None):
        from ..fault import memory as _mem

        self.table = table
        self.dim = table.embedding_dim
        self.device = resolve_device(device)
        self.min_count = int(
            min_count if min_count is not None
            else _flags.flag("FLAGS_host_emb_cache_min_count", 3))
        cap = int(capacity)
        bytes_per_row = self.dim * 4 + (4 if table.optimizer == "adagrad"
                                        else 0)
        budget = int(_mem.budget_bytes() or 0)
        if budget > 0:
            frac = float(_flags.flag("FLAGS_host_emb_cache_frac", 0.25))
            cap = max(1, min(cap, int(budget * frac / bytes_per_row)))
        _mem.register_pressure_handler(
            f"host_emb_cache:{id(self):x}", lambda o: o._request_shrink(),
            owner=self)
        self.capacity = cap
        self.budget_bytes = budget
        self._rows = torch.zeros((cap + 1, self.dim), dtype=torch.float32,
                                 device=self.device)
        self._accum = torch.zeros((cap + 1,), dtype=torch.float32,
                                  device=self.device) \
            if table.optimizer == "adagrad" else None
        # SGD runs the cache as a DENSE LEAF: the forward gathers from the
        # buffer itself, so the hot rows' gradients accumulate on it across
        # micro-batches (in the order the host merge sums them) and the push
        # is one device update. Adagrad keeps the scatter path (its
        # accumulator needs each micro-batch's gradient).
        self.dense = table.optimizer == "sgd"
        if self.dense:
            self._rows.requires_grad_(True)
        self._slot_ids = np.full(cap, -1, np.int64)
        self._slot_hits = np.zeros(cap, np.int64)
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._ids_sorted = np.empty(0, np.int64)
        self._slots_sorted = np.empty(0, np.int64)
        # count-min sketch for admission (two independent splitmix streams)
        self._cmw = 1 << max(10, (cap * 4).bit_length())
        self._cms = np.zeros((2, self._cmw), np.int64)
        self.hits = 0
        self.misses = 0
        self._shrink_req = False  # set from the pressure handler's thread

    @property
    def rows_t(self) -> Optional[torch.Tensor]:
        """The dense leaf the forward gathers from (SGD), else None."""
        return self._rows if self.dense else None

    def dense_update(self, grad: torch.Tensor, lr: float):
        """Apply the accumulated dense hot-row gradient on the device:
        ``rows - lr * g`` as two operations, the product rounded first as
        the host rule rounds it (a zero-gradient row is unchanged)."""
        with torch.no_grad():
            step = grad * float(np.float32(lr))
            self._rows.sub_(step)
        self._rows.grad = None

    # -- membership ----------------------------------------------------------
    def lookup(self, uniq: np.ndarray, count_stats: bool = True):
        """(hit_mask, slots_of_hits) for unique ids. ``count_stats=False``
        for the push's routing lookups: only the pull defines the hit rate
        and the heat. A pending shrink is not applied here: the owning layer
        applies it at the push and invalidates its staging."""
        if self._ids_sorted.size == 0:
            return np.zeros(uniq.shape, bool), np.empty(0, np.int64)
        pos = np.searchsorted(self._ids_sorted, uniq)
        pos_c = np.minimum(pos, self._ids_sorted.size - 1)
        hit = self._ids_sorted[pos_c] == uniq
        slots = self._slots_sorted[pos_c[hit]]
        if count_stats:
            self._slot_hits[slots] += 1
            self.hits += int(hit.sum())
            self.misses += int(uniq.size - hit.sum())
        return hit, slots

    def _cm_hashes(self, ids: np.ndarray):
        """The count-min sketch's two bucket streams (one definition, so
        sightings and admission read the same buckets)."""
        u = ids.astype(np.uint64)
        h0 = (_splitmix64(u) & np.uint64(self._cmw - 1)).astype(np.int64)
        h1 = (_splitmix64(u ^ np.uint64(0xD6E8FEB86659FD93))
              & np.uint64(self._cmw - 1)).astype(np.int64)
        return h0, h1

    def observe_misses(self, missed_uniq: np.ndarray):
        """Count-min update for missed ids (one sighting a step each)."""
        if missed_uniq.size == 0:
            return
        h0, h1 = self._cm_hashes(missed_uniq)
        self._cms[0] += np.bincount(h0, minlength=self._cmw)
        self._cms[1] += np.bincount(h1, minlength=self._cmw)

    def admission_candidates(self, missed_uniq: np.ndarray) -> np.ndarray:
        if missed_uniq.size == 0 or not self._free:
            return missed_uniq[:0]
        h0, h1 = self._cm_hashes(missed_uniq)
        est = np.minimum(self._cms[0][h0], self._cms[1][h1])
        cand = missed_uniq[est >= self.min_count]
        return cand[:len(self._free)]

    # -- admission / eviction ---------------------------------------------
    def admit(self, ids: np.ndarray, rows: np.ndarray,
              accum: Optional[np.ndarray] = None):
        """Install host rows (post-update values): one copy to the device,
        the last these rows make until eviction."""
        k = min(int(ids.size), len(self._free))
        if k == 0:
            return
        ids = ids[:k]
        slots = np.array([self._free.pop() for _ in range(k)], np.int64)
        self._slot_ids[slots] = ids
        self._slot_hits[slots] = 1
        sl = _to_device(slots, self.device)
        with torch.no_grad():
            self._rows.index_copy_(0, sl, _to_device(_c_f32(rows[:k]),
                                                     self.device))
            if self._accum is not None:
                a = _c_f32(accum[:k]) if accum is not None \
                    else np.zeros(k, np.float32)
                self._accum.index_copy_(0, sl, _to_device(a, self.device))
        self._rebuild_index()
        _prof.counter_inc("host_emb_cache_admitted", k)

    def _read(self, buf: torch.Tensor, slots: np.ndarray) -> np.ndarray:
        return buf.detach()[_to_device(slots, self.device)].cpu().numpy()

    def evict(self, slots: np.ndarray):
        """Write back and free the given slots."""
        slots = np.asarray(slots, np.int64)
        slots = slots[self._slot_ids[slots] >= 0]
        if slots.size == 0:
            return
        ids = self._slot_ids[slots]
        rows = self._read(self._rows, slots)
        self.table._ensure_init(ids)  # the row may predate its first touch
        self.table.table[ids] = rows.astype(self.table.dtype)
        if self._accum is not None:
            self.table._accum[ids] = self._read(self._accum, slots)
        self._slot_ids[slots] = -1
        self._slot_hits[slots] = 0
        self._free.extend(int(s) for s in slots)
        self._rebuild_index()
        _prof.counter_inc("host_emb_cache_evicted", int(slots.size))

    def flush(self):
        """Write every cached row back to the host table (the rows STAY
        cached and the device stays authoritative): a coherent host
        snapshot for checkpoint and evaluation readers."""
        occ = np.nonzero(self._slot_ids >= 0)[0]
        if occ.size == 0:
            return
        ids = self._slot_ids[occ]
        rows = self._read(self._rows, occ)
        self.table._ensure_init(ids)
        self.table.table[ids] = rows.astype(self.table.dtype)
        if self._accum is not None:
            self.table._accum[ids] = self._read(self._accum, occ)

    # -- sparse update ------------------------------------------------------
    def update(self, slots: np.ndarray, grad: np.ndarray, lr: float):
        """Device-side SelectedRows update of cached rows (the push's hot
        half). SGD is bit-identical to the host rule; Adagrad matches to
        reduction-order rounding (a device mean against a sequential host
        sum)."""
        sl = _to_device(np.asarray(slots, np.int64), self.device)
        g = _to_device(_c_f32(grad), self.device)
        lr32 = float(np.float32(lr))
        with torch.no_grad():
            if self._accum is not None:
                self._accum.index_add_(0, sl, (g * g).mean(1))
                a = self._accum.index_select(0, sl)
                scale = torch.full_like(a, lr32) / (
                    torch.sqrt(a) + float(np.float32(self.table.adagrad_eps)))
                self._rows.index_add_(0, sl, -(scale[:, None] * g))
            else:
                self._rows.index_add_(0, sl, -(g * lr32))

    def rows_device(self, slots: np.ndarray) -> torch.Tensor:
        """Device gather of cached rows (no host crossing)."""
        return self._rows.detach().index_select(
            0, _to_device(np.asarray(slots, np.int64), self.device))

    # -- pressure ----------------------------------------------------------
    def _request_shrink(self):
        # called on the pressure caller's thread: a cheap flag only, the
        # owner applies it at its next push
        self._shrink_req = True
        occ = int((self._slot_ids >= 0).sum())
        return {"requested": True, "occupied_rows": occ,
                "capacity_rows": self.capacity}

    def _apply_shrink(self):
        self._shrink_req = False
        new_cap = max(1, self.capacity // 2)
        occ = np.nonzero(self._slot_ids >= 0)[0]
        if occ.size > new_cap:
            # keep the hottest; write the cold half back
            order = np.argsort(self._slot_hits[occ], kind="stable")
            self.evict(occ[order[: occ.size - new_cap]])
            occ = np.nonzero(self._slot_ids >= 0)[0]
        keep_ids = self._slot_ids[occ]
        occ_d = _to_device(occ, self.device)
        with torch.no_grad():
            rows = torch.zeros((new_cap + 1, self.dim), dtype=torch.float32,
                               device=self.device)
            rows[: keep_ids.size] = self._rows.detach().index_select(0, occ_d)
            if self._accum is not None:
                acc = torch.zeros((new_cap + 1,), dtype=torch.float32,
                                  device=self.device)
                acc[: keep_ids.size] = self._accum.index_select(0, occ_d)
                self._accum = acc
        self._rows = rows.requires_grad_(self.dense)
        hits = self._slot_hits[occ]
        self.capacity = new_cap
        self._slot_ids = np.full(new_cap, -1, np.int64)
        self._slot_hits = np.zeros(new_cap, np.int64)
        self._slot_ids[: keep_ids.size] = keep_ids
        self._slot_hits[: keep_ids.size] = hits
        self._free = list(range(new_cap - 1, keep_ids.size - 1, -1))
        self._rebuild_index()
        _prof.counter_inc("host_emb_cache_shrinks")

    def _rebuild_index(self):
        occ = np.nonzero(self._slot_ids >= 0)[0]
        ids = self._slot_ids[occ]
        order = np.argsort(ids)
        self._ids_sorted = ids[order]
        self._slots_sorted = occ[order].astype(np.int64)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity_rows": self.capacity,
            "occupied_rows": int((self._slot_ids >= 0).sum()),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
        }


# -- pipelined PS worker ------------------------------------------------------
class _PSWorker:
    """One persistent daemon thread running the layer's host-side PS jobs
    (prefetch gathers, async pushes) in FIFO order. It holds only a weakref
    to the layer: dropping the layer fires a finalizer that wakes the queue
    with a sentinel, so the thread exits instead of pinning the table."""

    _SENTINEL = object()

    def __init__(self, owner):
        self._q: _queue.Queue = _queue.Queue()
        device = getattr(owner, "_device", None)
        self._thread = threading.Thread(
            target=_PSWorker._loop, args=(weakref.ref(owner), self._q,
                                          device),
            daemon=True, name="host-emb-ps")
        self._finalizer = weakref.finalize(owner, self._q.put,
                                           _PSWorker._SENTINEL)
        self._thread.start()

    def submit(self, kind: str, payload: dict):
        self._q.put((kind, payload))

    def join(self):
        self._q.join()

    @staticmethod
    def _loop(owner_ref, q, device):
        # the CUDA device is per thread
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        while True:
            job = q.get()
            try:
                if job is _PSWorker._SENTINEL:
                    return
                owner = owner_ref()
                if owner is None:
                    return
                kind, payload = job
                try:
                    if kind == "gather":
                        owner._job_gather(payload)
                    else:
                        owner._job_apply(payload)
                except Exception as e:  # surfaced at consume/sync
                    payload["err"] = e
                    ev = payload.get("done")
                    if ev is not None:
                        ev.set()
                    owner._async_err = e
                finally:
                    del owner
            finally:
                q.task_done()


class HostEmbedding(Layer):
    """Embedding layer over a HostEmbeddingTable.

    The gather crosses the host boundary in every forward, like the
    reference's PS pull; the dense model around it can run as it likes.
    Call ``apply_gradients(lr)`` after ``backward()`` (the PS push / the
    SelectedRows optimizer). The rows land on ``device`` (default
    ``get_device()``: the card unless the CPU was asked for).

    ``cache_rows`` (or ``FLAGS_host_emb_cache_rows``) arms the device
    hot-row cache; ``prefetch``/``prefetch_iter`` and
    ``FLAGS_host_emb_async_push`` pipeline the pull and the push through
    the PS worker thread. With everything at its default the layer is the
    plain synchronous host path: no thread, no cache.
    """

    def __init__(self, num_embeddings, embedding_dim, path=None,
                 optimizer="sgd", init_std=0.01, seed=0, sparse=True,
                 name=None, table=None, cache_rows=None, *, device=None):
        super().__init__()
        self._device = resolve_device(device)
        # table=ShardedHostEmbeddingTable(...) makes this layer the worker
        # side of a multi-process PS
        self.table = table or HostEmbeddingTable(
            num_embeddings, embedding_dim, path=path, optimizer=optimizer,
            init_std=init_std, seed=seed)
        self._pending = []  # (pack-order ids, rows leaf) awaiting the push
        # one lock serializes table reads (PS worker thread) against the
        # sparse updates: torn rows are silent corruption
        self._table_lock = threading.Lock()
        self._worker: Optional[_PSWorker] = None
        self._slots: List[dict] = []  # in-flight prefetch slots, FIFO
        self._async_err: Optional[BaseException] = None
        # ordering barrier for async pushes: a staged pack may be patched by
        # an in-flight push, so a pull consumes it only after the LAST
        # submitted push (and its patches) completed. _push_seq counts the
        # async submissions; a slot prefetched at the current seq needs no
        # barrier (the worker's FIFO already ran every earlier push).
        self._last_push_done: Optional[threading.Event] = None
        self._push_seq = 0
        if cache_rows is None:
            cache_rows = int(_flags.flag("FLAGS_host_emb_cache_rows", 0) or 0)
        self.cache: Optional[HotRowCache] = None
        if cache_rows > 0 and not isinstance(self.table,
                                             ShardedHostEmbeddingTable):
            self.cache = HotRowCache(self.table, cache_rows,
                                     device=self._device)

    # -- PS worker ----------------------------------------------------------
    def _ensure_worker(self) -> _PSWorker:
        if self._worker is None:
            self._worker = _PSWorker(self)
        return self._worker

    def _check_async_err(self):
        if self._async_err is not None:
            err, self._async_err = self._async_err, None
            raise RuntimeError("host embedding PS worker failed") from err

    def sync(self):
        """Drain the PS worker (pending prefetches and async pushes) and
        flush the hot-row cache to the host table. Call before reading the
        table (checkpoint, evaluation)."""
        if self._worker is not None:
            t0 = time.perf_counter_ns()
            self._worker.join()
            _prof.counter_inc("host_emb_block_ns",
                              time.perf_counter_ns() - t0)
        self._check_async_err()
        if self.cache is not None:
            with self._table_lock:
                self.cache.flush()

    # -- pipelined pull -----------------------------------------------------
    @staticmethod
    def _host_ids(b) -> np.ndarray:
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        return np.ascontiguousarray(np.asarray(b), np.int64)

    def prefetch(self, x):
        """Start the host pull for upcoming batches on the PS worker thread
        so it overlaps the current step: unique, cold-row gather and the
        copy to the device. ``x`` is one id batch or a LIST of them (a
        step's micro-batches, staged as ONE union pack in one job);
        ``forward`` consumes the staged sub-batches in order as ids match.

        No-op on a SHARDED table: its gather is a lockstep collective
        across ranks, which a background gather would desynchronize."""
        if isinstance(self.table, ShardedHostEmbeddingTable):
            return
        self._check_async_err()
        batches = x if isinstance(x, (list, tuple)) else [x]
        ids_list = [self._host_ids(b).ravel() for b in batches]
        # keyed on the raw id bytes: the trainer's cost of a prefetch (and
        # of consuming one) is a memcpy and a dict
        slot = {"keys": [i.tobytes() for i in ids_list],
                "ids_list": ids_list, "cursor": 0, "uniq": None,
                "stage": None, "invs": None, "inverse_u": None,
                "stale": False, "seq": self._push_seq,
                "done": threading.Event(), "err": None}
        self._slots.append(slot)
        # bound the queue: a caller whose forwards never match its
        # prefetches must not pile up staged packs; drop the oldest
        while len(self._slots) > 8:
            self._slots.pop(0)
            _prof.counter_inc("host_emb_prefetch_drops")
        self._ensure_worker().submit("gather", slot)

    def prefetch_iter(self, it, lookahead: int = 1):
        """Wrap an iterator of id batches, keeping ``lookahead`` batches'
        pulls in flight so every ``forward`` consumes a staged pack."""
        it = iter(it)
        ahead = []
        try:
            for _ in range(max(1, lookahead)):
                nxt = next(it, None)
                if nxt is None:
                    break
                self.prefetch(nxt)
                ahead.append(nxt)
            while ahead:
                cur = ahead.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    self.prefetch(nxt)
                    ahead.append(nxt)
                yield cur
        finally:
            ahead.clear()

    def _job_gather(self, slot):
        """(worker thread) unique the slot's ids, gather the rows and stage
        them on the device, with the final inverse precomputed. The slot's
        fields are set under the table lock, so a concurrent push's patch
        pass and this staging never interleave half-written."""
        cat = (np.concatenate(slot["ids_list"])
               if len(slot["ids_list"]) > 1 else slot["ids_list"][0])
        with _span("host_emb.prefetch", rows=int(cat.size),
                   batches=len(slot["ids_list"])):
            uniq, inverse = _unique(cat)
            with self._table_lock:
                stage = self._build_pack(uniq)
                slot["uniq"] = uniq
                slot["inverse_u"] = inverse  # uniq-space; patch reuses it
                slot["stage"] = stage
                slot["invs"] = self._split_invs(slot, stage, inverse)
        slot["done"].set()

    @staticmethod
    def _split_invs(slot, stage, inverse):
        """Per-sub-batch inverse vectors (pack-space) out of the union's."""
        inv = stage["perm"][inverse] if stage["perm"] is not None \
            else inverse
        out, off = [], 0
        for ids in slot["ids_list"]:
            out.append(inv[off:off + ids.size])
            off += ids.size
        return out

    def _build_pack(self, uniq: np.ndarray):
        """Stage the rows of unique ids; returns a STAGE dict that
        :meth:`_stage_to_rows` turns into tensors. The caller holds the
        table lock.

        Modes: ``dense`` (SGD cache): only the cold rows and the hot slots
        are staged, the hot gather is recorded at forward time against the
        cache's leaf buffer; ``packed`` (Adagrad cache): the combined pack
        is built here; ``plain`` (no cache) and ``dense_cold`` (an SGD
        cache that nothing hit)."""
        cache = self.cache
        dev = self._device
        if cache is not None:
            hit, slots = cache.lookup(uniq)
            nh = int(hit.sum())
        else:
            hit, slots, nh = None, None, 0
        if nh:
            cold_uniq = uniq[~hit]
            nc = int(cold_uniq.size)
            cache.observe_misses(cold_uniq)
            sl = _to_device(slots, dev)
            cold_dev = _to_device(self.table.gather(cold_uniq), dev) \
                if nc else None
            perm = np.empty(uniq.size, np.int64)
            perm[hit] = np.arange(nh)
            perm[~hit] = nh + np.arange(nc)
            _prof.counter_inc("host_emb_hot_hits", nh)
            _prof.counter_inc("host_emb_hot_misses", nc)
            if cache.dense:
                return {"mode": "dense", "hot_slots_dev": sl,
                        "cold_dev": cold_dev,
                        "cold_ids": cold_uniq if nc else None, "perm": perm}
            with torch.no_grad():
                hot = cache._rows.index_select(0, sl)
                pack = torch.cat([hot, cold_dev]) if nc else hot
            return {"mode": "packed", "pack": pack,
                    "order_ids": np.concatenate([uniq[hit], cold_uniq]),
                    "perm": perm}
        if cache is not None:
            cache.observe_misses(uniq)
            _prof.counter_inc("host_emb_hot_misses", int(uniq.size))
        pack = _to_device(self.table.gather(uniq), dev)
        mode = "dense_cold" if (cache is not None and cache.dense) \
            else "plain"
        return {"mode": mode, "pack": pack, "order_ids": uniq, "perm": None}

    def _stage_to_rows(self, stage):
        """(trainer) the differentiable rows tensor of a stage and its
        push-pending entry. A dense stage records the hot gather and the
        concatenation against the cache's leaf buffer, so hot gradients
        land on the buffer and cold ones on the stage's cold leaf."""
        mode = stage["mode"]
        if mode == "dense":
            # ONE cold leaf a stage, shared by every sub-batch that consumes
            # it: its gradients accumulate across micro-batches like the
            # buffer's, and the push moves one leaf's bytes
            buf = self.cache.rows_t
            hot = buf.index_select(0, stage["hot_slots_dev"])
            if stage["cold_dev"] is None:
                return hot, None
            pend = None
            if "cold_t" not in stage:
                stage["cold_t"] = stage["cold_dev"].requires_grad_(True)
                pend = (stage["cold_ids"], stage["cold_t"])
            return torch.cat([hot, stage["cold_t"]]), pend
        if mode == "dense_cold":
            # a leaf survives repeated backwards: share it
            if "rows_cached" in stage:
                return stage["rows_cached"], None
            rows = stage["pack"].requires_grad_(True)
            stage["rows_cached"] = rows
            return rows, (stage["order_ids"], rows)
        rows = stage["pack"].detach().requires_grad_(True)
        return rows, (stage["order_ids"], rows)

    def _consume_prefetch(self, key: bytes):
        """The slot whose NEXT unconsumed sub-batch matches ``key``, and the
        sub-batch's inverse. Slots staged before the match were skipped by
        the caller and are dropped, as are slots a mid-step push marked
        stale; slots ahead of the consumer stay queued. No match leaves
        the queue as it is and the pull runs synchronously."""
        if any(s["stale"] for s in self._slots):
            self._slots = [s for s in self._slots if not s["stale"]]
        for j, slot in enumerate(self._slots):
            if slot["keys"][slot["cursor"]] != key:
                continue
            if slot["seq"] != self._push_seq:
                # staged before a later push: wait for that push's patch
                # pass BEFORE unlisting the slot (the patch pass repairs
                # only slots it can still see)
                self._await_pushes()
                if slot["stale"]:
                    self._slots.remove(slot)
                    return None
            _prof.counter_inc("host_emb_prefetch_drops", j)
            del self._slots[:j]
            slot["done"].wait()
            if slot["err"] is not None:
                raise RuntimeError("host embedding prefetch failed") \
                    from slot["err"]
            inverse = slot["invs"][slot["cursor"]]
            slot["cursor"] += 1
            if slot["cursor"] >= len(slot["keys"]):
                self._slots.remove(slot)
            _prof.counter_inc("host_emb_prefetch_hits")
            return slot, inverse
        return None

    def _await_pushes(self):
        """Block until the last async push (and its staged-pack patches)
        landed: a pull observes every push submitted before it, exactly
        like the synchronous path."""
        ev = self._last_push_done
        if ev is not None and not ev.is_set():
            ev.wait()

    # -- forward ------------------------------------------------------------
    def forward(self, x):
        self._check_async_err()
        ids = self._host_ids(x)
        t0 = time.perf_counter_ns()
        hit = self._consume_prefetch(ids.ravel().tobytes()) \
            if self._slots else None
        if hit is not None:
            slot, inverse = hit
            stage = slot["stage"]
        else:
            self._await_pushes()
            uniq, inverse = _unique(ids.ravel())
            with self._table_lock:
                stage = self._build_pack(uniq)
            if stage["perm"] is not None:
                inverse = stage["perm"][inverse]
        _prof.counter_inc("host_emb_lookups", int(ids.size))
        _prof.counter_inc("host_emb_block_ns", time.perf_counter_ns() - t0)
        rows, pend = self._stage_to_rows(stage)
        if self.training and pend is not None:
            self._pending.append(pend)
        return _select(rows, inverse.reshape(ids.shape))

    # -- push ---------------------------------------------------------------
    def apply_gradients(self, lr: float):
        """Push: apply the accumulated sparse gradients to the host table.
        The pending micro-batches are COALESCED first (duplicate ids merge
        into one row update). Under ``FLAGS_host_emb_async_push`` the copy
        to the host, the merge and the scatter run on the PS worker;
        ordering against later pulls is the worker's FIFO, and staged packs
        the push overlaps are refreshed."""
        self._check_async_err()
        ids_list, grad_list = [], []
        for order_ids, rows in self._pending:
            if rows.grad is not None:
                ids_list.append(order_ids)
                # the copy starts here; the worker waits for it under async
                # push
                grad_list.append(_to_host_async(rows.grad))
        self._pending = []
        # the dense-leaf hot half (SGD cache): autograd already summed every
        # micro-batch's hot gradients onto the buffer; one device update
        cache = self.cache
        if cache is not None and cache.dense and cache.rows_t.grad is not None:
            t0 = time.perf_counter_ns()
            with self._table_lock:
                cache.dense_update(cache.rows_t.grad, lr)
            _prof.counter_inc("host_emb_block_ns",
                              time.perf_counter_ns() - t0)
        if cache is not None and cache._shrink_req:
            # an all-hot step never reaches _apply_local's check
            with self._table_lock:
                self._maybe_shrink_cache()
        sharded = isinstance(self.table, ShardedHostEmbeddingTable)
        if not ids_list and not sharded:
            return
        # a SHARDED push is a lockstep collective: a rank with nothing to
        # push still takes part (an empty payload), or its peers deadlock
        payload = {"ids_list": ids_list, "grad_list": grad_list, "lr": lr}
        if _flags.flag("FLAGS_host_emb_async_push", False) and not sharded:
            t0 = time.perf_counter_ns()
            payload["done"] = threading.Event()
            self._last_push_done = payload["done"]
            self._push_seq += 1
            self._ensure_worker().submit("apply", payload)
            _prof.counter_inc("host_emb_block_ns",
                              time.perf_counter_ns() - t0)
            return
        t0 = time.perf_counter_ns()
        self._job_apply(payload)
        _prof.counter_inc("host_emb_block_ns", time.perf_counter_ns() - t0)

    def _job_apply(self, payload):
        """Apply one coalesced push (the trainer's thread, or the PS worker
        under async push)."""
        try:
            ids_list = payload["ids_list"]
            grad_list = [_host(g) for g in payload["grad_list"]]
            lr = payload["lr"]
            dim = self.table.embedding_dim
            sharded = isinstance(self.table, ShardedHostEmbeddingTable)
            with _span("host_emb.push",
                       rows=int(sum(i.size for i in ids_list))):
                # Adagrad's accumulator counts updates: one update with the
                # summed gradient differs from one a micro-batch. A LOCAL
                # table keeps one a micro-batch (coalescing saves it no
                # round trip); the sharded table coalesces (one round) and
                # documents the summed-gradient semantics.
                if not sharded and getattr(self.table, "optimizer",
                                           "sgd") == "adagrad":
                    with self._table_lock:
                        for ids_i, grad_i in zip(ids_list, grad_list):
                            self._apply_local(ids_i, grad_i, lr)
                    self._patch_slots(np.concatenate(ids_list)
                                      if ids_list else None)
                    return
                uniq, merged = _merge_sparse_grads(ids_list, grad_list, dim)
                if uniq.size == 0 and not sharded:
                    return
                with self._table_lock:
                    if sharded:
                        self.table.apply_update(uniq, merged, lr)
                    else:
                        self._apply_local(uniq, merged, lr)
                self._patch_slots(uniq)
        finally:
            ev = payload.get("done")
            if ev is not None:
                ev.set()

    def _maybe_shrink_cache(self):
        """Apply a requested shrink at a PUSH boundary (the dense gradient
        is consumed) and mark the staged packs that hold the old slot
        numbering stale: their consumers pull synchronously. The caller
        holds the table lock."""
        cache = self.cache
        if cache is None or not cache._shrink_req:
            return
        cache._apply_shrink()
        for slot in list(self._slots):
            if slot["stage"] is not None:
                slot["stale"] = True

    def _apply_local(self, uniq: np.ndarray, merged: np.ndarray, lr: float):
        """Split one merged update between the device cache (hot rows,
        updated in place) and the host table (cold rows, native scatter),
        then admit newly frequent ids with their post-update values. The
        caller holds the table lock."""
        cache = self.cache
        if cache is None:
            self.table.apply_update(uniq, merged, lr)
            return
        self._maybe_shrink_cache()
        hit, slots = cache.lookup(uniq, count_stats=False)
        if hit.any():
            cache.update(slots, merged[hit], lr)
        cold = uniq[~hit]
        if cold.size:
            self.table.apply_update(cold, merged[~hit], lr)
            cand = cache.admission_candidates(cold)
            if cand.size:
                rows = self.table.gather(cand)
                acc = self.table._accum[cand] \
                    if self.table._accum is not None else None
                cache.admit(cand, rows, acc)

    def _patch_slots(self, updated_ids: Optional[np.ndarray]):
        """A push that lands while later batches' packs are staged must not
        leave them stale: refresh the pushed rows in every staged slot
        whose ids meet the update (frequent ids recur batch to batch, so
        this is the common case)."""
        if updated_ids is None or not self._slots:
            return
        upd = np.unique(updated_ids)
        for slot in list(self._slots):
            if slot["stage"] is None:
                continue  # gather still queued: the FIFO runs it after this
            if np.intersect1d(slot["uniq"], upd, assume_unique=True).size == 0:
                continue
            if slot["cursor"] > 0:
                # partly consumed: earlier sub-batches' tensors feed live
                # graphs, so the staging cannot change; its consumer drops
                # it and pulls synchronously
                slot["stale"] = True
                continue
            stage = slot["stage"]
            if stage["mode"] == "packed":
                # Adagrad pack: hot and cold rows interleave; rebuild
                with self._table_lock:
                    stage = self._build_pack(slot["uniq"])
                    slot["stage"] = stage
                    slot["invs"] = self._split_invs(slot, stage,
                                                    slot["inverse_u"])
                _prof.counter_inc("host_emb_prefetch_patched")
                continue
            staged_ids = stage["cold_ids"] if stage["mode"] == "dense" \
                else stage["order_ids"]
            if staged_ids is None:
                continue  # a hot-only stage: nothing host-backed to refresh
            isect = np.intersect1d(staged_ids, upd, assume_unique=True)
            if isect.size == 0:
                continue
            with self._table_lock:
                base = np.searchsorted(staged_ids, isect)
                rows = None
                if self.cache is not None and self.cache._ids_sorted.size:
                    # ids staged cold but cache members by now have their
                    # authoritative copy on the device: refresh those from
                    # the cache buffer and the rest from the host table
                    srt = self.cache._ids_sorted
                    p = np.minimum(np.searchsorted(srt, isect), srt.size - 1)
                    member = srt[p] == isect
                    if member.any():
                        rows = np.empty((isect.size,
                                         self.table.embedding_dim),
                                        np.float32)
                        rows[member] = self.cache._read(
                            self.cache._rows,
                            self.cache._slots_sorted[p[member]])
                        if (~member).any():
                            rows[~member] = self.table.gather(isect[~member])
                if rows is None:
                    rows = self.table.gather(isect)
                buf = stage["cold_dev"] if stage["mode"] == "dense" \
                    else stage["pack"]
                with torch.no_grad():
                    buf.index_copy_(0, _to_device(base, self._device),
                                    _to_device(rows, self._device))
            _prof.counter_inc("host_emb_prefetch_patched")

    def embedding_dim(self):
        return self.table.embedding_dim


# per-process construction counter: ranks build their tables in the same
# program order, so the index is a deterministic cross-rank identity
_instance_lock = threading.Lock()
_instance_count = 0  # guarded_by: _instance_lock


class ShardedHostEmbeddingTable:
    """Embedding table SHARDED BY ID across processes (id % world ==
    owner), with pull and push over a TCPStore: the distributed capability
    of the reference's brpc PS (``memory_sparse_table.cc`` shards by
    feature hash across servers). Every rank is worker and server: a
    gather is a collective exchange (all ranks request, serve their owned
    rows, read the replies), a push routes gradients to their owners,
    which merge duplicate ids and apply ONE sparse update: sync-PS
    semantics, deterministic whatever the sharding.

    Transport: each (src, dst) exchange is ONE coalesced payload split into
    ``FLAGS_host_emb_chunk_bytes`` store messages, moved by a pool of
    ``FLAGS_host_emb_transport_threads`` dedicated store connections.
    ``FLAGS_host_emb_push_fp16`` sends push gradients as float16 (half the
    bytes; lossy, opt-in). The lazy per-row init hashes the GLOBAL id, so
    a row's value does not depend on the shard that materializes it.
    """

    def __init__(self, num_embeddings, embedding_dim, store, rank,
                 world_size, dtype="float32", path=None, init_std=0.01,
                 seed=0, optimizer="sgd", adagrad_eps=1e-8, name=None,
                 store_addr=None):
        global _instance_count
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.store = store
        self.store_addr = store_addr
        # namespace every store key by table identity: two tables sharing
        # one store each count gens from 0
        with _instance_lock:
            idx = _instance_count
            _instance_count += 1
        self.name = name if name is not None else f"t{idx}"
        self._prefix = f"he/{self.name}"
        # the local shard holds global ids {rank, rank+world, ...}
        n_local = (self.num_embeddings - self.rank + self.world_size - 1) \
            // self.world_size
        self.local = HostEmbeddingTable(
            n_local, embedding_dim, dtype=dtype, path=path,
            init_std=init_std, seed=seed, optimizer=optimizer,
            adagrad_eps=adagrad_eps)
        # local row i is global id i*world+rank: init hashes the GLOBAL id
        self.local._ensure_init = self._ensure_init_local
        self._seed = int(seed)
        self._std = float(init_std)
        self._gen = 0
        self._pool = None  # the parallel transport, built lazily

    def _ensure_init_local(self, local_ids: np.ndarray):
        t = self.local
        fresh = np.unique(local_ids[~t._initialized[local_ids]])
        if fresh.size == 0:
            return
        global_ids = fresh * self.world_size + self.rank
        t.table[fresh] = _hash_normal_rows(
            global_ids, t.embedding_dim, self._seed, self._std
        ).astype(t.dtype)
        t._initialized[fresh] = True
        t._n_initialized += int(fresh.size)

    # -- store transport ---------------------------------------------------
    @property
    def CHUNK(self) -> int:
        return int(_flags.flag("FLAGS_host_emb_chunk_bytes", 4 * 1024 * 1024)
                   or 512 * 1024)

    def _transport(self):
        """(clients, executors) for the parallel chunk transport, or None
        for the serial path (no endpoint known, threads off, or the extra
        connections failed: counted in ``host_emb_transport_serial``). Each
        worker owns ONE dedicated connection: a store client is a single
        socket, and two requests interleaved on it would corrupt both."""
        nthreads = int(_flags.flag("FLAGS_host_emb_transport_threads", 4)
                       or 0)
        if self._pool is None and nthreads > 0 \
                and self.store_addr is not None:
            try:
                from concurrent.futures import ThreadPoolExecutor

                from ..distributed.coord import TCPStore

                host, port = self.store_addr
                clients = [TCPStore(host=host, port=port, is_master=False)
                           for _ in range(nthreads)]
                execs = [ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix=f"he-tx{i}")
                         for i in range(nthreads)]
                self._pool = (clients, execs)
            except Exception:
                self._pool = False  # the endpoint is unusable: stay serial
        if self._pool is False:
            _prof.counter_inc("host_emb_transport_serial")
        return self._pool or None

    def _put(self, key: str, payload: bytes):
        chunk = self.CHUNK
        n = (len(payload) + chunk - 1) // chunk or 1
        pool = self._transport() if n > 1 else None
        if pool is None:
            for i in range(n):
                self.store.set(f"{key}/{i}",
                               payload[i * chunk:(i + 1) * chunk])
        else:
            clients, execs = pool
            futs = [execs[i % len(execs)].submit(
                        clients[i % len(clients)].set, f"{key}/{i}",
                        payload[i * chunk:(i + 1) * chunk])
                    for i in range(n)]
            for f in futs:
                f.result()
        self.store.set(key + "/n", str(n))

    def _take(self, key: str) -> bytes:
        n = int(self.store.wait(key + "/n"))
        pool = self._transport() if n > 1 else None
        if pool is None:
            parts = [self.store.wait(f"{key}/{i}") for i in range(n)]
            for i in range(n):
                self.store.delete_key(f"{key}/{i}")
        else:
            clients, execs = pool

            def fetch(i):
                c = clients[i % len(clients)]
                part = c.wait(f"{key}/{i}")
                c.delete_key(f"{key}/{i}")
                return part

            futs = [execs[i % len(execs)].submit(fetch, i) for i in range(n)]
            parts = [f.result() for f in futs]
        self.store.delete_key(key + "/n")
        return b"".join(parts)

    # push payloads coalesce ids and grads into one message:
    #   u64 n_ids | u8 fp16 | ids (n*8 B) | grads (n*dim*4 B or *2 B)
    def _pack_push(self, ids: np.ndarray, grad: np.ndarray) -> bytes:
        fp16 = bool(_flags.flag("FLAGS_host_emb_push_fp16", False))
        g = np.ascontiguousarray(grad, np.float16 if fp16 else np.float32)
        return (struct.pack("<QB", ids.size, int(fp16))
                + np.ascontiguousarray(ids, np.int64).tobytes()
                + g.tobytes())

    def _unpack_push(self, payload: bytes):
        n, fp16 = struct.unpack_from("<QB", payload)
        off = 9
        ids = np.frombuffer(payload, np.int64, count=n, offset=off)
        off += n * 8
        dt = np.float16 if fp16 else np.float32
        grad = np.frombuffer(payload, dt, offset=off).reshape(
            -1, self.embedding_dim)
        return ids, np.ascontiguousarray(grad, np.float32)

    # -- collective pull ---------------------------------------------------
    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Pull the rows of (globally) unique ids; COLLECTIVE: every rank
        calls it the same number of times (data-parallel lockstep, like the
        reference's synchronous PS pull)."""
        ids = np.asarray(ids, np.int64)
        gen = self._gen
        self._gen += 1
        owner = ids % self.world_size
        out = np.empty((ids.size, self.embedding_dim), np.float32)
        with _span("host_emb.shard_pull", rows=int(ids.size)):
            # 1. send the requests (own ids resolve locally)
            for o in range(self.world_size):
                if o == self.rank:
                    continue
                want = ids[owner == o]
                self._put(f"{self._prefix}/{gen}/req/{self.rank}/{o}",
                          want.tobytes())
            mine = ids[owner == self.rank]
            if mine.size:
                out[owner == self.rank] = self.local.gather(
                    mine // self.world_size)
            # 2. serve every other rank's request from the local shard
            for r in range(self.world_size):
                if r == self.rank:
                    continue
                req = np.frombuffer(self._take(
                    f"{self._prefix}/{gen}/req/{r}/{self.rank}"), np.int64)
                rows = self.local.gather(req // self.world_size) \
                    if req.size else np.empty((0, self.embedding_dim),
                                              np.float32)
                self._put(f"{self._prefix}/{gen}/rep/{self.rank}/{r}",
                          _c_f32(rows).tobytes())
            # 3. read the replies
            for o in range(self.world_size):
                if o == self.rank:
                    continue
                rows = np.frombuffer(self._take(
                    f"{self._prefix}/{gen}/rep/{o}/{self.rank}"), np.float32)
                out[owner == o] = rows.reshape(-1, self.embedding_dim)
        return out

    # -- collective push ---------------------------------------------------
    def apply_update(self, ids: np.ndarray, grad: np.ndarray, lr: float):
        """Push sparse gradients to their owners; the owners merge
        duplicates across ranks (a sum, like gradient accumulation) and
        apply ONE update."""
        ids = np.asarray(ids, np.int64)
        grad = np.asarray(grad, np.float32)
        gen = self._gen
        self._gen += 1
        owner = ids % self.world_size
        with _span("host_emb.shard_push", rows=int(ids.size)):
            for o in range(self.world_size):
                if o == self.rank:
                    continue
                sel = owner == o
                payload = self._pack_push(ids[sel], grad[sel])
                # PUSH bytes only: the pull's traffic is not counted
                _prof.counter_inc("host_emb_push_bytes", len(payload))
                self._put(f"{self._prefix}/{gen}/push/{self.rank}/{o}",
                          payload)
            all_ids = [ids[owner == self.rank]]
            all_grads = [grad[owner == self.rank]]
            for r in range(self.world_size):
                if r == self.rank:
                    continue
                gi, gg = self._unpack_push(self._take(
                    f"{self._prefix}/{gen}/push/{r}/{self.rank}"))
                all_ids.append(gi)
                all_grads.append(gg)
            uniq, merged = _merge_sparse_grads(all_ids, all_grads,
                                               self.embedding_dim)
            if uniq.size == 0:
                return
            self.local.apply_update(uniq // self.world_size, merged, lr)

    def close(self):
        if self._pool:
            clients, execs = self._pool
            for e in execs:
                e.shutdown(wait=False)
            for c in clients:
                try:
                    c.close()
                except Exception:
                    pass
            self._pool = None
