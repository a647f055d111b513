"""paddle.io: datasets, samplers, ``DataLoader`` and ``DevicePrefetcher``
(port of ``paddle_tpu/io/__init__.py``).

Batches are assembled on the host: worker threads feed the native host
runtime's bounded C++ blocking queue (``core/csrc/queue.cc``) as pickled
numpy trees; forked worker processes, which return numpy only (a forked
child must never touch the parent's CUDA context), feed a
``multiprocessing`` queue. Host tensors move to the device on the
consumer: to the loader's place as each batch is handed out, or, through
``DevicePrefetcher``, with asynchronous copies from pinned memory on a
stream of their own that overlap the training step.

A loader built with ``seed`` shuffles as a pure function of ``(seed,
epoch)`` with the reference's generator, so it yields the reference's batch
order bit for bit, and ``state_dict``/``load_state_dict`` resume it
sample-exactly.
"""
from __future__ import annotations

import functools
import itertools
import math
import queue as _queue
import threading
import weakref

import numpy as np
import torch

from ..core import place as place_mod


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")


class TensorDataset(Dataset):
    """Rows of equally long tensors or numpy arrays."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = datasets

    def __iter__(self):
        return itertools.chain(*self.datasets)


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds == 0 else int(self.cum[ds - 1])
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of a ``np.random.permutation`` (numpy's global generator, as
    the reference's)."""
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset: offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """numpy's global generator, as the reference's."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class _SeededRandomSampler(Sampler):
    """A shuffle that is a pure function of ``(seed, epoch)``, so a resumed
    run replays the interrupted one's batch order bit for bit."""

    def __init__(self, data_source, seed: int, epoch_fn):
        super().__init__(data_source)
        self.seed = int(seed)
        self._epoch_fn = epoch_fn  # () -> current epoch (owned by the loader)

    def __iter__(self):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch_fn()]))
        return iter(rng.permutation(len(self.data_source)).tolist())


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across data-parallel ranks. Without an
    explicit ``num_replicas``/``rank`` it takes the port's world
    (``distributed.get_world_size``: the world ``init_parallel_env`` joined, else 1)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size

        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = (num_replicas if num_replicas is not None
                       else get_world_size())
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate([indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


def default_collate_fn(batch):
    """Stacks samples into host tensors (tensors stay on their device):
    ints as int64, floats as float32, recursing into tuples, lists and
    dicts."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(list(batch))
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _tree_to_tensor(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_tensor(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_to_tensor(v) for k, v in obj.items()}
    return obj


def _tree_to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        moved = [_tree_to_device(o, device) for o in obj]
        if hasattr(obj, "_fields"):
            return type(obj)(*moved)
        return type(obj)(moved)
    if isinstance(obj, dict):
        return {k: _tree_to_device(v, device) for k, v in obj.items()}
    return obj


def _tree_to_numpy(obj):
    """Host tensors as numpy (the native queue's wire form); a tensor numpy
    cannot hold (bf16, on the card) crosses as itself, pickled by torch."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cpu" or obj.dtype == torch.bfloat16:
            return obj
        return obj.detach().numpy()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_numpy(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _tree_to_numpy(v) for k, v in obj.items()}
    return obj


def _numpy_collate(batch):
    """Worker-side collate, numpy end to end: a forked worker must never
    touch torch's CUDA state ("Cannot re-initialize CUDA in forked
    subprocess"), so tensors are made on the consumer."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        raise TypeError(
            "Dataset.__getitem__ returned a torch Tensor but num_workers>0 "
            "uses forked worker processes, which must not touch the device "
            "runtime. Return numpy arrays (or python scalars) from "
            "__getitem__, or pass use_shared_memory=False for thread workers.")
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [_numpy_collate(list(s)) for s in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _numpy_collate([b[k] for b in batch]) for k in sample}
    return batch


def _mp_worker_loop(dataset, collate_fn, index_q, data_q):
    """Forked worker process: indices in, pickled numpy batches out."""
    import traceback

    while True:
        item = index_q.get()
        if item is None:
            return
        i, indices = item
        try:
            batch = collate_fn([dataset[j] for j in indices])
            data_q.put((i, "ok", batch))
        except Exception:
            data_q.put((i, "err", traceback.format_exc()))


class _MultiprocessIter:
    """``num_workers`` forked processes → ``multiprocessing`` queue →
    ordered reassembly → host tensors on the consumer (out-of-order
    completions wait for their turn)."""

    def __init__(self, loader):
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        self.loader = loader
        collate = loader.collate_fn or _numpy_collate
        self.index_q = ctx.Queue()
        self.data_q = ctx.Queue()
        self.n_batches = 0
        index_iter, _ = loader._index_iter()
        for i, indices in enumerate(index_iter):
            self.index_q.put((i, list(indices)))
            self.n_batches = i + 1
        for _ in range(loader.num_workers):
            self.index_q.put(None)
        self.workers = [
            ctx.Process(target=_mp_worker_loop,
                        args=(loader.dataset, collate, self.index_q,
                              self.data_q), daemon=True)
            for _ in range(loader.num_workers)
        ]
        for w in self.workers:
            w.start()
        self._next = 0
        self._hold = {}

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= self.n_batches:
            self._shutdown()
            raise StopIteration
        while self._next not in self._hold:
            try:
                i, kind, payload = self.data_q.get(timeout=5.0)
            except _queue.Empty:
                # a crashed worker never posts its batch
                if not any(w.is_alive() for w in self.workers):
                    self._shutdown()
                    raise RuntimeError(
                        "DataLoader workers exited unexpectedly before "
                        f"producing batch {self._next}/{self.n_batches}")
                continue
            self._hold[i] = (kind, payload)
        kind, payload = self._hold.pop(self._next)
        self._next += 1
        if kind == "err":
            self._shutdown()
            raise RuntimeError(f"DataLoader worker failed:\n{payload}")
        batch = _tree_to_tensor(payload)
        if self.loader.return_list and isinstance(batch, (list, tuple)):
            return list(batch)
        return batch

    def _shutdown(self):
        for w in self.workers:
            if w.is_alive():
                w.terminate()
        for w in self.workers:
            w.join(timeout=1.0)
        self.workers = []

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass


def _fetch_batch(dataset, collate_fn, indices):
    if isinstance(dataset, IterableDataset):
        raise RuntimeError("use _IterableIter")
    return collate_fn([dataset[i] for i in indices])


def _thread_worker_loop(index_queue, native_q, fetch):
    """One worker thread: fetch the batches named on ``index_queue`` and push
    each as a pickled ``(kind, index, numpy tree)``. It holds the queues
    and ``fetch`` only, never the iterator, so an iterator abandoned part
    way through an epoch is still collected and its ``close()`` runs."""
    import pickle

    while True:
        try:
            i, indices = index_queue.get_nowait()
        except _queue.Empty:
            return
        try:
            payload = pickle.dumps(("ok", i, _tree_to_numpy(fetch(indices))),
                                   protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:  # raised again at the consumer
            try:
                payload = pickle.dumps(("err", i, e))
            except Exception:
                payload = pickle.dumps(("err", i, RuntimeError(
                    f"DataLoader worker failed: {e!r}")))
        if not native_q.push(payload):
            return  # closed: the consumer went away


class _DataLoaderIter:
    """The synchronous loader (``num_workers=0``), or worker threads → the
    native runtime's bounded ``NativeQueue`` of ``max(2, prefetch_factor)``
    batches: each worker pushes its batch as a pickled numpy tree (the copy
    into C++ runs without the GIL), and the consumer unpickles it and makes
    the tensors, handing batches out in index order (a batch that arrives
    early waits for its turn). ``close()`` (also from ``__del__``) stops
    the workers: a worker blocked on the full queue sees the close and
    exits."""

    def __init__(self, loader):
        self.loader = loader
        self.batch_sampler_iter, _ = loader._index_iter()
        self.num_workers = loader.num_workers
        self.collate_fn = loader.collate_fn or default_collate_fn
        self.native_q = None
        if self.num_workers > 0:
            from ..core.native import NativeQueue

            self.native_q = NativeQueue(max(2, loader.prefetch_factor))
            self._hold = {}
            self.index_queue: _queue.Queue = _queue.Queue()
            self.n_pending = 0
            for i, indices in enumerate(self.batch_sampler_iter):
                self.index_queue.put((i, indices))
                self.n_pending += 1
            fetch = functools.partial(_fetch_batch, loader.dataset,
                                      self.collate_fn)
            self.workers = []
            for _ in range(self.num_workers):
                t = threading.Thread(
                    target=_thread_worker_loop,
                    args=(self.index_queue, self.native_q, fetch),
                    daemon=True, name="dataloader-worker")
                t.start()
                self.workers.append(t)
            self.n_received = 0

    def _fetch(self, indices):
        return _fetch_batch(self.loader.dataset, self.collate_fn, indices)

    def _native_next(self):
        import pickle

        want = self.n_received
        while want not in self._hold:
            raw = self.native_q.pop()
            if raw is None:
                raise RuntimeError("DataLoader: the batch queue closed with "
                                   f"batch {want} of {self.n_pending} due")
            kind, i, payload = pickle.loads(raw)
            self._hold[i] = (kind, payload)
        kind, payload = self._hold.pop(want)
        self.n_received += 1
        if kind == "err":
            self.close()  # as the forked workers' path does
            raise payload
        return _tree_to_tensor(payload)

    def __iter__(self):
        return self

    def __next__(self):
        if self.num_workers == 0:
            indices = next(self.batch_sampler_iter)
            batch = self._fetch(indices)
        else:
            if self.n_received >= self.n_pending:
                self.close()
                raise StopIteration
            batch = self._native_next()
        if self.loader.return_list and isinstance(batch, (list, tuple)):
            return list(batch)
        return batch

    def close(self):
        """Stop the worker threads (idempotent): the batches not yet
        fetched are dropped from the index queue, and the native queue is
        closed, which wakes a worker blocked on a push."""
        if self.native_q is None:
            return
        try:
            while True:
                self.index_queue.get_nowait()
        except _queue.Empty:
            pass
        self.native_q.close()
        for t in self.workers:
            if t is not threading.current_thread():
                t.join(timeout=2.0)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def skip_next(self):
        """Advance one batch without loading its samples on the synchronous
        path (the quarantine skip stays at the index level); a worker path
        has already fetched it, so it is fetched and dropped. Raises
        StopIteration at the epoch's end like ``__next__``."""
        if self.num_workers == 0:
            next(self.batch_sampler_iter)
            return
        next(self)


class _IterableIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)
        self.collate_fn = loader.collate_fn or default_collate_fn
        self.batch_size = loader.batch_size
        # an IterableDataset has no index space: the resume fast-forward
        # consumes the skipped samples
        skip, loader._resume_skip = loader._resume_skip, 0
        if skip and self.batch_size:
            next(itertools.islice(self.it, skip * self.batch_size - 1,
                                  skip * self.batch_size), None)
        loader._batch_idx = skip

    def __iter__(self):
        return self

    def __next__(self):
        if self.batch_size is None:
            return next(self.it)
        batch = list(itertools.islice(self.it, self.batch_size))
        if not batch:
            raise StopIteration
        if self.loader.drop_last and len(batch) < self.batch_size:
            raise StopIteration
        return self.collate_fn(batch)


class DevicePrefetcher:
    """Device-side input double-buffering (reference
    ``operators/reader/buffered_reader.cc``'s async device prefetch).

    A daemon thread pulls batches from ``it``, pins each host tensor (numpy
    leaves become tensors first), copies it to ``device`` with
    ``non_blocking=True`` on a dedicated ``torch.cuda.Stream`` and records
    an event after the batch; up to ``buffer_size`` batches stay staged, so
    batch k+1's copy overlaps step k. The consumer's ``next()`` makes its
    current stream wait on that event and calls ``record_stream`` on each
    tensor, so the caching allocator keeps a batch's memory until the step
    that reads it is done. On the CPU the copies are no-ops.

    ``device`` defaults to ``get_device()`` (the card unless the CPU was
    asked for). ``sharding`` lays batches out over a mesh: a layout
    (``distributed.sharding_api.NamedSharding``, or a ``PartitionSpec``
    over the global mesh) for every leaf, or a callable ``(leaf_index,
    tensor) -> layout`` (``HybridParallelEngine.prefetch`` passes its
    ``batch_layout``); each leaf is cut to this rank's slice **before** its
    host-to-device copy, and the copy carries the layout (``placement``,
    ``mesh``, ``logical_shape``), so the engine does not cut it again.

    Order is kept; a worker exception is raised again at the consumer's
    ``next()``; ``close()`` (also on exhaustion and from ``__del__``) stops
    the thread without draining the source. ``state_dict`` is the loader
    position of the batches handed out, never the read-ahead.
    """

    _DONE = object()

    def __init__(self, it, buffer_size=2, sharding=None, device=None):
        from ..distributed.sharding_api import NamedSharding, PartitionSpec

        if sharding is not None and not callable(sharding) \
                and not isinstance(sharding, (NamedSharding, PartitionSpec)):
            raise TypeError(
                "DevicePrefetcher(sharding=...): a NamedSharding, a "
                "PartitionSpec or a callable (leaf_index, tensor) -> layout, "
                f"got {type(sharding).__name__}")
        self._sharding = sharding
        self._device = place_mod.resolve_device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._source = it
        self._it = iter(it)
        self._host_source()
        # batches handed to the trainer (not the read-ahead): the resume
        # anchor, read and written on the consumer thread only
        self._consumed = [0]
        self._q: _queue.Queue = _queue.Queue(maxsize=max(1, int(buffer_size)))
        self._stop = threading.Event()
        self._start()

    def _host_source(self):
        """A loader's iterator under this prefetcher hands out host tensors:
        the copies are this prefetcher's."""
        ei = self._epoch_iter()
        if ei is not None:
            ei.host = True

    def _start(self):
        # the worker holds a weakref, never self: an abandoned prefetcher
        # must stay collectable so __del__ -> close() can stop the thread
        self._thread = threading.Thread(
            target=DevicePrefetcher._loop,
            args=(weakref.ref(self), self._it, self._q, self._stop,
                  self._device),
            daemon=True, name="device-prefetch")
        self._thread.start()

    # -- producer ----------------------------------------------------------
    def _layout(self, i, t):
        from ..distributed.sharding_api import NamedSharding, PartitionSpec

        lay = self._sharding(i, t) if callable(self._sharding) \
            else self._sharding
        if isinstance(lay, PartitionSpec):
            from ..distributed.mesh import global_mesh

            lay = NamedSharding(global_mesh(), lay)
        return lay

    def _transfer(self, obj, moved, i=None):
        """Every tensor leaf copied to the device (``moved`` collects the
        copies), cut to this rank's slice first under a layout; numpy
        leaves become tensors first. ``i`` is the leaf's top-level position
        (nested leaves take their container's)."""
        if isinstance(obj, np.ndarray):
            obj = torch.from_numpy(obj)
        if isinstance(obj, torch.Tensor):
            lay = self._layout(i, obj) if self._sharding is not None else None
            if lay is not None:
                cut = lay.shard(obj)
                tag = (cut.placement, lay.mesh, cut.logical_shape)
                obj = cut.contiguous()
            if self._stream is None:
                out = obj.to(self._device)
            else:
                if obj.device.type == "cpu" and not obj.is_pinned():
                    obj = obj.pin_memory()
                out = obj.to(self._device, non_blocking=True)
                moved.append(out)
            if lay is not None:
                from ..distributed.sharding_api import _tag

                if out is obj:  # already there: tag a view, not the source
                    out = out.view(out.shape)
                _tag(out, *tag)
            return out
        if isinstance(obj, (list, tuple)):
            staged = [self._transfer(o, moved, idx if i is None else i)
                      for idx, o in enumerate(obj)]
            if hasattr(obj, "_fields"):  # namedtuples need star-args
                return type(obj)(*staged)
            return type(obj)(staged)
        if isinstance(obj, dict):
            return {k: self._transfer(v, moved, i) for k, v in obj.items()}
        return obj

    def _stage(self, batch):
        moved = []
        if self._stream is None:
            return self._transfer(batch, moved), None, moved
        with torch.cuda.stream(self._stream):
            staged = self._transfer(batch, moved)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event, moved

    @staticmethod
    def _loop(wref, it, q, stop, device):
        from .. import profiler

        if device.type == "cuda":
            torch.cuda.set_device(device)  # the current device is per thread
        while not stop.is_set():
            try:
                batch = next(it)
            except StopIteration:
                q.put((DevicePrefetcher._DONE, None))
                return
            except Exception as e:
                q.put(("err", e))
                return
            owner = wref()
            if owner is None:
                return
            try:
                staged = owner._stage(batch)
                profiler.counter_inc("io_device_prefetched")
            except Exception as e:
                q.put(("err", e))
                return
            finally:
                del owner  # do not pin the prefetcher while blocked below
            while not stop.is_set():
                try:
                    q.put(("ok", staged), timeout=0.1)
                    break
                except _queue.Full:
                    if wref() is None:
                        return

    # -- consumer ----------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        kind, payload = self._q.get()
        if kind is self._DONE:
            self.close()
            raise StopIteration
        if kind == "err":
            self.close()
            raise payload
        staged, event, moved = payload
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in moved:
                t.record_stream(stream)
        self._consumed[0] += 1
        return staged

    # -- sample-exact resume ------------------------------------------------
    def _epoch_iter(self):
        """The loader's position-tracking iterator under this prefetcher,
        if the source is (or yields) one."""
        for cand in (self._it, self._source):
            if isinstance(cand, _StatefulIter):
                return cand
        return None

    def state_dict(self) -> dict:
        """The loader position as of the last batch handed out (the
        loader's own counter runs ahead by the read-ahead)."""
        ei = self._epoch_iter()
        if ei is None:
            raise TypeError(
                "DevicePrefetcher.state_dict: source iterator does not track "
                "loader position (wrap a DataLoader, not a bare iterable)")
        return ei.state_at(self._consumed[0])

    def load_state_dict(self, sd: dict) -> None:
        """Restore the source loader's position and prefetch again from it
        (the staged read-ahead belongs to the old position and is
        dropped)."""
        loader = getattr(self._epoch_iter() or self._source, "loader", None)
        if loader is None or not callable(getattr(loader, "load_state_dict",
                                                  None)):
            raise TypeError("DevicePrefetcher.load_state_dict: no underlying "
                            "DataLoader to restore into")
        self.close()
        loader.load_state_dict(sd)
        self._consumed = [0]
        # the position-tracking iterator itself: iter(loader) on a loader
        # with device_prefetch > 0 would start a nested prefetcher
        make = getattr(loader, "_stateful_iter", None)
        self._it = make() if callable(make) else iter(loader)
        if isinstance(self._it, DevicePrefetcher):
            inner = self._it
            self._it = inner._it
            inner.close()
        self._source = self._it
        self._host_source()
        self._q = _queue.Queue(maxsize=self._q.maxsize)
        self._stop = threading.Event()
        self._start()

    set_state_dict = load_state_dict

    def close(self):
        """Stop the prefetch thread, and the worker threads of the loader's
        epoch iterator under it (idempotent). Staged batches are dropped;
        the source is not drained."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()  # unblock a producer stuck on put()
        except _queue.Empty:
            pass
        t = getattr(self, "_thread", None)
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=2.0)
        # the loader's epoch iterator under this prefetcher hands its host
        # batches to no one else: stop its worker threads too
        ei = self._epoch_iter()
        if ei is not None:
            ei.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def device_prefetch(it, buffer_size=2, sharding=None, device=None):
    """Functional form: ``for batch in device_prefetch(loader): ...``"""
    return DevicePrefetcher(it, buffer_size=buffer_size, sharding=sharding,
                            device=device)


class _StatefulIter:
    """The epoch iterator that keeps the loader's ``(epoch, batch_idx)``
    current as batches are handed out (the bookkeeping behind
    ``DataLoader.state_dict``); exhaustion rolls the loader to the next
    epoch at batch 0. Batches go to ``device`` unless ``host`` is set (a
    ``DevicePrefetcher`` above it does the copies)."""

    def __init__(self, loader, inner, start_batch_idx, device):
        self.loader = loader
        self.inner = inner
        self.device = device
        self.host = False
        self._start_epoch = loader._epoch
        self._start_idx = int(start_batch_idx)
        self._produced = 0

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.inner)
        except StopIteration:
            self.loader._epoch += 1
            self.loader._batch_idx = 0
            raise
        self._produced += 1
        self.loader._batch_idx = self._start_idx + self._produced
        return batch if self.host else _tree_to_device(batch, self.device)

    def close(self):
        """Stop the inner iterator's workers, where it has any."""
        close = getattr(self.inner, "close", None)
        if close is not None:
            close()

    def skip_batch(self) -> bool:
        """Advance past the next batch without training on it (the
        quarantine skip), at the index level when the inner iterator can;
        the position advances as for a consumed batch. False when the epoch
        was already exhausted."""
        skip = getattr(self.inner, "skip_next", None)
        try:
            if skip is not None:
                skip()
            else:
                next(self.inner)
        except StopIteration:
            self.loader._epoch += 1
            self.loader._batch_idx = 0
            return False
        self._produced += 1
        self.loader._batch_idx = self._start_idx + self._produced
        from .. import profiler

        profiler.counter_inc("io_quarantine_skips")
        return True

    def state_at(self, consumed: int) -> dict:
        """The loader position after ``consumed`` batches of this epoch
        iterator were handed out."""
        seed = self.loader.seed
        return {"epoch": self._start_epoch,
                "batch_idx": self._start_idx + int(consumed),
                "seed": -1 if seed is None else int(seed)}


class DataLoader:
    """Batches of ``dataset`` on ``places`` (default ``get_device()``: the
    card unless the CPU was asked for), from the main thread
    (``num_workers=0``), worker threads (``use_shared_memory=False`` or
    ``use_multiprocess=False``) or forked worker processes (the default
    with ``num_workers > 0``). ``device_prefetch=N`` wraps each epoch's
    iterator in a ``DevicePrefetcher`` staging N batches.
    ``use_buffer_reader`` is accepted for the Paddle signature and selects
    nothing: worker threads always feed the native queue."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_multiprocess=None,
                 device_prefetch=0, seed=None):
        self.dataset = dataset
        self.places = places
        self.return_list = return_list
        self.collate_fn = collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = bool(use_buffer_reader)
        self.device_prefetch = int(device_prefetch or 0)
        if use_multiprocess is None:
            use_multiprocess = use_shared_memory
        self.use_multiprocess = use_multiprocess
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        # with a seed the shuffle is a pure function of (seed, epoch);
        # seed=None keeps numpy's global-generator shuffle
        self.seed = None if seed is None else int(seed)
        self._epoch = 0
        self._batch_idx = 0
        self._resume_skip = 0
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            sampler = (
                _SeededRandomSampler(dataset, self.seed, lambda: self._epoch)
                if (shuffle and self.seed is not None) else None)
            self.batch_sampler = BatchSampler(
                dataset, sampler=sampler, shuffle=shuffle,
                batch_size=batch_size, drop_last=drop_last)

    # -- sample-exact resume ------------------------------------------------
    def state_dict(self) -> dict:
        """The position ``(epoch, batch_idx, seed)``; through a
        ``DevicePrefetcher`` use its ``state_dict()`` instead (the
        read-ahead moves this one early)."""
        return {"epoch": int(self._epoch), "batch_idx": int(self._batch_idx),
                "seed": -1 if self.seed is None else int(self.seed)}

    def load_state_dict(self, sd: dict) -> None:
        self._epoch = int(sd.get("epoch", 0))
        self._batch_idx = 0
        self._resume_skip = int(sd.get("batch_idx", 0))
        saved_seed = sd.get("seed")
        if saved_seed is not None:
            saved_seed = int(saved_seed)
            if saved_seed < 0:
                saved_seed = None
        if saved_seed is not None and saved_seed != self.seed:
            import warnings

            warnings.warn(
                f"DataLoader.load_state_dict: checkpoint seed {saved_seed} "
                f"differs from configured seed {self.seed}; adopting the "
                "checkpoint's so the replayed order matches the saved run")
            self.seed = int(saved_seed)
            if isinstance(self.batch_sampler, BatchSampler):
                cur = getattr(self.batch_sampler, "sampler", None)
                if isinstance(cur, _SeededRandomSampler):
                    cur.seed = int(saved_seed)
                elif self.shuffle and isinstance(cur, RandomSampler):
                    self.batch_sampler.sampler = _SeededRandomSampler(
                        self.dataset, int(saved_seed), lambda: self._epoch)

    set_state_dict = load_state_dict

    def batch_indices(self, epoch: int, batch_idx: int):
        """The sample indices of batch ``batch_idx`` of ``epoch`` when the
        order is a pure function of ``(seed, epoch)`` (seeded shuffle, or
        none), else None; the quarantine log names a condemned batch's
        samples with it."""
        if self.batch_sampler is None:
            return None
        sampler = getattr(self.batch_sampler, "sampler", None)
        if self.shuffle and not isinstance(sampler, _SeededRandomSampler):
            return None
        saved = self._epoch
        self._epoch = int(epoch)  # _SeededRandomSampler reads it
        try:
            for i, idxs in enumerate(self.batch_sampler):
                if i == int(batch_idx):
                    return [int(x) for x in idxs]
        finally:
            self._epoch = saved
        return None

    def _index_iter(self):
        """This epoch's index batches, the resume fast-forward applied at
        the index level (skipped batches are never loaded)."""
        it = iter(self.batch_sampler)
        skip, self._resume_skip = self._resume_skip, 0
        for _ in range(skip):
            next(it, None)
        self._batch_idx = skip
        return it, skip

    def _stateful_iter(self):
        """This epoch's position-tracking iterator, without the prefetch
        wrap."""
        places = self.places
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        device = place_mod.resolve_device(places)
        if isinstance(self.dataset, IterableDataset):
            it = _IterableIter(self)
        elif self.num_workers > 0 and self.use_multiprocess:
            import multiprocessing as mp

            if "fork" in mp.get_all_start_methods():
                it = _MultiprocessIter(self)
            else:
                it = _DataLoaderIter(self)
        else:
            it = _DataLoaderIter(self)
        return _StatefulIter(self, it, self._batch_idx, device)

    def __iter__(self):
        stateful = self._stateful_iter()
        if self.device_prefetch > 0:
            return DevicePrefetcher(stateful, buffer_size=self.device_prefetch,
                                    device=stateful.device)
        return stateful

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset has no length")
        return len(self.batch_sampler)


def get_worker_info():
    return None


def data_home():
    """The datasets' root: ``PADDLE_TPU_DATA_HOME``, as the reference's
    ``data_home``, else the port's own cache directory; where
    ``vision.datasets`` looks for local files (nothing is fetched)."""
    import os

    return os.environ.get(
        "PADDLE_TPU_DATA_HOME",
        os.path.expanduser("~/.cache/paddle_tpu_torch/datasets"))


# variable-length batching; imported last: ragged.py imports Sampler
from .ragged import (BucketSampler, bucket_boundaries,  # noqa: E402,F401
                     pad_to_bucket_collate)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "default_collate_fn",
    "DataLoader", "DevicePrefetcher", "device_prefetch", "get_worker_info",
    "data_home",
    "BucketSampler", "bucket_boundaries", "pad_to_bucket_collate",
]
