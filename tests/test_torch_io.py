"""Port parity: ``paddle_tpu_torch.io`` against the reference's
``paddle_tpu.io``.

The same numpy dataset goes through both packages' loaders. Every check is
exact (bit-equal batches, equal indices and positions):
- a seeded shuffle yields the reference's batches with 0 workers, worker
  threads and forked worker processes, with and without ``drop_last``,
  over two epochs, and after ``load_state_dict`` mid-epoch;
- ``DistributedBatchSampler`` over 3 replicas, ``BucketSampler`` with
  ``pad_to_bucket_collate``, ``random_split`` and the other samplers;
- ``DevicePrefetcher`` on the CPU keeps order, raises a worker's exception
  again at ``next()``, and its ``state_dict`` counts the batches handed
  out, never the read-ahead, as the reference's does; with a ``sharding``
  layout it cuts each leaf to this rank's slice before the copy and tags
  the copy with its placement.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from torch_port_util import cpu_device

N, T = 23, 5
IDS = np.arange(N * T, dtype=np.int64).reshape(N, T) * 7 % 101
VALS = np.random.RandomState(4).standard_normal((N, 3)).astype(np.float32)


def _np(b):
    return [np.asarray(x.numpy()) for x in b]


def _ref_batches(loader):
    return [_np(b) for b in loader]


def _loaders(**kw):
    return (jio.DataLoader(jio.TensorDataset([IDS, VALS]), **kw),
            tio.DataLoader(tio.TensorDataset([IDS, VALS]), places="cpu",
                           **kw))


def _assert_same(got, want, ordered=True):
    """Bit-equal batches; worker threads hand batches out in the order
    they finish, in both packages, so their batches compare as a set."""
    assert len(got) == len(want)
    if not ordered:
        got, want = (sorted(bs, key=lambda b: b[0].tobytes())
                     for bs in (got, want))
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


WORKERS = {"main": {}, "threads": {"num_workers": 2,
                                   "use_shared_memory": False},
           "processes": {"num_workers": 2}}


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("workers", sorted(WORKERS))
def test_seeded_loader_batches_equal_the_reference(workers, drop_last):
    jl, tl = _loaders(batch_size=4, shuffle=True, seed=7, drop_last=drop_last,
                      **WORKERS[workers])
    for _ in range(2):  # two epochs: (seed, epoch) drives the shuffle
        want = _ref_batches(jl)
        got = _ref_batches(tl)
        _assert_same(got, want, ordered=workers != "threads")
        assert tl.state_dict() == jl.state_dict()
    assert len(tl) == len(jl)


@pytest.mark.parametrize("workers", sorted(WORKERS))
def test_resume_mid_epoch_replays_the_reference_order(workers):
    _, tl = _loaders(batch_size=3, shuffle=True, seed=11, **WORKERS[workers])
    jl, _ = _loaders(batch_size=3, shuffle=True, seed=11)
    full = _ref_batches(jl)  # the index order, from the main thread
    it = iter(tl)
    next(it)
    next(it)
    sd = tl.state_dict()
    assert sd == {"epoch": 0, "batch_idx": 2, "seed": 11}
    _, fresh = _loaders(batch_size=3, shuffle=True, seed=11,
                        **WORKERS[workers])
    fresh.load_state_dict(sd)
    _assert_same(_ref_batches(fresh), full[2:], ordered=workers != "threads")
    jfresh, _ = _loaders(batch_size=3, shuffle=True, seed=11)
    jfresh.load_state_dict(sd)
    _assert_same(_ref_batches(jfresh), full[2:])


def test_unseeded_loader_follows_numpy_global_generator():
    jl, tl = _loaders(batch_size=5, shuffle=True)
    np.random.seed(3)
    want = _ref_batches(jl)
    np.random.seed(3)
    _assert_same(_ref_batches(tl), want)


def test_batch_indices_name_the_batch():
    jl, tl = _loaders(batch_size=4, shuffle=True, seed=2)
    for e, b in ((0, 3), (1, 0), (1, 5)):
        assert tl.batch_indices(e, b) == jl.batch_indices(e, b)
    assert tl._epoch == 0


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("rank", [0, 1, 2])
def test_distributed_batch_sampler_three_replicas(rank, shuffle):
    kw = dict(batch_size=3, num_replicas=3, rank=rank, shuffle=shuffle)
    js = jio.DistributedBatchSampler(jio.TensorDataset([IDS]), **kw)
    ts = tio.DistributedBatchSampler(tio.TensorDataset([IDS]), **kw)
    for _ in range(2):
        assert list(ts) == list(js)
    assert len(ts) == len(js)


def test_distributed_batch_sampler_defaults_to_world_one():
    ts = tio.DistributedBatchSampler(tio.TensorDataset([IDS]), batch_size=4)
    assert (ts.nranks, ts.local_rank) == (1, 0)
    assert [i for b in ts for i in b] == list(range(N))


def test_bucket_sampler_and_pad_collate():
    lengths = np.random.RandomState(1).randint(3, 40, 50)
    seqs = [np.arange(n, dtype=np.int64) + 1 for n in lengths]
    assert tio.bucket_boundaries(lengths, 4) == jio.bucket_boundaries(
        lengths, 4)
    kw = dict(batch_size=4, num_buckets=4, shuffle=True, seed=5)
    js, ts = jio.BucketSampler(lengths, **kw), tio.BucketSampler(lengths, **kw)
    for _ in range(2):
        jb, tb = list(js), list(ts)
        assert tb == jb
    assert len(ts) == len(js)
    bounds = ts.boundaries
    jc = jio.pad_to_bucket_collate(bounds, returns_label=True)
    tc = tio.pad_to_bucket_collate(bounds, returns_label=True)
    for batch in tb:
        items = [(seqs[i], seqs[i] * 2) for i in batch]
        for a, b in zip(tc(items), jc(items)):
            np.testing.assert_array_equal(a, b)


def test_random_split_and_samplers_follow_numpy():
    ds_j, ds_t = jio.TensorDataset([IDS]), tio.TensorDataset([IDS])
    np.random.seed(8)
    want = [s.indices for s in jio.random_split(ds_j, [10, 13])]
    np.random.seed(8)
    got = [s.indices for s in tio.random_split(ds_t, [10, 13])]
    assert got == want
    for make in (lambda m, d: m.RandomSampler(d),
                 lambda m, d: m.RandomSampler(d, replacement=True,
                                              num_samples=9),
                 lambda m, d: m.WeightedRandomSampler(np.arange(N) + 1.0, 12),
                 lambda m, d: m.SequenceSampler(d)):
        np.random.seed(9)
        want = list(make(jio, ds_j))
        np.random.seed(9)
        assert list(make(tio, ds_t)) == want


def test_datasets_compose_concat_chain_subset():
    a, b = tio.TensorDataset([IDS[:5]]), tio.TensorDataset([IDS[5:9]])
    cat = tio.ConcatDataset([a, b])
    assert len(cat) == 9
    np.testing.assert_array_equal(cat[6][0], IDS[6])
    comp = tio.ComposeDataset([a, tio.TensorDataset([VALS[:5]])])
    assert len(comp) == 5 and len(comp[2]) == 2
    assert list(iter(tio.ChainDataset([[1, 2], [3]]))) == [1, 2, 3]
    assert tio.Subset(a, [4, 0])[0][0].tolist() == IDS[4].tolist()


def test_default_collate_matches_reference():
    samples = [(np.int64(3), 1.5, {"a": np.ones(2, np.float32)}),
               (np.int64(4), 2.5, {"a": np.zeros(2, np.float32)})]
    got = tio.default_collate_fn(samples)
    want = jio.default_collate_fn(samples)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0].numpy()))
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    np.testing.assert_array_equal(got[2]["a"].numpy(),
                                  np.asarray(want[2]["a"].numpy()))


def test_loader_without_a_place_raises_when_cuda_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    loader = tio.DataLoader(tio.TensorDataset([IDS]), batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iter(loader)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.DevicePrefetcher([np.zeros(2)])
    with cpu_device():
        assert next(iter(loader))[0].device.type == "cpu"


def test_forked_workers_refuse_tensor_samples():
    ds = tio.TensorDataset([torch.from_numpy(IDS)])
    loader = tio.DataLoader(ds, batch_size=4, num_workers=2, places="cpu")
    with pytest.raises(RuntimeError, match="torch Tensor"):
        list(loader)


# -- DevicePrefetcher ---------------------------------------------------------

def test_prefetcher_keeps_order_and_state_ignores_read_ahead():
    jl, tl = _loaders(batch_size=2, shuffle=True, seed=3)
    jp = jio.DevicePrefetcher(jl, buffer_size=3)
    tp = tio.DevicePrefetcher(tl, buffer_size=3, device="cpu")
    for _ in range(4):
        _assert_same([_np(next(tp))], [_np(next(jp))])
    # the thread has read ahead; the position counts what was handed out
    assert tp.state_dict() == jp.state_dict() == {
        "epoch": 0, "batch_idx": 4, "seed": 3}
    rest_t, rest_j = _ref_batches(tp), _ref_batches(jp)
    _assert_same(rest_t, rest_j)
    assert len(rest_t) == len(tl) - 4


def test_prefetcher_load_state_dict_resumes():
    _, tl = _loaders(batch_size=2, shuffle=True, seed=3)
    full = _ref_batches(tio.DevicePrefetcher(tl, device="cpu"))
    _, tl = _loaders(batch_size=2, shuffle=True, seed=3)
    tp = tio.DevicePrefetcher(tl, device="cpu")
    for _ in range(3):
        next(tp)
    sd = tp.state_dict()
    _, fresh = _loaders(batch_size=2, shuffle=True, seed=3)
    fp = tio.DevicePrefetcher(fresh, device="cpu")
    next(fp)
    fp.load_state_dict(sd)
    _assert_same(_ref_batches(fp), full[3:])
    tp.close()


class _Boom(tio.Dataset):
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 4:
            raise ValueError("boom at 4")
        return np.full(2, i, np.int64)


def test_prefetcher_raises_a_worker_exception_at_next():
    loader = tio.DataLoader(_Boom(), batch_size=2, places="cpu")
    tp = tio.DevicePrefetcher(loader, device="cpu")
    assert next(tp).tolist() == [[0, 0], [1, 1]]
    assert next(tp).tolist() == [[2, 2], [3, 3]]
    with pytest.raises(ValueError, match="boom at 4"):
        next(tp)
    with pytest.raises(StopIteration):
        next(tp)  # closed after the error
    assert not tp._thread.is_alive()


def test_prefetcher_close_stops_the_thread_and_refuses_sharding():
    before = threading.active_count()
    _, tl = _loaders(batch_size=1)
    tp = tio.DevicePrefetcher(tl, buffer_size=1, device="cpu")
    next(tp)
    tp.close()
    assert not tp._thread.is_alive()
    assert threading.active_count() <= before
    with pytest.raises(TypeError, match="NamedSharding"):
        tio.DevicePrefetcher(tl, sharding=object(), device="cpu")


@pytest.mark.parametrize("form", ["layout", "spec", "callable"])
def test_prefetcher_cuts_each_leaf_to_this_ranks_slice(form):
    """A layout cuts each leaf before its copy, as the reference's
    ``device_put(arr, sharding)`` places it: here a mesh of two ranks
    along dim 0 seen from rank 0 and rank 1 (``local_shard``'s rank), the
    copy tagged with its placement and logical shape."""
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.distributed import sharding_api as tsh

    mesh = tmesh.Mesh(np.arange(1), ("dp",))
    spec = tsh.PartitionSpec("dp")
    lay = {"layout": tsh.NamedSharding(mesh, spec), "spec": spec,
           "callable": lambda i, t: tsh.NamedSharding(
               mesh, spec if i == 0 else tsh.PartitionSpec())}[form]
    batches = [(torch.arange(8).reshape(4, 2), torch.ones(4))]
    tp = tio.DevicePrefetcher(iter(batches), sharding=lay, device="cpu")
    x, y = next(tp)
    assert x.placement == ("dp", None) and x.logical_shape == (4, 2)
    assert y.logical_shape == (4,)
    assert torch.equal(x, batches[0][0])
    two = tmesh.Mesh(np.arange(2), ("dp",))
    parts = [tsh.local_shard(batches[0][0], spec, two, rank=r)
             for r in range(2)]
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]]]


def test_loader_device_prefetch_and_functional_form():
    _, tl = _loaders(batch_size=4, shuffle=True, seed=1)
    want = _ref_batches(tl)
    _, tl = _loaders(batch_size=4, shuffle=True, seed=1, device_prefetch=2)
    it = iter(tl)
    assert isinstance(it, tio.DevicePrefetcher)
    _assert_same(_ref_batches(it), want)
    _, tl = _loaders(batch_size=4, shuffle=True, seed=1)
    _assert_same(_ref_batches(tio.device_prefetch(tl, device="cpu")), want)


def test_quarantine_skip_advances_the_position():
    jl, tl = _loaders(batch_size=4, shuffle=True, seed=6)
    full = _ref_batches(jl)
    it = tl._stateful_iter()
    assert it.skip_batch()
    assert tl.state_dict()["batch_idx"] == 1
    _assert_same(_ref_batches(it), full[1:])
