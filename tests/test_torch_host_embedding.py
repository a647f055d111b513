"""``paddle_tpu_torch.incubate.host_embedding`` against the reference's on
the CPU: the single-process cases of ``tests/test_host_embedding.py`` in
the port, and the table's bits held equal to the reference's after the
same steps (the 20 GiB sparse-table case too).

The table's arithmetic is the reference's, so the bits match exactly: the
rows' lazy init (splitmix64 + Box-Muller), the select's backward (each
id's gradient summed over its occurrences in input order, as XLA's CPU
scatter-add does), the in-order duplicate merge and the SGD / row-wise
Adagrad rules, natively (the port's own ``core/csrc/embed.cc``) and on
the numpy path. The losses are sums whose order differs between the two
packages, so they are held at 1e-6.

The port's SGD hot-row cache is bit-exact against the plain path (its
hot gradients accumulate on the leaf in the merge's order), where the
reference's matches to summation-order rounding only (XLA's scatter
order); its Adagrad cache matches to reduction-order rounding in both.
"""
import gc
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.incubate import host_embedding as jhe
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.incubate import host_embedding as he
from paddle_tpu_torch.incubate.host_embedding import (HostEmbedding,
                                                      HostEmbeddingTable)
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def _cpu_and_flags():
    prev = flags.get_flags([
        "FLAGS_host_emb_native", "FLAGS_host_emb_cache_rows",
        "FLAGS_host_emb_async_push", "FLAGS_host_emb_cache_min_count",
    ])
    with cpu_device():
        yield
    flags.set_flags(prev)


def _loop(emb, ids_seq, lr=0.1, pkg=tp):
    """forward, sum(out^2), backward, push for each id batch; losses."""
    losses = []
    for ids in ids_seq:
        if pkg is tp:
            out = emb(torch.from_numpy(ids))
            loss = (out * out).sum()
            loss.backward()
            losses.append(loss.item())
        else:
            out = emb(paddle.to_tensor(ids))
            loss = paddle.sum(out * out)
            loss.backward()
            losses.append(float(loss.numpy()))
        emb.apply_gradients(lr=lr)
    return losses


# -- parity with the reference ---------------------------------------------------
@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("native", [True, False])
def test_table_bits_equal_the_reference_after_the_same_steps(optimizer,
                                                             native):
    flags.set_flags({"FLAGS_host_emb_native": native})
    rng = np.random.RandomState(9)
    ids_seq = [rng.randint(0, 96, (4, 6)) for _ in range(4)]
    mine = HostEmbedding(96, 12, seed=5, optimizer=optimizer)
    ref = jhe.HostEmbedding(96, 12, seed=5, optimizer=optimizer)
    got = _loop(mine, ids_seq)
    want = _loop(ref, ids_seq, pkg=paddle)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(mine.table.table, ref.table.table)
    if optimizer == "adagrad":
        np.testing.assert_array_equal(mine.table._accum, ref.table._accum)


def test_lazy_init_rows_equal_the_reference():
    ids = np.array([0, 7, 123456, 5_000_000], np.int64)
    np.testing.assert_array_equal(
        he._hash_normal_rows(ids, 32, 11, 0.02),
        jhe._hash_normal_rows(ids, 32, 11, 0.02))
    np.testing.assert_array_equal(
        he._splitmix64(ids.astype(np.uint64)),
        jhe._splitmix64(ids.astype(np.uint64)))


def test_select_backward_sums_duplicates_in_input_order():
    """The rows' gradient of ``rows[inverse]`` is np.add.at's in-order
    sum, bit for bit, whatever the multiplicity."""
    rng = np.random.RandomState(4)
    inv = np.array([3, 1, 3, 3, 0, 1, 3, 2, 3, 1])
    rows = torch.tensor(rng.randn(5, 7).astype(np.float32),
                        requires_grad=True)
    g = rng.randn(10, 7).astype(np.float32) * 10 ** rng.randint(
        -3, 4, (10, 1)).astype(np.float32)
    he._select(rows, inv).backward(torch.from_numpy(g))
    want = np.zeros((5, 7), np.float32)
    np.add.at(want, inv, g)
    np.testing.assert_array_equal(rows.grad.numpy(), want)
    pos, dest, bounds = he._dup_rounds(inv)
    assert len(bounds) - 1 == 5  # id 3 occurs 5 times: 5 rounds
    for b, e in zip(bounds[:-1], bounds[1:]):
        assert len(set(dest[b:e])) == e - b  # unique destinations a round


# -- tests/test_host_embedding.py, in the port ------------------------------------
class TestParityWithDeviceEmbedding:
    def test_forward_and_sgd_step_match_dense_embedding(self):
        V, D = 50, 8
        he_l = HostEmbedding(V, D, optimizer="sgd", seed=3)
        dense = tp.nn.Embedding(V, D)
        ids_np = np.array([[1, 4, 4], [7, 1, 9]], np.int64)
        he_l(torch.from_numpy(ids_np))  # touch: init the rows
        he_l._pending = []
        with torch.no_grad():
            dense.weight.copy_(torch.from_numpy(he_l.table.gather(
                np.arange(V))))
        target = torch.from_numpy(np.random.RandomState(0).randn(
            2, 3, 8).astype(np.float32))
        he_l.train()
        loss_h = tp.nn.functional.mse_loss(he_l(torch.from_numpy(ids_np)),
                                           target)
        loss_h.backward()
        he_l.apply_gradients(lr=0.5)
        loss_d = tp.nn.functional.mse_loss(dense(torch.from_numpy(ids_np)),
                                           target)
        loss_d.backward()
        tp.optimizer.SGD(0.5, parameters=[dense.weight]).step()
        np.testing.assert_allclose(loss_h.item(), loss_d.item(), rtol=1e-6)
        np.testing.assert_allclose(he_l.table.gather(np.arange(V)),
                                   dense.weight.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)

    def test_adagrad_rule(self):
        t = HostEmbeddingTable(10, 4, optimizer="adagrad", seed=0)
        rows = t.gather(np.array([2, 3]))
        t.apply_update(np.array([2, 3]), np.ones((2, 4), np.float32), lr=1.0)
        np.testing.assert_allclose(t.gather(np.array([2, 3])), rows - 1.0,
                                   rtol=1e-5, atol=1e-5)


class TestNativeNumpyParity:
    """The embed.cc kernels and the numpy path are two implementations of
    ONE semantics: bit-exact."""

    def _tables(self, optimizer, V=300, D=24, seed=11):
        return (HostEmbeddingTable(V, D, optimizer=optimizer, seed=seed),
                HostEmbeddingTable(V, D, optimizer=optimizer, seed=seed))

    def test_gather_bit_exact(self):
        a, b = self._tables("sgd")
        ids = np.random.RandomState(0).randint(0, 300, 500).astype(np.int64)
        flags.set_flags({"FLAGS_host_emb_native": True})
        ra = a.gather(ids)
        flags.set_flags({"FLAGS_host_emb_native": False})
        assert (ra == b.gather(ids)).all()

    @pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
    def test_update_bit_exact(self, optimizer):
        rng = np.random.RandomState(1)
        a, b = self._tables(optimizer)
        uniq = np.unique(rng.randint(0, 300, 200)).astype(np.int64)
        a.gather(uniq), b.gather(uniq)
        for _ in range(3):
            g = rng.randn(uniq.size, 24).astype(np.float32)
            flags.set_flags({"FLAGS_host_emb_native": True})
            a.apply_update(uniq, g, lr=0.3)
            flags.set_flags({"FLAGS_host_emb_native": False})
            b.apply_update(uniq, g, lr=0.3)
        assert (a.table == b.table).all()
        if optimizer == "adagrad":
            assert (a._accum == b._accum).all()

    def test_duplicate_id_merge_bit_exact(self):
        rng = np.random.RandomState(2)
        ids = [rng.randint(0, 64, 40).astype(np.int64) for _ in range(3)]
        grads = [rng.randn(40, 8).astype(np.float32) for _ in range(3)]
        flags.set_flags({"FLAGS_host_emb_native": True})
        ua, ga = he._merge_sparse_grads(ids, grads, 8)
        flags.set_flags({"FLAGS_host_emb_native": False})
        ub, gb = he._merge_sparse_grads(ids, grads, 8)
        assert (ua == ub).all()
        np.testing.assert_array_equal(ga, gb)

    def test_unique_matches_numpy(self):
        ids = np.random.RandomState(3).randint(0, 50, 400).astype(np.int64)
        flags.set_flags({"FLAGS_host_emb_native": True})
        ua, ia = he._unique(ids)
        un, inn = np.unique(ids, return_inverse=True)
        assert (ua == un).all() and (ia == inn.ravel()).all()

    def test_negative_id_raises_not_faults(self):
        flags.set_flags({"FLAGS_host_emb_native": True})
        t = HostEmbeddingTable(10, 4)
        with pytest.raises(IndexError):
            he._unique(np.array([1, -2, 3], np.int64))
        with pytest.raises(IndexError):
            t.gather(np.array([2, 99], np.int64))

    def test_full_train_loop_bit_exact_native_vs_numpy(self):
        def run():
            emb = HostEmbedding(96, 12, seed=5)
            rng = np.random.RandomState(9)
            losses = _loop(emb, [rng.randint(0, 96, (4, 6))
                                 for _ in range(4)])
            return losses, emb.table.gather(np.arange(96))

        flags.set_flags({"FLAGS_host_emb_native": True})
        l_nat, t_nat = run()
        flags.set_flags({"FLAGS_host_emb_native": False})
        l_np, t_np = run()
        assert l_nat == l_np and (t_nat == t_np).all()

    def test_a_failed_build_raises_and_nothing_falls_back(self, monkeypatch):
        from paddle_tpu_torch.core import native

        def broken():
            raise RuntimeError("native runtime build failed (test)")

        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "build", broken)
        flags.set_flags({"FLAGS_host_emb_native": True})
        t = HostEmbeddingTable(10, 4)
        with pytest.raises(RuntimeError, match="build failed"):
            t.gather(np.array([1, 2], np.int64))
        with pytest.raises(RuntimeError, match="build failed"):
            he._unique(np.array([1, 2], np.int64))
        flags.set_flags({"FLAGS_host_emb_native": False})  # the explicit path
        assert t.gather(np.array([1, 2], np.int64)).shape == (2, 4)


class TestHotRowCache:
    def _run_sgd(self, cache_rows, scatter=False):
        flags.set_flags({"FLAGS_host_emb_cache_min_count": 1})
        emb = HostEmbedding(64, 8, seed=2, cache_rows=cache_rows)
        if scatter and emb.cache is not None:
            # the Adagrad-style scatter path instead of the dense leaf
            emb.cache.dense = False
            emb.cache._rows.requires_grad_(False)
        rng = np.random.RandomState(3)
        _loop(emb, [(rng.zipf(1.5, 32) % 64).astype(np.int64).reshape(4, 8)
                    for _ in range(5)], lr=0.05)
        return emb

    @pytest.mark.parametrize("scatter", [False, True],
                             ids=["dense", "scatter"])
    def test_sgd_coherence_bit_exact_through_flush_and_evict(self, scatter):
        ref = self._run_sgd(0)
        cached = self._run_sgd(16, scatter=scatter)
        assert cached.cache is not None and cached.cache.hits > 0
        cached.sync()
        full = np.arange(64)
        assert (ref.table.gather(full) == cached.table.gather(full)).all()
        occ = np.nonzero(cached.cache._slot_ids >= 0)[0]
        cached.cache.evict(occ)
        assert cached.cache.stats()["occupied_rows"] == 0
        assert (ref.table.gather(full) == cached.table.gather(full)).all()

    def test_adagrad_coherence(self):
        def run(cache_rows):
            flags.set_flags({"FLAGS_host_emb_cache_min_count": 1})
            emb = HostEmbedding(48, 8, seed=4, optimizer="adagrad",
                                cache_rows=cache_rows)
            rng = np.random.RandomState(5)
            _loop(emb, [(rng.zipf(1.5, 24) % 48).astype(np.int64)
                        .reshape(3, 8) for _ in range(4)], lr=0.05)
            emb.sync()
            return emb.table.gather(np.arange(48)), np.asarray(
                emb.table._accum)

        t_ref, a_ref = run(0)
        t_c, a_c = run(12)
        np.testing.assert_allclose(t_c, t_ref, rtol=2e-5, atol=2e-7)
        np.testing.assert_allclose(a_c, a_ref, rtol=2e-5, atol=2e-7)

    def test_admission_is_frequency_gated(self):
        flags.set_flags({"FLAGS_host_emb_cache_min_count": 3})
        emb = HostEmbedding(64, 4, seed=1, cache_rows=8)
        ids = np.array([[1, 2, 3, 4]], np.int64)
        for step in range(4):
            _loop(emb, [ids], lr=0.01)
            if step < 2:
                assert emb.cache.stats()["occupied_rows"] == 0
        assert emb.cache.stats()["occupied_rows"] == 4
        emb(torch.from_numpy(ids))
        assert emb.cache.hits >= 4

    def test_pressure_shrink_halves_capacity_and_writes_back(self):
        from paddle_tpu_torch.fault import memory as fmem

        flags.set_flags({"FLAGS_host_emb_cache_min_count": 1})
        emb = HostEmbedding(64, 8, seed=2, cache_rows=16)
        ids = np.arange(12, dtype=np.int64).reshape(2, 6)
        _loop(emb, [ids] * 3, lr=0.05)
        assert emb.cache.stats()["occupied_rows"] > 0
        res = fmem.free_pressure("test")
        name = next(k for k in res["handlers"]
                    if k.startswith("host_emb_cache"))
        assert res["handlers"][name]["requested"]
        _loop(emb, [ids], lr=0.05)
        assert emb.cache.capacity == 8
        emb.sync()
        emb2 = HostEmbedding(64, 8, seed=2)
        _loop(emb2, [ids] * 4, lr=0.05)
        np.testing.assert_array_equal(emb.table.gather(np.arange(64)),
                                      emb2.table.gather(np.arange(64)))

    def test_cache_refused_on_sharded_table(self):
        t = he.ShardedHostEmbeddingTable(32, 4, store=None, rank=0,
                                         world_size=2)
        assert HostEmbedding(32, 4, table=t, cache_rows=8).cache is None


class TestPipelinedPull:
    def test_prefetch_ordering_two_ahead(self):
        emb = HostEmbedding(64, 8, seed=2)
        rng = np.random.RandomState(0)
        b1, b2 = rng.randint(0, 64, (2, 3, 4)).astype(np.int64)
        ref = HostEmbedding(64, 8, seed=2)
        r1 = ref(torch.from_numpy(b1)).detach().numpy()
        r2 = ref(torch.from_numpy(b2)).detach().numpy()
        c0 = profiler.counters().get("host_emb_prefetch_hits", 0)
        emb.prefetch(b1)
        emb.prefetch(b2)
        np.testing.assert_array_equal(
            emb(torch.from_numpy(b1)).detach().numpy(), r1)
        np.testing.assert_array_equal(
            emb(torch.from_numpy(b2)).detach().numpy(), r2)
        assert profiler.counters().get("host_emb_prefetch_hits", 0) == c0 + 2

    def test_skipped_prefetch_dropped_matching_consumed(self):
        emb = HostEmbedding(64, 8, seed=2)
        emb.prefetch(np.array([[1, 2, 3]], np.int64))
        emb.prefetch(np.array([[4, 5, 6]], np.int64))
        d0 = profiler.counters().get("host_emb_prefetch_drops", 0)
        emb(torch.tensor([[4, 5, 6]]))
        assert profiler.counters().get("host_emb_prefetch_drops", 0) == d0 + 1
        assert emb._slots == []

    def test_push_patches_staged_pack(self):
        ids = np.array([[7, 8, 9]], np.int64)
        emb = HostEmbedding(32, 4, seed=6)
        out = emb(torch.from_numpy(ids))
        (out * out).sum().backward()
        emb.prefetch(ids)  # staged with the PRE-push rows
        emb.sync()
        emb.apply_gradients(0.25)  # the push patches the staged pack
        got = emb(torch.from_numpy(ids)).detach().numpy()
        ref = HostEmbedding(32, 4, seed=6)
        _loop(ref, [ids], lr=0.25)
        np.testing.assert_array_equal(
            got, ref(torch.from_numpy(ids)).detach().numpy())

    @pytest.mark.parametrize("cache_rows", [0, 16])
    def test_async_push_parity_and_ordering(self, cache_rows):
        def run(async_push, prefetch, cache):
            flags.set_flags({"FLAGS_host_emb_async_push": async_push,
                             "FLAGS_host_emb_cache_min_count": 1})
            emb = HostEmbedding(128, 8, seed=3, cache_rows=cache)
            rng = np.random.RandomState(7)
            batches = [(rng.zipf(1.4, 48) % 128).astype(np.int64)
                       .reshape(6, 8) for _ in range(5)]
            losses = []
            for k, ids in enumerate(batches):
                if prefetch and k + 1 < len(batches):
                    emb.prefetch(batches[k + 1])
                losses += _loop(emb, [ids], lr=0.05)
            emb.sync()
            return losses, emb.table.gather(np.arange(128))

        l_ref, t_ref = run(False, False, 0)
        l_async, t_async = run(True, True, cache_rows)
        assert l_ref == l_async
        assert (t_ref == t_async).all()

    def test_prefetch_iter_of_micro_batch_lists(self):
        """A step's micro-batches prefetched as one list (one union pack):
        every forward is a prefetch hit, the numbers the plain path's."""
        rng = np.random.RandomState(1)
        steps = [[rng.randint(0, 64, (2, 4)).astype(np.int64)
                  for _ in range(3)] for _ in range(4)]

        def run(pipelined):
            flags.set_flags({"FLAGS_host_emb_async_push": pipelined,
                             "FLAGS_host_emb_cache_min_count": 1})
            emb = HostEmbedding(64, 8, seed=2,
                                cache_rows=8 if pipelined else 0)
            losses = []
            it = emb.prefetch_iter(steps) if pipelined else steps
            for step in it:
                for mb in step:
                    out = emb(torch.from_numpy(mb))
                    loss = (out * out).sum()
                    loss.backward()
                    losses.append(loss.item())
                emb.apply_gradients(0.05)
            emb.sync()
            return losses, emb.table.gather(np.arange(64))

        c0 = profiler.counters().get("host_emb_prefetch_hits", 0)
        l_p, t_p = run(True)
        assert profiler.counters().get("host_emb_prefetch_hits", 0) == c0 + 12
        l_s, t_s = run(False)
        assert l_p == l_s and (t_p == t_s).all()

    def test_abandoned_layer_releases_worker_thread(self):
        emb = HostEmbedding(64, 8, seed=2)
        emb.prefetch(np.array([[1, 2]], np.int64))
        emb.sync()
        th = emb._worker._thread
        assert th.is_alive()
        del emb
        gc.collect()
        th.join(timeout=10)
        assert not th.is_alive(), "PS worker thread not released on GC"

    def test_worker_error_surfaces_at_caller(self):
        flags.set_flags({"FLAGS_host_emb_async_push": True})
        emb = HostEmbedding(32, 4, seed=1)
        out = emb(torch.tensor([[1, 2]]))
        (out * out).sum().backward()
        emb.table.apply_update = None  # the background apply fails
        emb.apply_gradients(lr=0.1)
        with pytest.raises(RuntimeError, match="PS worker"):
            emb.sync()


class TestInertTripwire:
    def test_defaults_no_threads_no_cache(self):
        n0 = threading.active_count()
        emb = HostEmbedding(64, 8, seed=1)
        _loop(emb, [np.array([[1, 2, 3]], np.int64)])
        assert emb.cache is None and emb._worker is None
        assert threading.active_count() == n0

    def test_native_off_never_touches_kernels(self, monkeypatch):
        flags.set_flags({"FLAGS_host_emb_native": False})

        def boom(*a, **k):
            raise AssertionError("native kernel touched with "
                                 "FLAGS_host_emb_native=0")

        from paddle_tpu_torch.core import native

        L = native.lib()
        for sym in ("pte_unique", "pte_gather_f32", "pte_sgd_f32",
                    "pte_adagrad_f32", "pte_merge_f32"):
            monkeypatch.setattr(L, sym, boom)
        n0 = threading.active_count()
        emb = HostEmbedding(64, 8, seed=1)
        rng = np.random.RandomState(0)
        _loop(emb, [rng.randint(0, 64, (2, 3)) for _ in range(2)])
        assert emb._worker is None and emb.cache is None
        assert threading.active_count() == n0


class TestPhysicalSize:
    def test_fallback_accounts_initialized_rows(self, tmp_path, monkeypatch):
        monkeypatch.setattr(he, "_fs_sparse_probe", {str(tmp_path): False})
        t = HostEmbeddingTable(10_000, 64, path=str(tmp_path / "t.npy"))
        base = t.state_nbytes_physical()
        assert base <= 8192
        t.gather(np.array([1, 2, 3], np.int64))
        assert t.state_nbytes_physical() == 3 * 64 * 4 + 4096

    def test_probe_detects_this_fs(self, tmp_path):
        t = HostEmbeddingTable(100_000, 32, path=str(tmp_path / "t.npy"))
        t.gather(np.arange(50, dtype=np.int64))
        assert t.state_nbytes_physical() < 100_000 * 32 * 4 // 10


def test_20gib_logical_table_trains_and_equals_the_reference(tmp_path):
    """5,242,880 x 1024 f32 = 20 GiB logical in a sparse memmap (the
    reference's ssd_sparse_table capability): one step in each package,
    the touched rows bit-equal, the file sparse."""
    V, D = 5_242_880, 1024
    rng = np.random.RandomState(0)
    ids_np = rng.randint(0, V, (4, 64)).astype(np.int64)
    mine = HostEmbedding(V, D, path=str(tmp_path / "t.npy"), seed=1)
    ref = jhe.HostEmbedding(V, D, path=str(tmp_path / "r.npy"), seed=1)
    assert mine.table.table.shape == (V, D)
    assert mine.table.table.nbytes >= 20 * 1024 ** 3
    touched = np.unique(ids_np)
    before = mine.table.gather(touched[:4]).copy()
    got = _loop(mine, [ids_np], lr=0.1)
    want = _loop(ref, [ids_np], lr=0.1, pkg=paddle)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.abs(before - mine.table.gather(touched[:4])).max() > 0
    np.testing.assert_array_equal(mine.table.table[touched],
                                  ref.table.table[touched])
    assert mine.table.state_nbytes_physical() < 1024 ** 3


def test_sharded_transport_stays_serial_and_counts_it(monkeypatch):
    """When the extra store connections cannot be opened the transport
    stays serial, as the reference's does, and ``host_emb_transport_serial``
    counts each serial exchange."""
    from paddle_tpu_torch.distributed import coord

    def refuse(*a, **k):
        raise ConnectionRefusedError("no endpoint")

    monkeypatch.setattr(coord, "TCPStore", refuse)
    t = he.ShardedHostEmbeddingTable(32, 4, store=None, rank=0, world_size=2,
                                     store_addr=("127.0.0.1", 1))
    c0 = profiler.counters().get("host_emb_transport_serial", 0)
    assert t._transport() is None and t._transport() is None
    assert t._pool is False
    assert profiler.counters().get("host_emb_transport_serial", 0) == c0 + 2
