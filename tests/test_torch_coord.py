"""The coordination substrate (``paddle_tpu_torch.distributed.coord``):
``FileStore``, ``CommitBarrier``, ``wait_for`` and the ``TCPStore``
adapter, against the reference's (``paddle_tpu.distributed.coord``).

The same sequence of operations runs on the port's store and the
reference's, and every answer must agree: a missing key is None, ``add``
counts, ``delete_key`` forgets, keys escape ``/``. The two-phase barrier
runs two ranks as threads over one store; a rank that never acks leaves
the tag uncommitted and rank 0's wait raises ``DeadlineExceeded`` at its
deadline (never a hang). The ``TCPStore`` adapter gives the native
store's answers over ``torch.distributed.TCPStore``: ``get`` of a missing
key returns None at once (torch's own would block to its timeout), and
``wait`` keeps a deadline.
"""
import threading
import time

import pytest

from paddle_tpu.distributed import coord as jcoord
from paddle_tpu_torch.distributed import coord as tcoord

PKGS = {"port": tcoord, "ref": jcoord}


def _ops(store):
    out = [store.get("missing")]
    store.set("a/b", "1")
    store.set("c", b"xyz")
    out += [store.get("a/b"), store.get("c")]
    out += [store.add("n", 2), store.add("n", 3), store.get("n")]
    store.delete_key("c")
    out.append(store.get("c"))
    store.delete_key("never-set")
    return out


def test_filestore_answers_as_the_reference(tmp_path):
    got = _ops(tcoord.FileStore(str(tmp_path / "t")))
    want = _ops(jcoord.FileStore(str(tmp_path / "r")))
    assert got == want == [None, b"1", b"xyz", 2, 5, b"5", None]
    assert sorted(tcoord.FileStore(str(tmp_path / "t")).keys()) \
        == sorted(jcoord.FileStore(str(tmp_path / "r")).keys()) == ["a/b", "n"]


def test_filestore_add_serializes_threads(tmp_path):
    s = tcoord.FileStore(str(tmp_path))
    ts = [threading.Thread(target=lambda: [s.add("k") for _ in range(20)])
          for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert int(s.get("k")) == 80


@pytest.fixture()
def tcp():
    master = tcoord.TCPStore("127.0.0.1", 0, is_master=True, timeout=5)
    client = tcoord.TCPStore("127.0.0.1", master.port, is_master=False,
                             timeout=5)
    yield master, client
    client.close()
    master.close()


def test_tcpstore_answers_as_the_native_store(tcp, tmp_path):
    master, client = tcp
    t0 = time.monotonic()
    assert client.get("missing") is None
    assert time.monotonic() - t0 < 1.0  # no wait to the store's timeout
    got = _ops(client)
    assert got == _ops(jcoord.FileStore(str(tmp_path)))
    assert master.get("a/b") == b"1"  # one store, two endpoints


def test_tcpstore_wait_returns_the_value_or_meets_its_deadline(tcp):
    master, client = tcp
    threading.Timer(0.1, lambda: master.set("late", "v")).start()
    assert client.wait("late", timeout=5) == b"v"
    t0 = time.monotonic()
    with pytest.raises(tcoord.DeadlineExceeded) as e:
        client.wait("never", timeout=0.2)
    assert 0.2 <= time.monotonic() - t0 < 2.0
    assert "never" in e.value.what


def _barrier_world(pkg, store, tags, acking=(0, 1), timeout=5.0):
    bars = [pkg.CommitBarrier(store, 2, r, prefix="t") for r in range(2)]
    out = [None, None]

    def run(r):
        try:
            if r in acking:
                bars[r].ack(tags)
            out[r] = bars[r].commit(tags, timeout)
        except pkg.DeadlineExceeded as e:
            out[r] = e

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return bars, out


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_commit_barrier_two_phase_at_world_2(pkg, tmp_path):
    mod = PKGS[pkg]
    bars, out = _barrier_world(mod, mod.FileStore(str(tmp_path)), 7)
    assert out[0]["tag"] == out[1]["tag"] == "7"
    assert out[0]["world_size"] == 2
    assert bars[0].committed(7) and bars[0].acks(7) == 2
    bars[0].reset(7)
    assert not bars[1].committed(7) and bars[1].acks(7) == 0


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_commit_barrier_missing_rank_meets_the_deadline(pkg, tmp_path):
    mod = PKGS[pkg]
    bars, out = _barrier_world(mod, mod.FileStore(str(tmp_path)), 3,
                               acking=(1,), timeout=0.3)
    assert isinstance(out[0], mod.DeadlineExceeded)
    assert isinstance(out[1], mod.DeadlineExceeded)
    assert "acks" in out[0].what and "commit marker" in out[1].what
    assert not bars[0].committed(3)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_a_peer_ack_before_rank0_enters_is_erased(pkg, tmp_path):
    """The interleaving behind a clean coordinated save that times out
    (ROADMAP §C, C2), in both packages: a peer that runs ahead acks step 7
    before rank 0 enters its save, whose reset clears the step's acks; one
    ack is left of two and rank 0's commit meets its deadline."""
    mod = PKGS[pkg]
    store = mod.FileStore(str(tmp_path))
    bars = [mod.CommitBarrier(store, 2, r) for r in range(2)]
    assert bars[1].ack(7) == 1  # the peer's shard is durable
    bars[0].reset(7)            # rank 0 enters the save late
    assert bars[0].ack(7) == 1 and bars[0].acks(7) == 1
    with pytest.raises(mod.DeadlineExceeded):
        bars[0].commit(7, 0.2)


def test_commit_barrier_over_tcpstore(tcp):
    master, client = tcp
    bars = [tcoord.CommitBarrier(s, 2, r, prefix="x")
            for r, s in enumerate((master, client))]
    out = [None, None]

    def run(r):
        bars[r].ack("s")
        out[r] = bars[r].commit("s", 5.0)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert out[0]["tag"] == out[1]["tag"] == "s"


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_wait_for_deadline_and_callback(pkg):
    mod = PKGS[pkg]
    hit = []
    with pytest.raises(mod.DeadlineExceeded) as e:
        mod.wait_for(lambda: False, "nothing", 0.1, interval_s=0.01,
                     on_timeout=lambda: hit.append(1))
    assert hit == [1] and e.value.what == "nothing"
    assert e.value.waited_s >= 0.1
    mod.wait_for(lambda: True, "now", 0.1)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_store_from_env(pkg, tmp_path, monkeypatch):
    mod = PKGS[pkg]
    monkeypatch.delenv("PADDLE_TPU_STORE_DIR", raising=False)
    assert mod.store_from_env() is None
    monkeypatch.setenv("PADDLE_TPU_STORE_DIR", str(tmp_path))
    s = mod.store_from_env()
    s.set("k", "v")
    assert mod.FileStore(str(tmp_path)).get("k") == b"v"
