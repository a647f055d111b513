"""The sharded host embedding (``ShardedHostEmbeddingTable`` through
``incubate.sharded_host_embedding``) on 2 processes over the port's
TCPStore, held against one process of the reference's ``HostEmbedding``
(``paddle_tpu.incubate``) and one of the port's.

Each rank pushes one micro-batch a step; the owner of a row merges the
two ranks' gradients and applies ONE update (sync-PS semantics). One
process that runs both ranks' batches as two micro-batches of one step
merges the same two sums (a + b either way), and both packages' tables
draw the same rows and sum duplicates in input order, so the forwards'
outputs and the rows are bit-equal to either process. The store messages are 64 bytes over 2 extra
connections, so every exchange is chunked and parallel.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import HostEmbedding as RefHostEmbedding
from paddle_tpu_torch.incubate import HostEmbedding
from torch_port_util import cpu_device, free_port, spawn_ranks

WORKER = __import__("pathlib").Path(__file__).with_name(
    "torch_host_emb_worker.py")
STEPS = 3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_emb_dist")
    return spawn_ranks(WORKER, [d, free_port(), STEPS], 2, d, timeout_s=120)


def _single_process(pkg="port"):
    """(table, outputs by rank) of one process of ``pkg`` ("port" or
    "reference") over both ranks' batches, two micro-batches a step."""
    import torch_host_emb_worker as w

    ref = pkg == "reference"
    with cpu_device():
        emb = (RefHostEmbedding if ref else HostEmbedding)(w.V, w.D, seed=7)
        outs = {0: [], 1: []}
        for step in range(STEPS):
            for rank in (0, 1):
                ids = w.batch(step, rank)
                if ref:
                    out = emb(paddle.to_tensor(ids))
                    paddle.sum(out * out).backward()
                    outs[rank].append(np.array(out.numpy()))
                else:
                    out = emb(torch.from_numpy(ids))
                    (out * out).sum().backward()
                    outs[rank].append(out.detach().numpy().copy())
            emb.apply_gradients(w.LR)
        return emb, outs


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_two_ranks_match_one_process(ranks, pkg):
    emb, outs = _single_process(pkg)
    for rank, res in enumerate(ranks):
        assert res["parallel"], "the parallel transport was not used"
        assert res["push_bytes"] > 0
        for got, want in zip(res["outs"], outs[rank]):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            res["rows"], np.asarray(emb.table.table)[res["global_ids"]])


def test_each_rank_holds_its_own_ids(ranks):
    g0, g1 = ranks[0]["global_ids"], ranks[1]["global_ids"]
    assert (g0 % 2 == 0).all() and (g1 % 2 == 1).all()
    emb, _ = _single_process()
    assert set(g0) | set(g1) == set(np.nonzero(emb.table._initialized)[0])
