"""One rank of ``tests/test_torch_host_embedding_dist.py``: the sharded
host embedding over a TCPStore.

    PADDLE_TRAINERS_NUM=2 PADDLE_TRAINER_ID=<rank> \\
        python tests/torch_host_emb_worker.py <dir> <store port> <steps>

Builds ``sharded_host_embedding`` (rank 0 hosts the store at ``<store
port>``; 64-byte store messages over 2 extra connections, so every exchange
is chunked and parallel), then ``<steps>`` steps: a forward of this rank's
id batch (from ``np.random.RandomState(100 * step + rank)``), sum(out^2),
backward and the collective push. Writes the forwards' outputs and the
local shard's rows to ``<dir>/rank<r>.pt``. Imports torch, numpy and
``paddle_tpu_torch`` only.
"""
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch import profiler  # noqa: E402
from paddle_tpu_torch.framework.flags import set_flags  # noqa: E402
from paddle_tpu_torch.incubate import sharded_host_embedding  # noqa: E402

V, D, LR = 97, 6, 0.1


def batch(step, rank):
    return np.random.RandomState(100 * step + rank).randint(0, V, (3, 5))


def main():
    out_dir, port, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    res = {}
    try:
        os.environ["PADDLE_EMB_STORE_PORT"] = port
        set_flags({"FLAGS_host_emb_chunk_bytes": 64,
                   "FLAGS_host_emb_transport_threads": 2})
        emb = sharded_host_embedding(V, D, seed=7, device="cpu")
        outs = []
        for step in range(steps):
            out = emb(torch.from_numpy(batch(step, rank)))
            outs.append(out.detach().numpy().copy())
            (out * out).sum().backward()
            emb.apply_gradients(LR)
        local = emb.table.local
        ids = np.nonzero(local._initialized)[0]
        res = {"outs": outs, "global_ids": ids * 2 + rank,
               "rows": np.asarray(local.table[ids]),
               "parallel": bool(emb.table._pool),
               "push_bytes": profiler.counters().get("host_emb_push_bytes",
                                                     0)}
        # the last rank out closes the store: wait for the peer's push
        emb.table.store.set(f"done/{rank}", "1")
        emb.table.store.wait(f"done/{1 - rank}")
        emb.table.close()
    except Exception:
        res = {"error": traceback.format_exc()}
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


if __name__ == "__main__":
    main()
