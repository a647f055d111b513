"""One gloo rank of ``tests/test_torch_api_parity.py``'s ``p2p_permute``
check.

    PADDLE_TRAINERS_NUM=2 PADDLE_TRAINER_ID=<rank> \\
    PADDLE_TRAINER_ENDPOINTS=127.0.0.1:<port> \\
        python tests/torch_p2p_worker.py <dir>

Joins the group through ``paddle_tpu_torch.distributed.init_parallel_env(
device="cpu")``, runs ``collective.p2p_permute`` on this rank's tensor (all
``rank + 1``) with a ring, a single pair and the identity, and writes the
results to ``<dir>/rank<r>.pt``. Imports torch and ``paddle_tpu_torch``
only.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import collective as C  # noqa: E402

PERMS = {"ring": [(0, 1), (1, 0)], "pair": [(0, 1)],
         "identity": [(0, 0), (1, 1)]}


def main(out_dir):
    tdist.init_parallel_env(device="cpu")
    rank = tdist.get_rank()
    x = torch.full((2, 3), rank + 1.0)
    out = {k: C.p2p_permute(x, perm) for k, perm in PERMS.items()}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
