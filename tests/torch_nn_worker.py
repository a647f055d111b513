"""One gloo rank of the ``nn`` files' two-rank checks
(``tests/test_torch_nn_norm.py``, ``tests/test_torch_nn_loss.py``).

    PADDLE_TRAINERS_NUM=2 PADDLE_TRAINER_ID=<rank> \\
    PADDLE_TRAINER_ENDPOINTS=127.0.0.1:<port> \\
        python tests/torch_nn_worker.py <suite> <dir>

Joins the group through ``paddle_tpu_torch.distributed.init_parallel_env(
device="cpu")``, reads ``<dir>/inputs.npz`` and runs one suite on this
rank's half:

* ``syncbn``: ``SyncBatchNorm`` over this rank's half of the batch, two
  training steps (output, input gradient, parameter gradients, buffers
  after each), then eval;
* ``margin``: ``fleet.init`` at mp 2, then ``margin_cross_entropy`` on this
  rank's half of the class axis (loss, softmax shard, logits gradient).

Writes what it got to ``<dir>/rank<r>.pt``. Imports torch, numpy and
``paddle_tpu_torch`` only.
"""
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402


def _half(a, rank, axis=0):
    n = a.shape[axis] // 2
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(rank * n, (rank + 1) * n), axis=axis)))


def syncbn(rank, inp, out):
    bn = nn.SyncBatchNorm(inp["x1"].shape[1], momentum=0.8, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["w"]))
        bn.bias.copy_(torch.from_numpy(inp["b"]))
    for step in (1, 2):
        x = _half(inp[f"x{step}"], rank).requires_grad_(True)
        y = bn(x)
        (y * _half(inp[f"g{step}"], rank)).sum().backward()
        out[f"step{step}"] = {
            "y": y.detach(), "dx": x.grad, "dw": bn.weight.grad.clone(),
            "db": bn.bias.grad.clone(), "mean": bn._mean.clone(),
            "var": bn._variance.clone()}
        bn.weight.grad = bn.bias.grad = None
    bn.eval()
    out["eval"] = bn(_half(inp["x1"], rank)).detach()


def margin(rank, inp, out):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, mp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    group = fleet.get_hybrid_communicate_group().get_model_parallel_group()
    logits = _half(inp["logits"], rank, axis=1).requires_grad_(True)
    loss, soft = F.margin_cross_entropy(
        logits, torch.from_numpy(inp["label"]), margin1=1.0, margin2=0.3,
        margin3=0.1, scale=8.0, group=group, return_softmax=True)
    loss.backward()
    out.update(loss=loss.detach(), softmax=soft, grad=logits.grad)


SUITES = {"syncbn": syncbn, "margin": margin}


def main(suite, d):
    torch.set_num_threads(1)
    d = Path(d)
    env = tdist.init_parallel_env(device="cpu")
    out = {"rank": env.rank, "world": env.world_size}
    try:
        SUITES[suite](env.rank, dict(np.load(d / "inputs.npz")), out)
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, d / f"rank{env.rank}.pt")
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
