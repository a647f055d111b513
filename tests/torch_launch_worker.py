"""The worker of ``tests/test_torch_launch.py``: a tiny data-parallel
training run that checkpoints, drains on SIGTERM and resumes.

As ``spawn``'s function (``train(out_dir)``) or as ``launch``'s script
(``python tests/torch_launch_worker.py <out_dir>``): joins the world with
``init_parallel_env()`` (gloo: the launcher sets
``PADDLE_DISTRI_BACKEND=gloo``), resumes ``{"model", "opt"}`` from this
rank's ``AutoCheckpoint`` under ``<out_dir>``, and trains a ``Linear(4,
2)`` by SGD on seeded batches for ``STEPS`` steps, the gradients averaged
over the world, under a ``PreemptionGuard`` on that checkpoint. Each
step's loss goes to ``<out_dir>/losses_rank<r>.txt`` (``float.hex``); a
run that resumes first writes the phase of this rank's last watchdog
progress record (the drain's ``preempt_drain``) to
``<out_dir>/phases_rank<r>.txt``. ``PADDLE_FAULT_INJECT=preempt.sigterm:
step=K`` preempts every rank after step K (exit 75).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STEPS = 6


def train(out_dir):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import watchdog
    from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint
    from paddle_tpu_torch.fault.preemption import PreemptionGuard

    out = Path(out_dir)
    env = dist.init_parallel_env()
    rank = env.rank
    pdir = os.environ.get("PADDLE_TPU_PROGRESS_DIR")
    prev = Path(pdir) / f"rank_{rank}.json" if pdir else None
    pt.seed(0)  # the initializer draws from the port's generators
    model = pt.nn.Linear(4, 2, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    ck = AutoCheckpoint(str(out / f"ck_rank{rank}"), interval_steps=2,
                        keep_last=2)
    state = {"model": model, "opt": opt}
    start = max(ck.resume(state), 0) + 1
    if start > 1 and prev is not None and prev.exists():
        with open(out / f"phases_rank{rank}.txt", "a") as f:
            f.write(json.loads(prev.read_text()).get("phase", "") + "\n")
    with PreemptionGuard(checkpoint=ck) as guard:
        for step in range(start, STEPS + 1):
            rng = np.random.RandomState(step * 10 + rank)
            x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
            y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            for p in model.parameters():
                dist.all_reduce(p.grad, dist.ReduceOp.AVG)
            opt.step()
            opt.clear_grad()
            watchdog.publish(step=step, phase="train", force=True)
            with open(out / f"losses_rank{rank}.txt", "a") as f:
                f.write(float(loss.detach()).hex() + "\n")
            ck.maybe_save(step, state)
            guard.check(step, state)
    dist.destroy_process_group()


if __name__ == "__main__":
    train(sys.argv[1])
