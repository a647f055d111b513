"""One gloo rank of ``tests/test_torch_distributed.py``.

    PADDLE_TRAINERS_NUM=2 PADDLE_TRAINER_ID=<rank> \\
    PADDLE_TRAINER_ENDPOINTS=127.0.0.1:<port> \\
        python tests/torch_dist_worker.py <dir>

Joins the group through ``paddle_tpu_torch.distributed.init_parallel_env(
device="cpu")`` and runs every check of the file on this rank: the
collectives on inputs made from seeds, the quantized all-reduce-mean, the
model-parallel helpers over both ranks, ``DataParallel``'s eager loop and
``HybridParallelEngine`` at dp = 2 on this rank's half of the batch (with
the replicated update and with the ZeRO-1 sharded one; GPT also on padded
labels, with its ``eval_step``), with the weights the test wrote to
``<dir>/inputs.npz``. Writes what it got to
``<dir>/rank<r>.pt``. Imports torch, numpy and ``paddle_tpu_torch`` only.
"""
import json
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import collective as C  # noqa: E402
from paddle_tpu_torch.framework import flags  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,  # noqa: E402
                                     load_reference_state_dict)
from paddle_tpu_torch.nn import Layer, Linear  # noqa: E402

WORLD = 2


def x_of(rank, shape=(4, 6), seed=0):
    """Rank ``rank``'s input of a collective check."""
    return torch.from_numpy(np.random.RandomState(seed + 10 * rank)
                            .randn(*shape).astype(np.float32))


def collectives(rank, out):
    x = x_of(rank)
    for name, op in (("sum", C.ReduceOp.SUM), ("max", C.ReduceOp.MAX),
                     ("min", C.ReduceOp.MIN), ("prod", C.ReduceOp.PROD),
                     ("avg", C.ReduceOp.AVG)):
        out[f"all_reduce_{name}"] = C.all_reduce(x.clone(), op)
    lst = []
    C.all_gather(lst, x)
    out["all_gather_list"] = torch.stack(lst)
    out["all_gather_stacked"] = C.all_gather(None, x)
    out["all_gather_into_tensor_0"] = C.all_gather_into_tensor(None, x)
    out["all_gather_into_tensor_1"] = C.all_gather_into_tensor(
        None, x, concat_axis=1)
    r = x.clone()
    C.reduce(r, dst=1)
    out["reduce_dst1"] = r
    t = torch.zeros(2, 6)
    C.reduce_scatter(t, [x[:2].clone(), x[2:].clone()])
    out["reduce_scatter_list"] = t
    t = torch.zeros(2, 6)
    C.reduce_scatter(t, x.clone())
    out["reduce_scatter_tensor"] = t
    b = x.clone()
    C.broadcast(b, src=1)
    out["broadcast_src1"] = b
    s = torch.zeros(2, 6)
    C.scatter(s, [x[:2].clone(), x[2:].clone()], src=0)
    out["scatter_src0"] = s
    out["alltoall"] = torch.stack(C.alltoall([x[:2].clone(), x[2:].clone()]))
    out["alltoall_single"] = C.alltoall_single(x.clone())
    g = C.new_group([0, 1])
    out["group"] = torch.tensor([g.nranks, g.rank, C.get_group(g.id) is g,
                                 C.get_group(0).nranks])
    out["group_all_reduce"] = C.all_reduce(x.clone(), group=g)
    C.barrier()
    C.wait(x)
    out["split"] = torch.stack(C.split(x, 2, axis=1))
    raised = []
    for fn in (C.send, C.recv, C.isend, C.irecv):
        try:
            fn(x, 0)
        except NotImplementedError:
            raised.append(fn.__name__)
    out["p2p_raised"] = raised


def quantized(rank, out):
    flat = x_of(rank, (2 * 256,), seed=3).reshape(-1) * (1 + rank)
    mean, err = C.quantized_all_reduce_mean(flat, None, WORLD, 128)
    out["quant_mean"], out["quant_err"] = mean, err


def mp_helpers(rank, out):
    """The Megatron pairs over both ranks, each on the full weight's shard
    of this rank: the forward and the input/weight gradients."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    g = C.get_group(0)
    # column-parallel: identity in, this rank's columns, gather out
    xc = x.clone().requires_grad_()
    wc = w[:, rank * 3:(rank + 1) * 3].clone().requires_grad_()
    y = C._c_concat(C._c_identity(xc, g) @ wc, g)
    (y * torch.arange(6.0)).sum().backward()
    out["col_y"], out["col_dx"], out["col_dw"] = y.detach(), xc.grad, wc.grad
    # row-parallel: split in, this rank's rows, all-reduce out
    xr = x.clone().requires_grad_()
    wr = w[rank * 4:(rank + 1) * 4].clone().requires_grad_()
    y = C._mp_allreduce(C._c_split(xr, g) @ wr, g)
    (y * torch.arange(6.0)).sum().backward()
    out["row_y"], out["row_dx"], out["row_dw"] = y.detach(), xr.grad, wr.grad
    # vocab-sharded cross-entropy: this rank's half of the classes
    logits = torch.from_numpy(rng.randn(5, 10).astype(np.float32))
    labels = torch.from_numpy(np.array([0, 9, 4, 5, -100], np.int64))
    lg = logits[:, rank * 5:(rank + 1) * 5].clone().requires_grad_()
    loss = C._c_softmax_with_cross_entropy(lg, labels, g)
    (loss * torch.arange(1.0, 6.0)).sum().backward()
    out["ce_loss"], out["ce_dlogits"] = loss.detach(), lg.grad


class MLP(Layer):
    """The reference's ``nn.Sequential(Linear(8, 16), Tanh(),
    Linear(16, 4))``, its parameters named as there."""

    def __init__(self):
        super().__init__()
        self.add_sublayer("0", Linear(8, 16, device="cpu"))
        self.add_sublayer("2", Linear(16, 4, device="cpu"))

    def forward(self, x):
        return getattr(self, "2")(torch.tanh(getattr(self, "0")(x)))


def mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def half(a, rank):
    n = a.shape[0] // WORLD
    return torch.from_numpy(a[rank * n:(rank + 1) * n])


def data_parallel(rank, inp, out):
    """The eager loop through ``DataParallel`` and the engine at dp = 2, 3
    SGD steps each on this rank's half of the batch."""
    state = {k[4:]: inp[k] for k in inp.files if k.startswith("mlp.")}
    x, y = half(inp["mlp_x"], rank), half(inp["mlp_y"], rank)
    m = MLP()
    load_reference_state_dict(m, state)
    dp = pt.DataParallel(m)
    opt = pt.optimizer.SGD(0.1, parameters=dp.parameters())
    for _ in range(3):
        loss = mse(dp, x, y)
        loss.backward()
        dp.apply_collective_grads()
        opt.step()
        opt.clear_grad()
    out["dp_state"] = {k: v.detach().clone()
                       for k, v in dp.state_dict().items()}
    for acc in (1, 2):
        m = MLP()
        load_reference_state_dict(m, state)
        opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
        eng = tdist.HybridParallelEngine(m, opt, mse,
                                         mesh=tdist.build_mesh(["dp"], [2]),
                                         grad_accumulate=acc)
        out[f"mlp_engine_losses_{acc}"] = torch.stack(
            [eng.train_step(x, y) for _ in range(3)])
        out[f"mlp_engine_state_{acc}"] = {
            k: v.detach().clone() for k, v in m.state_dict().items()}


def gpt_engine(rank, inp, out):
    cfg = json.loads(str(inp["gpt_config"]))
    state = {k[4:]: inp[k] for k in inp.files if k.startswith("gpt.")}
    m = GPTForPretraining(GPTConfig(**cfg), device="cpu").train()
    load_reference_state_dict(m, state)
    opt = pt.optimizer.SGD(0.01, parameters=m.parameters())
    eng = tdist.HybridParallelEngine(
        pt.DataParallel(m), opt, lambda d, i, l: d._layers.loss(i, l))
    ids, labels = half(inp["gpt_ids"], rank), half(inp["gpt_labels"], rank)
    out["gpt_loss"] = eng.train_step(ids, labels)
    out["gpt_wte"] = m.gpt.embeddings.word_embeddings.weight.detach().clone()
    out["dp_buckets"] = pt.profiler.counters().get("dp_all_reduces", 0)


def gpt_engine_padded(rank, inp, out):
    """The engine at dp = 2 on labels whose padding (ignore_index) falls
    mostly on rank 1's half: 2 SGD steps, then ``eval_step``'s loss."""
    cfg = json.loads(str(inp["gpt_config"]))
    state = {k[4:]: inp[k] for k in inp.files if k.startswith("gpt.")}
    m = GPTForPretraining(GPTConfig(**cfg), device="cpu").train()
    load_reference_state_dict(m, state)
    eng = tdist.HybridParallelEngine(
        m, pt.optimizer.SGD(0.1, parameters=m.parameters()),
        lambda mm, i, l: mm.loss(i, l))
    ids = half(inp["gpt_ids"], rank)
    labels = half(inp["gpt_labels_pad"], rank)
    losses = torch.stack([eng.train_step(ids, labels) for _ in range(2)])
    out["gpt_pad"] = {
        "losses": losses,
        "eval": eng.eval_step(lambda mm, i, l: mm.loss(i, l), ids, labels),
        "state": {k: v.detach().clone() for k, v in m.state_dict().items()}}


def zero_update(rank, inp, out):
    """The engine at dp = 2 with FLAGS_shard_weight_update on: the ZeRO-1
    sharded update, 3 SGD steps on this rank's half of the batch."""
    state = {k[4:]: inp[k] for k in inp.files if k.startswith("mlp.")}
    x, y = half(inp["mlp_x"], rank), half(inp["mlp_y"], rank)
    flags.set_flags({"FLAGS_shard_weight_update": True})
    try:
        m = MLP()
        load_reference_state_dict(m, state)
        eng = tdist.HybridParallelEngine(
            m, pt.optimizer.SGD(0.1, parameters=m.parameters()), mse,
            mesh=tdist.build_mesh(["dp"], [2]))
        out["zero_built"] = [eng._wus is not None,
                             eng._wus.nranks if eng._wus else 0]
        out["zero_losses"] = torch.stack([eng.train_step(x, y)
                                          for _ in range(3)])
        out["zero_state"] = {k: v.detach().clone()
                             for k, v in m.state_dict().items()}
    finally:
        flags.set_flags({"FLAGS_shard_weight_update": False})


def main(d):
    torch.set_num_threads(1)
    d = Path(d)
    env = tdist.init_parallel_env(device="cpu")
    rank = env.rank
    out = {"rank": rank, "world": env.world_size}
    try:
        inp = np.load(d / "inputs.npz")
        flags.set_flags({"FLAGS_shard_weight_update": False})
        collectives(rank, out)
        quantized(rank, out)
        mp_helpers(rank, out)
        data_parallel(rank, inp, out)
        gpt_engine(rank, inp, out)
        gpt_engine_padded(rank, inp, out)
        zero_update(rank, inp, out)
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, d / f"rank{rank}.pt")
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
