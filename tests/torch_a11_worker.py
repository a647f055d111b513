"""One gloo rank of the auto-parallel, sharding-API and coordinated
checkpoint parity files (``tests/test_torch_auto_parallel.py``,
``test_torch_sharding_api.py``, ``test_torch_checkpoint.py``).

    PADDLE_TRAINERS_NUM=<n> PADDLE_TRAINER_ID=<rank> \\
    PADDLE_TRAINER_ENDPOINTS=127.0.0.1:<port> \\
        python tests/torch_a11_worker.py <suite> <dir>

Joins the group through ``init_parallel_env(device="cpu")``, reads
``<dir>/inputs.npz`` and runs the suite on this rank:

* ``auto`` (2 ranks, ``fleet.init`` at mp 2): tiny GPT built at one rank
  and realised by ``auto_parallel.Engine.prepare`` (the Megatron plan)
  against the same GPT built at mp 2 from its mp layers: loss, gradients,
  the collectives each launched, 2 engine steps; then
  ``auto_parallelize``'s plans and winner; and the test's MLP (of mp
  layers, and of plain ``Linear``s) through ``auto_parallelize``, also
  under a memory budget between its plans' peaks, and realised by
  ``prepare``;
* ``prefetch`` (2 ranks, ``fleet.init`` at sp 2): ``engine.prefetch``
  cuts each rank's tokens once (``prefetch_suite``);
* ``shard`` (2 or 4 ranks): ``shard_tensor`` and ``reshard`` over each
  case of ``SHARD_CASES``: the shards, the round trip and the gradient;
* ``ckpt`` (2 ranks): ``CoordinatedCheckpoint`` over a ``FileStore`` at
  each crash point of ``CRASH_POINTS`` on each rank: 3 clean saves, the
  crashing 4th, then a resume (see ``ckpt_scenario``).

Writes what it got to ``<dir>/rank<r>.pt``. Imports torch, numpy and
``paddle_tpu_torch`` only.
"""
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import distributed as tdist  # noqa: E402
from paddle_tpu_torch.distributed import collective as C  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402

# (world, mesh axes, mesh shape, [(src placement, dst placement), ...]):
# the test computes the reference's shards from the same table
SHARD_CASES = [
    (2, ("x",), (2,), [
        ((None, None), ("x", None)),
        (("x", None), (None, "x")),
        ((None, "x"), (None, None)),
        (("x", None), ("x", None)),
    ]),
    (4, ("dp", "mp"), (2, 2), [
        ((None, None), (("dp", "mp"), None)),
        (("dp", None), (None, "dp")),
        (("dp", "mp"), ("mp", "dp")),
        ((("dp", "mp"), None), (None, None)),
        (("mp", None), (None, ("dp", "mp"))),
    ]),
]
SHARD_SHAPE = (8, 12)

CRASH_POINTS = ("ckpt.write", "ckpt.serialize", "ckpt.ack", "ckpt.commit")
CLEAN_TIMEOUT_S = 60.0  # a deadline whose event comes
NEVER_TIMEOUT_S = 0.5   # a deadline whose event the crash rules out


def prefixed(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}


# -- auto: mp 2 ---------------------------------------------------------------
def mlp(inp, mp_layers):
    """The test's ``fc1 -> gelu -> fc2`` on the reference's weights, of the
    mp layers (a column/row pair at one rank) or of plain ``Linear``s."""
    from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
    from paddle_tpu_torch.models import load_reference_state_dict
    from paddle_tpu_torch.nn import Layer, Linear
    from paddle_tpu_torch.nn import functional as F

    h, ff = inp["mlp.fc1.weight"].shape

    class MLP(Layer):
        def __init__(self):
            super().__init__()
            if mp_layers:
                self.fc1 = tmp.ColumnParallelLinear(
                    h, ff, has_bias=True, gather_output=False, device="cpu")
                self.fc2 = tmp.RowParallelLinear(
                    ff, h, has_bias=True, input_is_parallel=True,
                    device="cpu")
            else:
                self.fc1 = Linear(h, ff, device="cpu")
                self.fc2 = Linear(ff, h, device="cpu")

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    m = MLP()
    load_reference_state_dict(m, prefixed(inp, "mlp."), 0, 1)
    return m


def mse(out, y):
    return ((out - y) ** 2).mean()


def mlp_suite(models, hcg, inp, out):
    """Each MLP through ``auto_parallelize`` (and under a budget between
    the plans' peaks), then realised by ``prepare`` (the Megatron plan):
    one loss, its gradients and the collectives it launched."""
    from paddle_tpu_torch.distributed import auto_parallel

    x, y = torch.from_numpy(inp["mlp_x"]), torch.from_numpy(inp["mlp_y"])

    def engine(m):
        return auto_parallel.Engine(
            m, loss=mse, mesh=hcg.mesh,
            optimizer=pt.optimizer.SGD(learning_rate=0.1,
                                       parameters=m.parameters()))

    for name, (m_sel, m_bud, m_fn) in models.items():
        sel = engine(m_sel)
        best = sel.auto_parallelize(x, y)
        peaks = [p.report["peak_memory_bytes"] for p in sel.plans]
        budget = (min(peaks) + max(peaks)) // 2
        bud = engine(m_bud)
        chosen = bud.auto_parallelize(x, y, memory_budget=budget)
        fn = engine(m_fn).prepare()
        with C.record() as log:
            loss = fn._engine.loss_fn(fn.model, x, y)
            loss.backward()
        out[f"mlp_{name}"] = {
            "winner": best.name,
            "plans": [(p.name, p.score, p.report) for p in sel.plans],
            "budget": budget, "chosen": chosen.name,
            "scores": {p.name: p.score for p in bud.plans},
            "kinds": kinds(log), "loss": loss.detach(),
            "grads": {n: p.grad.clone() for n, p in m_fn.named_parameters()}}


def gpt_cfg(inp):
    from paddle_tpu_torch.models import GPTConfig

    return GPTConfig(**json.loads(str(inp["gpt_config"])))


def plain_gpt(inp):
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         load_reference_state_dict)

    m = GPTForPretraining(gpt_cfg(inp), device="cpu").train()
    load_reference_state_dict(m, prefixed(inp, "gpt."), 0, 1)
    return m


def head_loss(m):
    """The tied head's fused CE on the GPT body's output, vocab-parallel
    when the table is (what ``GPTForPretraining.loss`` computes)."""
    from paddle_tpu_torch.nn import functional as F

    emb = m.gpt.embeddings.word_embeddings

    def loss(x, labels):
        return F.fused_linear_cross_entropy(
            x, emb.weight, labels,
            group=emb.group if emb.world_size > 1 else None)
    return loss


def kinds(log):
    out = {}
    for kind, _ in log:
        out[kind] = out.get(kind, 0) + 1
    return out


def auto_engine(m, hcg):
    from paddle_tpu_torch.distributed import auto_parallel

    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=m.gpt.parameters())
    return auto_parallel.Engine(m.gpt, loss=head_loss(m), optimizer=opt,
                                mesh=hcg.mesh)


def auto_suite(rank, inp, out):
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.models import (GPTForPretraining,
                                         load_reference_state_dict)

    # the plain models are built before the topology: their mp layers hold
    # one rank (the model auto_parallel realises)
    m_auto, m_sel = plain_gpt(inp), plain_gpt(inp)
    mlps = {k: tuple(mlp(inp, k == "mp_layers") for _ in range(3))
            for k in ("mp_layers", "linear")}
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, mp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    mp_r = hcg.get_model_parallel_rank()
    hand = GPTForPretraining(gpt_cfg(inp), device="cpu").train()
    load_reference_state_dict(hand, prefixed(inp, "gpt."), mp_r, 2)
    ids = torch.from_numpy(inp["ids"])
    labels = torch.from_numpy(inp["labels"])

    with C.record() as log_h:
        loss_h = hand.loss(ids, labels)
        loss_h.backward()
    eng = auto_engine(m_auto, hcg)
    eng.prepare()
    with C.record() as log_a:
        loss_a = eng._engine.loss_fn(eng.model, ids, labels)
        loss_a.backward()
    out["mp_rank"] = mp_r
    out["loss"] = (loss_h.detach(), loss_a.detach())
    out["grads"] = {n: (p.grad.clone(),
                        dict(m_auto.named_parameters())[n].grad.clone())
                    for n, p in hand.named_parameters()}
    out["shapes"] = {n: (tuple(p.shape),
                         tuple(dict(m_auto.named_parameters())[n].shape))
                     for n, p in hand.named_parameters()}
    out["kinds"] = (kinds(log_h), kinds(log_a))
    out["specs"] = {n: getattr(p, "pspec", None)
                    for n, p in m_auto.gpt.named_parameters()}
    hand_eng = HybridParallelEngine(
        hand, pt.optimizer.SGD(learning_rate=0.1,
                               parameters=hand.parameters()),
        lambda m, i, l: m.loss(i, l), mesh=hcg.mesh)
    out["steps"] = ([float(hand_eng.train_step(ids, labels))
                     for _ in range(2)],
                    eng.fit([(ids, labels)] * 2))

    sel = auto_engine(m_sel, hcg)
    best = sel.auto_parallelize(ids, labels)
    out["plans"] = [(p.name, p.score, p.report) for p in sel.plans]
    out["winner"] = best.name
    mlp_suite(mlps, hcg, inp, out)


# -- prefetch: the engine's batch layout at sp 2 -------------------------------
def prefetch_suite(rank, inp, out):
    """Tiny GPT with sequence parallelism at sp 2: ``engine.prefetch`` of
    the global batch hands each rank its T/2 tokens (cut before the copy,
    not again in the step): the batch, and ``eval_step`` and one SGD step
    on it against the same engine fed the global batch."""
    from paddle_tpu_torch.distributed import HybridParallelEngine

    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, sp_degree=2)
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    ids = torch.from_numpy(inp["ids"])
    labels = torch.from_numpy(inp["labels"])
    res = {}
    for how in ("prefetch", "direct"):
        m = plain_gpt(inp)
        m.config.sequence_parallel = True
        for mod in m.modules():
            if hasattr(mod, "sequence_parallel"):
                mod.sequence_parallel = True
        eng = HybridParallelEngine(
            m, pt.optimizer.SGD(learning_rate=0.1,
                                parameters=m.parameters()),
            lambda mm, i, l: mm.loss(i, l), mesh=hcg.mesh)
        batch = (ids, labels)
        if how == "prefetch":
            batch = next(iter(eng.prefetch([batch])))
            res["batch"] = [(tuple(b.shape), b.placement, b.clone())
                            for b in batch]
        res[how] = (float(eng.eval_step(lambda mm, i, l: mm.loss(i, l),
                                        *batch)),
                    float(eng.train_step(*batch)))
    out["sp_rank"] = hcg.get_sequence_parallel_rank()
    out["prefetch"] = res


# -- shard: shard_tensor / reshard -------------------------------------------
def shard_suite(rank, world, inp, out):
    from paddle_tpu_torch.distributed.mesh import Mesh
    from paddle_tpu_torch.distributed.sharding_api import (reshard,
                                                           shard_tensor)

    x = torch.from_numpy(inp["x"])
    g = torch.from_numpy(inp["g"])
    res = []
    for n, axes, shape, cases in SHARD_CASES:
        if n != world:
            continue
        mesh = Mesh(np.arange(n).reshape(shape), axes)
        for src, dst in cases:
            s = shard_tensor(x, mesh, src)
            y = reshard(s, dst)
            back = reshard(y, src)
            leaf = s.detach().clone().requires_grad_()
            leaf.placement, leaf.mesh = s.placement, mesh
            yg = reshard(leaf, dst)
            yg.backward(shard_tensor(g, mesh, dst).contiguous())
            res.append({"src": s.detach().clone(), "dst": y.detach().clone(),
                        "back": back.detach().clone(),
                        "grad": leaf.grad.clone(),
                        "placement": tuple(y.placement),
                        "logical": tuple(y.logical_shape)})
    out["cases"] = res


# -- ckpt: CoordinatedCheckpoint at each crash point -------------------------
def ckpt_state(step, rank):
    """The state rank ``rank`` saves at ``step`` (the test builds the
    reference's from the same numbers)."""
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    return {"w": torch.from_numpy(base + 100.0 * rank + step),
            "b": torch.full((4,), 0.5 * step + rank, dtype=torch.bfloat16),
            "n": {"k": torch.tensor(step * 10 + rank, dtype=torch.int64)}}


def ckpt_zero():
    return {"w": torch.zeros(3, 4), "b": torch.zeros(4, dtype=torch.bfloat16),
            "n": {"k": torch.tensor(0, dtype=torch.int64)}}


def _rank0_entered(store):
    """Rank 0's ``CommitBarrier.reset`` (where it enters a save and clears
    the step's acks) also sets ``entered/<step>`` on the store, which the
    other rank waits for before it saves: the protocol erases an ack that
    lands before rank 0's reset (both packages; ROADMAP §C, C2), and the
    reference's oracle runs its rank threads in lockstep, joined after
    each save. Returns the undo."""
    from paddle_tpu_torch.distributed.coord import CommitBarrier

    reset = CommitBarrier.reset

    def reset_and_mark(self, tag):
        reset(self, tag)
        store.set(f"entered/{tag}", "1")

    CommitBarrier.reset = reset_and_mark
    return lambda: setattr(CommitBarrier, "reset", reset)


def ckpt_scenario(rank, d, point, crash_rank):
    """Saves at steps 1-3 (clean, keep_last 2), the save at step 4 with
    ``point`` armed on ``crash_rank`` (``from=1``: it defeats the write's
    retries), then a resume into a zeroed state. Returns the save results,
    the resumed step and state, and the step dirs left."""
    from paddle_tpu_torch.distributed.checkpoint import CoordinatedCheckpoint
    from paddle_tpu_torch.distributed.coord import FileStore, wait_for
    from paddle_tpu_torch.fault import inject

    store = FileStore(os.path.join(d, "store"))
    entered = _rank0_entered(store) if rank == 0 else None

    def ck(timeout):
        return CoordinatedCheckpoint(os.path.join(d, "ckpt"), world_size=2,
                                     rank=rank, store=store,
                                     interval_steps=1, keep_last=2,
                                     commit_timeout_s=timeout)

    def save(step, timeout):
        if rank != 0:  # the protocol's lockstep: rank 0 enters a save first
            wait_for(lambda: store.get(f"entered/{step}") is not None,
                     f"rank 0 entering step {step}", CLEAN_TIMEOUT_S)
        return ck(timeout).save_now(step, ckpt_state(step, rank))

    results = [save(s, CLEAN_TIMEOUT_S) for s in (1, 2, 3)]
    C.barrier()
    # the crash rules out the event every wait of this save waits for,
    # except a crash at the commit point on rank 1 (after its ack)
    timeout = CLEAN_TIMEOUT_S if (point, crash_rank) == ("ckpt.commit", 1) \
        else NEVER_TIMEOUT_S
    if rank == crash_rank:
        inject.arm(f"{point}:from=1")
    try:
        results.append(save(4, timeout))
    finally:
        inject.disarm()
        if entered is not None:
            entered()
    C.barrier()
    state = ckpt_zero()
    step = ck(CLEAN_TIMEOUT_S).resume(state)
    C.barrier()
    dirs = sorted(os.listdir(os.path.join(d, "ckpt")))
    C.barrier()
    return {"results": results, "step": step, "state": state, "dirs": dirs}


def ckpt_suite(rank, d, out):
    res = {}
    for point in CRASH_POINTS:
        for crash_rank in (0, 1):
            sub = os.path.join(d, f"{point}_{crash_rank}")
            if rank == 0:
                os.makedirs(sub, exist_ok=True)
            C.barrier()
            res[(point, crash_rank)] = ckpt_scenario(rank, sub, point,
                                                     crash_rank)
    out["ckpt"] = res


def main():
    suite, d = sys.argv[1], Path(sys.argv[2])
    env = tdist.init_parallel_env(device="cpu")
    rank = env.rank
    out = {}
    try:
        inp = dict(np.load(d / "inputs.npz")) \
            if (d / "inputs.npz").exists() else {}
        if suite == "auto":
            auto_suite(rank, inp, out)
        elif suite == "prefetch":
            prefetch_suite(rank, inp, out)
        elif suite == "shard":
            shard_suite(rank, env.world_size, inp, out)
        elif suite == "ckpt":
            ckpt_suite(rank, str(d), out)
        else:
            raise ValueError(f"unknown suite {suite!r}")
    except Exception:
        out = {"error": traceback.format_exc()}
    torch.save(out, d / f"rank{rank}.pt")
    tdist.destroy_process_group()


if __name__ == "__main__":
    main()
