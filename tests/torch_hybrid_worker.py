"""One gloo rank of the hybrid-parallel parity files
(``tests/test_torch_tensor_parallel.py``, ``test_torch_zero.py``,
``test_torch_sequence_parallel.py``).

    PADDLE_TRAINERS_NUM=<n> PADDLE_TRAINER_ID=<rank> \\
    PADDLE_TRAINER_ENDPOINTS=127.0.0.1:<port> \\
        python tests/torch_hybrid_worker.py <suite> <dir>

Joins the group through ``paddle_tpu_torch.distributed.init_parallel_env(
device="cpu")``, reads ``<dir>/inputs.npz`` (the logical weights and the
inputs the test wrote) and runs the suite's checks on this rank:

* ``tp`` (4 ranks, ``fleet.init`` at dp 2 x mp 2): each mp layer's forward
  and backward on its shard, the vocab-parallel fused CE, the eager loop
  with the group-aware global-norm clip and with each norm-based rule
  (``ClipGradByNorm``, ``Lamb``, ``LarsMomentum``), ``HybridParallelEngine`` on tiny
  GPT, a tiny Llama's gradients, and a GPT built at mp = 2 from a seed;
* ``zero`` (2 ranks): the ZeRO-1 sharded weight update at dp = 2 (plain,
  and quantized with error feedback), then ``fleet.init`` at sharding 2 and
  ZeRO stage 1 and ``os_g`` through the engine;
* ``sp`` (2 ranks, ``fleet.init`` at sp 2): ring and Ulysses attention on
  this rank's sequence shard, the chunked-Q ring, and tiny GPT with
  ``sequence_parallel=True, attention_impl="ring"`` through the engine
  (also on padded labels, with its ``eval_step``).

Writes what it got to ``<dir>/rank<r>.pt``. Imports torch, numpy and
``paddle_tpu_torch`` only.
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
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp  # noqa: E402
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    sequence_parallel as tsp  # noqa: E402
from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import \
    shard_of  # noqa: E402
from paddle_tpu_torch.framework import flags  # noqa: E402
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,  # noqa: E402
                                     LlamaConfig, LlamaForCausalLM,
                                     load_reference_state_dict)
from paddle_tpu_torch.nn import Layer, Linear  # noqa: E402
from paddle_tpu_torch.ops.fused_ce import \
    fused_linear_cross_entropy  # noqa: E402

# name -> (constructor, input's layout, output's layout), as in the test
MP_LAYERS = {
    "column_gather": (lambda: tmp.ColumnParallelLinear(
        6, 10, has_bias=True, gather_output=True, device="cpu"),
        "replicated", "replicated"),
    "column_local": (lambda: tmp.ColumnParallelLinear(
        6, 10, has_bias=True, gather_output=False, device="cpu"),
        "replicated", "cols"),
    "row_parallel_in": (lambda: tmp.RowParallelLinear(
        10, 6, has_bias=True, input_is_parallel=True, device="cpu"),
        "cols", "replicated"),
    "row_split": (lambda: tmp.RowParallelLinear(
        10, 6, has_bias=False, input_is_parallel=False, device="cpu"),
        "replicated", "replicated"),
    "vocab_embedding": (lambda: tmp.VocabParallelEmbedding(
        50, 8, device="cpu"), "replicated", "replicated"),
}


def strategy(**degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = dict(s.hybrid_configs, **degrees)
    return s


def prefixed(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}


def state_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def gpt_model(inp, mp_rank=0, mp=1, **cfg):
    c = dict(json.loads(str(inp["gpt_config"])), **cfg)
    m = GPTForPretraining(GPTConfig(**c), device="cpu").train()
    load_reference_state_dict(m, prefixed(inp, "gpt."), mp_rank, mp)
    return m


def dp_half(a, dp_rank, dp=2):
    n = a.shape[0] // dp
    return torch.from_numpy(a[dp_rank * n:(dp_rank + 1) * n])


# -- tp: dp 2 x mp 2 --------------------------------------------------------
def tp_layers(mp_r, inp, out):
    res = {}
    for name, (make, x_layout, y_layout) in MP_LAYERS.items():
        layer = make()
        load_reference_state_dict(layer, prefixed(inp, f"layer.{name}.p."),
                                  mp_r, 2)
        x = torch.from_numpy(inp[f"layer.{name}.x"])
        if x.is_floating_point():
            x = shard_of(x, x_layout, mp_r, 2).clone().requires_grad_()
        y = layer(x)
        cot = shard_of(torch.from_numpy(inp[f"layer.{name}.cot"]), y_layout,
                       mp_r, 2)
        (y * cot).sum().backward()
        res[name] = {"y": y.detach(),
                     "dx": x.grad if x.is_floating_point() else None,
                     "grads": {n: p.grad.clone()
                               for n, p in layer.named_parameters()},
                     "distributed": sorted(
                         n for n, p in layer.named_parameters()
                         if getattr(p, "mp_distributed", False))}
    out["layers"] = res


def tp_fused_ce(mp_r, hcg, inp, out):
    x = torch.from_numpy(inp["ce.x"]).requires_grad_()
    w = shard_of(torch.from_numpy(inp["ce.w"]), "rows", mp_r,
                 2).clone().requires_grad_()
    labels = torch.from_numpy(inp["ce.labels"])
    loss = fused_linear_cross_entropy(x, w, labels, block_rows=8,
                                      group=hcg.get_model_parallel_group())
    loss.backward()
    out["ce"] = {"loss": loss.detach(), "dx": x.grad, "dw": w.grad}


def tp_eager_clip(mp_r, dp_r, inp, out):
    """2 eager SGD steps with ClipGradByGlobalNorm(0.5) through
    fleet.distributed_model/distributed_optimizer, on this dp rank's half."""
    m = gpt_model(inp, mp_r, 2)
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        0.1, parameters=m.parameters(),
        grad_clip=pt.nn.ClipGradByGlobalNorm(0.5)))
    ids = dp_half(inp["gpt_ids"], dp_r)
    labels = dp_half(inp["gpt_labels"], dp_r)
    losses = []
    for _ in range(2):
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
    out["eager"] = {"losses": torch.stack(losses), "state": state_of(m),
                    "wrapper": type(model).__name__,
                    "optimizer": type(opt).__name__}


# the norm-based rules, each held to the reference's single-device eager
# loop (as in the test)
EAGER_RULES = {
    "by_norm": lambda ps: pt.optimizer.SGD(
        1.0, parameters=ps, grad_clip=pt.nn.ClipGradByNorm(0.05)),
    "lamb": lambda ps: pt.optimizer.Lamb(0.1, epsilon=1e-3, parameters=ps),
    "lars": lambda ps: pt.optimizer.LarsMomentum(
        1.0, lars_coeff=0.1, parameters=ps),
}


def tp_eager_rules(mp_r, dp_r, inp, out):
    """2 eager steps of each norm-based rule at dp 2 x mp 2: the sharded
    parameters' norms are the logical ones."""
    ids = dp_half(inp["gpt_ids"], dp_r)
    labels = dp_half(inp["gpt_labels"], dp_r)
    res = {}
    for name, make in EAGER_RULES.items():
        m = gpt_model(inp, mp_r, 2)
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(make(m.parameters()))
        for _ in range(2):
            model.loss(ids, labels).backward()
            opt.step()
            opt.clear_grad()
        res[name] = state_of(m)
    out["eager_rules"] = res


def tp_engine(mp_r, dp_r, hcg, inp, out):
    m = gpt_model(inp, mp_r, 2)
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        0.1, parameters=m.parameters()))
    eng = tdist.HybridParallelEngine(model, opt,
                                     lambda mm, i, l: mm.loss(i, l),
                                     mesh=hcg.mesh)
    ids = dp_half(inp["gpt_ids"], dp_r)
    labels = dp_half(inp["gpt_labels"], dp_r)
    losses = [eng.train_step(ids, labels)]
    after1 = state_of(m)
    losses += [eng.train_step(ids, labels) for _ in range(2)]
    out["engine"] = {"losses": torch.stack(losses), "state1": after1,
                     "state3": state_of(m), "wus": eng._wus is not None,
                     "dp_buckets": pt.profiler.counters().get(
                         "dp_all_reduces", 0)}


def tp_llama(mp_r, inp, out):
    cfg = LlamaConfig(**json.loads(str(inp["llama_config"])))
    m = LlamaForCausalLM(cfg, device="cpu")
    load_reference_state_dict(m, prefixed(inp, "llama."), mp_r, 2)
    loss = m.loss(torch.from_numpy(inp["llama_ids"]),
                  torch.from_numpy(inp["llama_labels"]))
    loss.backward()
    out["llama"] = {"loss": loss.detach(),
                    "grads": {n: p.grad.clone()
                              for n, p in m.named_parameters()}}


def tp_suite(rank, inp, out):
    fleet.init(is_collective=True, strategy=strategy(dp_degree=2,
                                                      mp_degree=2))
    hcg = fleet.get_hybrid_communicate_group()
    mp_r, dp_r = hcg.get_model_parallel_rank(), hcg.get_data_parallel_rank()
    out["hcg"] = {
        "dp_rank": dp_r, "mp_rank": mp_r,
        "degrees": [hcg.get_data_parallel_world_size(),
                    hcg.get_model_parallel_world_size(),
                    hcg.get_sharding_parallel_world_size(),
                    hcg.get_sequence_parallel_world_size(),
                    hcg.get_pipe_parallel_world_size()],
        "mp_ranks": hcg.get_model_parallel_group().ranks,
        "dp_ranks": hcg.get_data_parallel_group().ranks,
        "dp_sp_ranks": hcg.get_dp_sp_parallel_group().ranks,
        "mesh": dict(hcg.mesh.shape)}
    tp_layers(mp_r, inp, out)
    tp_fused_ce(mp_r, hcg, inp, out)
    tp_eager_clip(mp_r, dp_r, inp, out)
    tp_eager_rules(mp_r, dp_r, inp, out)
    tp_engine(mp_r, dp_r, hcg, inp, out)
    tp_llama(mp_r, inp, out)
    # a model built at mp = 2 from a seed holds the mp = 1 model's slices
    out["init"] = state_of(GPTForPretraining(
        GPTConfig(**json.loads(str(inp["gpt_config"]))), device="cpu",
        seed=11))


# -- zero: dp 2, then sharding 2 --------------------------------------------
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


def opt_state(opt):
    """The base optimizer's state, one dict a parameter (list order)."""
    base = opt
    while "inner" in base.__dict__ or "_inner_opt" in base.__dict__:
        base = base.__dict__.get("inner") or base.__dict__["_inner_opt"]
    sd = opt.state_dict()
    return [{k[len(n) + 1:]: v.detach().clone() for k, v in sd.items()
             if isinstance(k, str) and k.startswith(n + ".")}
            for n in base._names]


def mlp(inp):
    m = MLP()
    load_reference_state_dict(m, prefixed(inp, "mlp."))
    return m


def zero_wus(rank, inp, out):
    x, y = dp_half(inp["mlp_x"], rank), dp_half(inp["mlp_y"], rank)
    for tag, quant in (("plain", False), ("quantized", True)):
        flags.set_flags({"FLAGS_shard_weight_update": True,
                         "FLAGS_quantized_allreduce": quant,
                         "FLAGS_quantized_allreduce_error_feedback": quant})
        m = mlp(inp)
        opt = pt.optimizer.AdamW(0.01, parameters=m.parameters())
        eng = tdist.HybridParallelEngine(m, opt, mse,
                                         mesh=tdist.build_mesh(["dp"], [2]))
        losses = torch.stack([eng.train_step(x, y) for _ in range(3)])
        wus = eng._wus
        res = {"losses": losses, "built": wus is not None,
               "shard_bytes": wus.shard_bytes(),
               "padded": [b.padded for b in wus.plan.buckets],
               "itemsize": [b.itemsize for b in wus.plan.buckets],
               "keys": len(wus.state[0]),
               "base_accums_before_sync": len(opt._accumulators)}
        eng.sync_optimizer_state()
        res["params"] = state_of(m)
        res["opt"] = opt_state(opt)
        out[f"wus_{tag}"] = res
    flags.set_flags({"FLAGS_quantized_allreduce": False,
                     "FLAGS_quantized_allreduce_error_feedback": False})


def zero_sharding(rank, inp, out):
    fleet.init(is_collective=True, strategy=strategy(sharding_degree=2))
    hcg = fleet.get_hybrid_communicate_group()
    x, y = torch.from_numpy(inp["mlp_x"]), torch.from_numpy(inp["mlp_y"])
    for level in ("os", "os_g", "fleet"):
        m = mlp(inp)
        adam = pt.optimizer.Adam(0.01, parameters=m.parameters())
        if level == "fleet":
            model, opt = m, fleet.distributed_optimizer(adam)
        else:
            model, opt, _ = tmp.group_sharded_parallel(m, adam, level)
        eng = tdist.HybridParallelEngine(model, opt, mse, mesh=hcg.mesh)
        losses = torch.stack([eng.train_step(x, y) for _ in range(3)])
        local = {k: tuple(v.shape) for st in adam._accumulators.values()
                 for k, v in st.items()}
        out[f"stage_{level}"] = {
            "losses": losses, "params": state_of(m), "opt": opt_state(opt),
            "local_shapes": [{k: tuple(v.shape) for k, v in st.items()}
                             for st in (adam._accumulators[n]
                                        for n in adam._names)],
            "n_local": len(local), "wrapper": type(model).__name__}


def zero_suite(rank, inp, out):
    zero_wus(rank, inp, out)
    zero_sharding(rank, inp, out)


# -- sp: sequence 2 ----------------------------------------------------------
def sp_attention(rank, group, inp, out):
    for name in ("ring_causal", "ring_full", "ulysses_causal",
                 "ulysses_full", "ring_chunked"):
        fn = tsp.ring_attention if name.startswith("ring") \
            else tsp.ulysses_attention
        causal = not name.endswith("full")
        qkv = [tsp.split_sequence(torch.from_numpy(inp[f"{name}.{t}"]),
                                  group).clone().requires_grad_()
               for t in "qkv"]
        o = fn(*qkv, group, causal=causal)
        (o ** 2).sum().backward()
        out[name] = {"o": o.detach(), "dq": qkv[0].grad, "dk": qkv[1].grad,
                     "dv": qkv[2].grad}


def sp_gpt(rank, hcg, inp, out):
    m = gpt_model(inp, sequence_parallel=True, attention_impl="ring")
    ids = torch.from_numpy(inp["gpt_ids"])
    labels = torch.from_numpy(inp["gpt_labels"])
    # this rank's tokens sit at their global positions
    T = ids.shape[1] // 2
    local = ids[:, rank * T:(rank + 1) * T]
    emb = m.gpt.embeddings
    want = emb.word_embeddings.weight[local] \
        + emb.position_embeddings.weight[rank * T:(rank + 1) * T][None]
    out["positions_global"] = bool(torch.equal(emb(local).detach(),
                                               want.detach()))
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        0.01, parameters=m.parameters()))
    eng = tdist.HybridParallelEngine(m, opt, lambda mm, i, l: mm.loss(i, l),
                                     mesh=hcg.mesh)
    losses = torch.stack([eng.train_step(ids, labels) for _ in range(3)])
    out["gpt"] = {"losses": losses, "state": state_of(m),
                  "ring": m.gpt.layers[0].attn._ring_group() is not None}


def sp_gpt_padded(hcg, inp, out):
    """Tiny GPT at sp 2 on labels whose padding (ignore_index) falls mostly
    on rank 1's tokens: 3 engine steps, then ``eval_step``'s loss."""
    m = gpt_model(inp, sequence_parallel=True, attention_impl="ring")
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        0.1, parameters=m.parameters()))
    eng = tdist.HybridParallelEngine(m, opt, lambda mm, i, l: mm.loss(i, l),
                                     mesh=hcg.mesh)
    ids = torch.from_numpy(inp["gpt_ids"])
    labels = torch.from_numpy(inp["gpt_labels_pad"])
    losses = torch.stack([eng.train_step(ids, labels) for _ in range(3)])
    out["gpt_pad"] = {
        "losses": losses, "state": state_of(m),
        "eval": eng.eval_step(lambda mm, i, l: mm.loss(i, l), ids, labels)}


def sp_suite(rank, inp, out):
    from paddle_tpu_torch.distributed.collective import _ring_shift

    fleet.init(is_collective=True, strategy=strategy(sp_degree=2))
    hcg = fleet.get_hybrid_communicate_group()
    group = hcg.get_sequence_parallel_group()
    out["sp_ranks"] = group.ranks
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = _ring_shift(x, group)
    (y * (rank + 1)).sum().backward()
    out["ring_shift"] = [y.detach(), x.grad]
    sp_attention(rank, group, inp, out)
    sp_gpt(rank, hcg, inp, out)
    sp_gpt_padded(hcg, inp, out)


SUITES = {"tp": tp_suite, "zero": zero_suite, "sp": sp_suite}


def main(suite, d):
    torch.set_num_threads(1)
    d = Path(d)
    env = tdist.init_parallel_env(device="cpu")
    rank = env.rank
    out = {"rank": rank, "world": env.world_size}
    try:
        inp = dict(np.load(d / "inputs.npz"))
        SUITES[suite](rank, inp, out)
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, d / f"rank{rank}.pt")
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
