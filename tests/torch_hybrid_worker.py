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


# -- pp: pipeline parallelism (4 ranks) -------------------------------------
V_PP, D_PP = 32, 64


class PPEmbed(Layer):
    def __init__(self):
        super().__init__()
        self.emb = pt.nn.Embedding(V_PP, D_PP, device="cpu")

    def forward(self, ids):
        return self.emb(ids)


class PPBlock(Layer):
    def __init__(self, d_in=D_PP, d_out=D_PP):
        super().__init__()
        self.fc = Linear(d_in, d_out, device="cpu")

    def forward(self, x):
        y = torch.tanh(self.fc(x))
        return x + y if y.shape == x.shape else y


class PPHead(Layer):
    def __init__(self, d_in=D_PP):
        super().__init__()
        self.proj = Linear(d_in, V_PP, device="cpu")

    def forward(self, x):
        return self.proj(x)


def pp_ce(logits, labels):
    return pt.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def ebh(n_stages, wide=False):
    """The reference test's Embed, 6 Blocks, Head; ``wide``: Embed, Block,
    a Block to 2D, a Head from 2D (its third stage changes the carrier)."""
    if wide:
        descs = [tmp.LayerDesc(PPEmbed), tmp.LayerDesc(PPBlock),
                 tmp.LayerDesc(PPBlock, D_PP, 2 * D_PP),
                 tmp.LayerDesc(PPHead, 2 * D_PP)]
    else:
        descs = [tmp.LayerDesc(PPEmbed)] + [tmp.LayerDesc(PPBlock)
                                            for _ in range(6)] \
            + [tmp.LayerDesc(PPHead)]
    return tmp.PipelineLayer(descs, num_stages=n_stages, loss_fn=pp_ce)


def tied_head(layer, x):
    """The embedding on ids, the tied LM head on activations (one function
    for both positions of the shared key)."""
    if not x.is_floating_point():
        return layer(x)
    return x @ layer.word_embeddings.weight.t()


def gpt_pipe(inp, n_stages):
    from paddle_tpu_torch.models.gpt import GPTDecoderLayer, GPTEmbeddings

    cfg = GPTConfig(**json.loads(str(inp["gpt_config"])))
    shared = lambda: tmp.SharedLayerDesc(  # noqa: E731
        "embed", GPTEmbeddings, tied_head, "word_embeddings.weight", cfg,
        device="cpu")
    descs = [shared()] + [tmp.LayerDesc(GPTDecoderLayer, cfg, device="cpu")
                          for _ in range(cfg.num_layers)] \
        + [tmp.LayerDesc(pt.nn.LayerNorm, cfg.hidden_size, epsilon=1e-5,
                         device="cpu"), shared()]
    return tmp.PipelineLayer(descs, num_stages=n_stages, loss_fn=pp_ce)


def pp_run(inp, tag, make, ids, labels, schedule, via_fleet=False):
    """3 SGD(0.05) steps of 4 micro-batches from the reference's weights."""
    from paddle_tpu_torch.models import pp_split_state_dict

    pl = make()
    load_reference_state_dict(pl, pp_split_state_dict(
        prefixed(inp, f"{tag}."), pl)[pl._stage_id])
    opt = pt.optimizer.SGD(0.05, parameters=pl.parameters())
    hcg = fleet.get_hybrid_communicate_group()
    if via_fleet:
        model = fleet.distributed_model(pl)
        losses = [model.train_batch((ids, labels), opt) for _ in range(3)]
        step = model._train_fn
    else:
        step = tmp.PipelineTrainStep(pl, opt, hcg.mesh, n_micro=4,
                                     schedule=schedule)
        losses = [step(ids, labels) for _ in range(3)]
    return {"losses": torch.stack(losses), "stage": pl._stage_id,
            "dp_rank": hcg.get_data_parallel_rank(), "state": state_of(pl),
            "stash": step.stash_high_water, "kind": type(step).__name__}


def pp_suite(rank, inp, out):
    ids = torch.from_numpy(inp["pp_ids"])
    labels = torch.from_numpy(inp["pp_labels"])
    fleet.init(is_collective=True, strategy=strategy(pp_degree=4))
    for sch in ("1F1B", "F-then-B"):
        out[f"ebh4_{sch}"] = pp_run(inp, "ebh4", lambda: ebh(4), ids, labels,
                                    sch)
    hcg = fleet.get_hybrid_communicate_group()
    wide = ebh(4, wide=True)
    try:
        step = tmp.PipelineTrainStep(wide, pt.optimizer.SGD(
            0.05, parameters=wide.parameters()), hcg.mesh, n_micro=4)
        step(ids, labels)
        out["carrier_error"] = None
    except ValueError as e:
        out["carrier_error"] = str(e)
    s = strategy(pp_degree=2, dp_degree=2)
    s.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
    fleet.init(is_collective=True, strategy=s)
    hcg = fleet.get_hybrid_communicate_group()
    dp_r = hcg.get_data_parallel_rank()
    # the engine runs pp as replicas of the whole model, as the reference's
    m = mlp(inp)
    eng = tdist.HybridParallelEngine(
        m, pt.optimizer.SGD(0.1, parameters=m.parameters()), mse,
        mesh=hcg.mesh)
    x, y = dp_half(inp["mlp_x"], dp_r), dp_half(inp["mlp_y"], dp_r)
    out["engine_pp"] = {
        "losses": torch.stack([eng.train_step(x, y) for _ in range(2)]),
        "state": state_of(m), "sync_ranks": eng._sync_group.ranks}
    for sch in ("1F1B", "F-then-B"):
        out[f"ebh2_{sch}"] = pp_run(inp, "ebh2", lambda: ebh(2), ids, labels,
                                    sch)
        out[f"ebh2dp_{sch}"] = pp_run(inp, "ebh2", lambda: ebh(2),
                                      dp_half(inp["pp_ids"], dp_r),
                                      dp_half(inp["pp_labels"], dp_r), sch)
        out[f"gpt2_{sch}"] = pp_run(
            inp, "gpt_pp", lambda: gpt_pipe(inp, 2),
            torch.from_numpy(inp["gpt_pp_ids"]),
            torch.from_numpy(inp["gpt_pp_labels"]), sch,
            via_fleet=sch == "1F1B")


# -- zero3: the engine's sync group (C1), then ZeRO-3 (4 ranks) ------------
def c1_engine(inp, out):
    """mp 2 x sharding 2 with dp_axes=("dp", "sharding"): each sharding rank
    on its half of the batch (padded labels), 2 SGD steps, eval_step."""
    fleet.init(is_collective=True, strategy=strategy(mp_degree=2,
                                                      sharding_degree=2))
    hcg = fleet.get_hybrid_communicate_group()
    mp_r, sh_r = hcg.get_model_parallel_rank(), \
        hcg.get_sharding_parallel_rank()
    m = gpt_model(inp, mp_r, 2)
    eng = tdist.HybridParallelEngine(
        m, pt.optimizer.SGD(0.1, parameters=m.parameters()),
        lambda mm, i, l: mm.loss(i, l), mesh=hcg.mesh,
        dp_axes=("dp", "sharding"))
    ids = dp_half(inp["gpt_ids"], sh_r)
    labels = dp_half(inp["gpt_labels_pad"], sh_r)
    losses = torch.stack([eng.train_step(ids, labels) for _ in range(2)])
    out["c1"] = {"losses": losses, "state": state_of(m), "mp_rank": mp_r,
                 "sharding_rank": sh_r, "sync_ranks": eng._sync_group.ranks,
                 "eval": eng.eval_step(lambda mm, i, l: mm.loss(i, l), ids,
                                       labels)}


class OddMLP(Layer):
    """The reference's ``Sequential(Linear(8, 16), Tanh(), Linear(16,
    3))``: the last bias (3,) splits over no group of 2 or 4 ranks."""

    def __init__(self):
        super().__init__()
        self.add_sublayer("0", Linear(8, 16, device="cpu"))
        self.add_sublayer("2", Linear(16, 3, device="cpu"))

    def forward(self, x):
        return getattr(self, "2")(torch.tanh(getattr(self, "0")(x)))


ZERO3_EAGER = {
    "global_norm": lambda ps: pt.optimizer.SGD(
        0.5, parameters=ps, grad_clip=pt.nn.ClipGradByGlobalNorm(0.05)),
    "by_norm": lambda ps: pt.optimizer.SGD(
        0.5, parameters=ps, grad_clip=pt.nn.ClipGradByNorm(0.02)),
    "lamb": lambda ps: pt.optimizer.Lamb(0.1, epsilon=1e-3, parameters=ps),
    "lars": lambda ps: pt.optimizer.LarsMomentum(
        1.0, lars_coeff=0.1, parameters=ps),
}


def zero3_run(inp, n, out):
    """ZeRO-3 over this rank's sharding group of ``n``: 3 AdamW steps
    through the engine (dp_axes=(), the whole batch), then 2 eager steps of
    each clip and norm rule."""
    hcg = fleet.get_hybrid_communicate_group()
    x, y = torch.from_numpy(inp["z3_x"]), torch.from_numpy(inp["z3_y"])
    m = OddMLP()
    load_reference_state_dict(m, prefixed(inp, "z3."))
    adam = pt.optimizer.AdamW(0.01, parameters=m.parameters())
    model, opt, _ = tmp.group_sharded_parallel(m, adam, "p_g_os")
    eng = tdist.HybridParallelEngine(model, opt, mse, mesh=hcg.mesh,
                                     dp_axes=())
    losses = torch.stack([eng.train_step(x, y) for _ in range(3)])
    res = {"losses": losses, "state": model.state_dict(),
           "local": {k: tuple(p.shape) for k, p in m.named_parameters()},
           "moments": [{k: tuple(v.shape) for k, v in
                        adam._accumulators[nm].items()}
                       for nm in adam._names],
           "all": [tuple(p.shape) for p in model.get_all_parameters()],
           "wrapper": type(model).__name__}
    for name, make in ZERO3_EAGER.items():
        m = OddMLP()
        load_reference_state_dict(m, prefixed(inp, "z3."))
        o = make(m.parameters())
        model = tmp.ShardingStage3(m, o)
        for _ in range(2):
            mse(model, x, y).backward()
            o.step()
            o.clear_grad()
        res[f"eager_{name}"] = model.state_dict()
    out[f"zero3_{n}"] = res


def zero3_suite(rank, inp, out):
    c1_engine(inp, out)
    fleet.init(is_collective=True, strategy=strategy(sharding_degree=4))
    zero3_run(inp, 4, out)
    fleet.init(is_collective=True, strategy=strategy(sharding_degree=2,
                                                      dp_degree=2))
    zero3_run(inp, 2, out)


# -- moe: the expert all-to-all at ep 2 and 4 (4 ranks) ----------------------
def moe_suite(rank, inp, out):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.models import ep_split_state_dict

    # every rank creates every group, in one order
    pairs = [C.new_group([0, 1]), C.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: C.new_group([0, 1, 2, 3])}
    state = prefixed(inp, "moe.")
    for ep, g in groups.items():
        r = g.rank
        layer = tmp.MoELayer(8, 16, 8, top_k=2, ep_group=g, device="cpu")
        load_reference_state_dict(layer, ep_split_state_dict(state, ep)[r])
        T = int(inp["moe_tokens"])
        x = torch.from_numpy(inp["moe_x"][r * T:(r + 1) * T]).requires_grad_()
        y = layer(x)
        ((y ** 2).mean() + 0.01 * layer.aux_loss).backward()
        out[f"ep{ep}"] = {
            "rank": r, "out": y.detach(), "aux": layer.aux_loss.detach(),
            "dx": x.grad, "dropped": layer.dropped_tokens(),
            "grads": {n: p.grad.clone() for n, p in
                      layer.named_parameters()},
            "shapes": {n: tuple(p.shape) for n, p in
                       layer.named_parameters()}}
        # the exchange itself: global_scatter then global_gather
        rows = torch.arange(4 * ep, dtype=torch.float32) + 100 * r
        out[f"scatter{ep}"] = [tdist.utils.global_scatter(rows, group=g),
                               tdist.utils.global_gather(
                                   tdist.utils.global_scatter(rows, group=g),
                                   group=g)]
    # the engine runs ep as replicas (a MoELayer without an ep group), as
    # the reference's does
    mesh = tdist.build_mesh(["dp", "ep"], [2, 2])
    layer = tmp.MoELayer(8, 16, 8, top_k=2, capacity_factor=4.0,
                         device="cpu")
    load_reference_state_dict(layer, state)
    eng = tdist.HybridParallelEngine(
        layer, pt.optimizer.SGD(0.1, parameters=layer.parameters()),
        mse, mesh=mesh)
    half = int(inp["moe_tokens"])
    dp_r = rank // 2
    x = torch.from_numpy(inp["moe_x"][dp_r * half:(dp_r + 1) * half])
    y = torch.from_numpy(inp["moe_y"][dp_r * half:(dp_r + 1) * half])
    out["engine_ep"] = {
        "losses": torch.stack([eng.train_step(x, y) for _ in range(2)]),
        "state": state_of(layer), "sync_ranks": eng._sync_group.ranks}


# -- comm: DGC and LocalSGD at dp 2 (2 ranks) --------------------------------
DGC_CFG = {"rampup_begin_step": 1, "rampup_step": 2, "sparsity": (0.5, 0.75)}


def comm_run(inp, rank, make_opt):
    """4 eager steps on this rank's half batch; the parameters after each
    step, and whether each step left the gradients local."""
    m = mlp(inp)
    opt = make_opt(m.parameters())
    x, y = dp_half(inp["mlp_x"], rank), dp_half(inp["mlp_y"], rank)
    states, local = [], []
    for _ in range(4):
        mse(m, x, y).backward()
        before = [p.grad.clone() for p in m.parameters()]
        opt.step()
        local.append(all(torch.equal(p.grad, g)
                         for p, g in zip(m.parameters(), before)))
        opt.clear_grad()
        states.append(state_of(m))
    return {"states": states, "local": local, "opt": opt}


def comm_suite(rank, inp, out):
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
        DGCMomentumOptimizer, LocalSGDOptimizer)

    fleet.init(is_collective=True, strategy=strategy(dp_degree=2))
    res = comm_run(inp, rank, lambda ps: DGCMomentumOptimizer(
        0.1, 0.9, ps, **DGC_CFG))
    out["dgc"] = {"states": res["states"],
                  "fraction": res["opt"].last_comm_fraction}
    s = fleet.DistributedStrategy()
    s.dgc, s.dgc_configs = True, dict(DGC_CFG)
    res = comm_run(inp, rank, lambda ps: fleet.distributed_optimizer(
        pt.optimizer.Momentum(0.1, momentum=0.9, parameters=ps), s))
    out["dgc_fleet"] = {"states": res["states"], "local": res["local"],
                        "kind": type(res["opt"]._inner_opt).__name__}
    s = fleet.DistributedStrategy()
    s.localsgd, s.localsgd_configs = True, {"k_steps": 2}
    res = comm_run(inp, rank, lambda ps: fleet.distributed_optimizer(
        pt.optimizer.SGD(0.1, parameters=ps), s))
    out["localsgd"] = {"states": res["states"], "local": res["local"],
                       "kind": type(res["opt"]._inner_opt).__name__}
    assert isinstance(res["opt"]._inner_opt, LocalSGDOptimizer)


SUITES = {"tp": tp_suite, "zero": zero_suite, "sp": sp_suite, "pp": pp_suite,
          "zero3": zero3_suite, "moe": moe_suite, "comm": comm_suite}


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
