"""Tensor parallelism of the port at dp 2 x mp 2 over four gloo ranks on
the CPU, against the reference (``paddle_tpu``) on logical weights.

The four ranks (``tests/torch_hybrid_worker.py tp``) are started once for
the file; each test reads what they wrote. Inputs are numpy from seeds, in
float32, dropout 0.

* ``fleet.init`` at dp 2 x mp 2: the hybrid group's degrees and its mp, dp
  and data x sequence groups (an mp group is consecutive ranks);
* each mp layer's forward and backward on its rank's shard against the
  reference's layer on the logical weight (rtol = atol = 1e-5, float32 sum
  order): the output (the rank's columns where it is not gathered), the
  input's gradient and the shard of the weight's;
* the vocab-parallel fused CE against the reference's fused CE on the whole
  vocabulary (loss rtol 1e-6, gradients rtol = atol = 1e-5);
* the eager loop through ``fleet.distributed_model``/
  ``distributed_optimizer`` with SGD and ``ClipGradByGlobalNorm(0.5)``
  (the clip binds: the first step's norm is several times 0.5) on each dp
  rank's half batch against the reference's single-device eager loop on the
  full batch: losses (the mean over dp) rtol 1e-5, merged weights rtol
  1e-4 / atol 1e-5 (measured: 6.9e-8 relative, 1.5e-8 absolute);
* the same eager loop with each norm-based rule (SGD under
  ``ClipGradByNorm(0.05)``, ``Lamb``, ``LarsMomentum``): each norm of a
  sharded parameter is taken over its mp group, so the merged weights
  after 2 steps match the reference's single-device loop (rtol 1e-4 /
  atol 1e-6);
* tiny GPT through ``HybridParallelEngine(mesh=hcg.mesh)`` with SGD (lr
  0.1, so three steps move the weights by ~1e-3 and a gradient wrong by 1%
  shows) against the reference's engine on its dp 2 x mp 2 four-device
  virtual mesh (``test_gpt_hybrid_step_matches_dense``'s pattern): loss
  within 1e-5 relative and every logical weight within rtol 1e-4 / atol
  1e-6 after 1 and 3 steps. Measured on the CPU: losses differ by at most
  1.5e-7 relative, weights by at most 1.2e-7 absolute (float32 sum order
  only; AdamW is left to the ZeRO file, as its first steps are close to
  lr * sign(g) and an element whose gradient cancels to near epsilon moves
  by up to ~2% of lr between two sum orders);
* a tiny Llama (4 heads, 2 KV heads) at mp = 2: loss rtol 1e-5 and the
  merged gradients rtol 1e-4 / atol 1e-6 against the reference's;
* a GPT built at mp = 2 from a seed holds exactly the slices of the mp = 1
  model from that seed, and ``merge_state_dicts`` of ``split_state_dict``
  is the identity (bit for bit) with the qkv cut head by head.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.base import fleet_base as jfleet_base
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny as jllama_tiny
from paddle_tpu_torch.distributed.fleet.meta_parallel.mp_layers import (
    MP_LAYOUTS, shard_of)
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     LlamaForCausalLM, llama_tiny,
                                     merge_state_dicts, mp_layouts,
                                     split_state_dict)
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
WORLD = 4
RANK_TIMEOUT_S = 240
GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_position_embeddings", "hidden_dropout",
              "attention_dropout")
# (reference constructor, input kind, input layout, output layout)
LAYERS = {
    "column_gather": (lambda: jmp.ColumnParallelLinear(
        6, 10, has_bias=True, gather_output=True), "float", "replicated",
        "replicated"),
    "column_local": (lambda: jmp.ColumnParallelLinear(
        6, 10, has_bias=True, gather_output=False), "float", "replicated",
        "cols"),
    "row_parallel_in": (lambda: jmp.RowParallelLinear(
        10, 6, has_bias=True, input_is_parallel=True), "float", "cols",
        "replicated"),
    "row_split": (lambda: jmp.RowParallelLinear(
        10, 6, has_bias=False, input_is_parallel=False), "float",
        "replicated", "replicated"),
    "vocab_embedding": (lambda: jmp.VocabParallelEmbedding(50, 8), "ids",
                        "replicated", "replicated"),
}
# the norm-based rules of the eager loop (tests/torch_hybrid_worker.py's
# EAGER_RULES): each computes a norm a parameter at a time, which for a
# sharded parameter is the logical one. Steps are large (SGD lr 1 under
# a clip of 0.05 that binds on every parameter; Lamb lr 0.1; LARS lr 1,
# coefficient 0.1), so a norm taken on the shard moves the weights by far
# more than the tolerance.
EAGER_RULES = {
    "by_norm": lambda ps: paddle.optimizer.SGD(
        learning_rate=1.0, parameters=ps,
        grad_clip=paddle.nn.ClipGradByNorm(0.05)),
    "lamb": lambda ps: paddle.optimizer.Lamb(learning_rate=0.1, epsilon=1e-3,
                                             parameters=ps),
    "lars": lambda ps: paddle.optimizer.LarsMomentum(
        learning_rate=1.0, lars_coeff=0.1, parameters=ps),
}
LAYER_IN = {"column_gather": (3, 4, 6), "column_local": (3, 4, 6),
            "row_parallel_in": (3, 4, 10), "row_split": (3, 4, 10),
            "vocab_embedding": (3, 7)}


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float32)


def _gpt(seed=21):
    paddle.seed(seed)
    return JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))


def _reference_layers(inp, ref):
    for name, (make, kind, _, _) in LAYERS.items():
        layer = make()
        for k, v in layer.state_dict().items():
            inp[f"layer.{name}.p.{k}"] = np.asarray(v, np.float32)
        rng = np.random.RandomState(len(name))
        x = rng.randint(0, 50, LAYER_IN[name]).astype(np.int64) \
            if kind == "ids" else \
            rng.randn(*LAYER_IN[name]).astype(np.float32)
        jx = paddle.to_tensor(x)
        if kind == "float":
            jx.stop_gradient = False
        jy = layer(jx)
        cot = rng.randn(*jy.shape).astype(np.float32)
        (jy * paddle.to_tensor(cot)).sum().backward()
        inp[f"layer.{name}.x"], inp[f"layer.{name}.cot"] = x, cot
        ref[f"layer.{name}"] = {
            "y": _np(jy), "dx": _np(jx.grad) if kind == "float" else None,
            "grads": {n: _np(p.grad) for n, p in layer.named_parameters()}}


def _reference_fused_ce(inp, ref):
    rng = np.random.RandomState(4)
    x = rng.randn(24, 16).astype(np.float32)
    w = (rng.randn(40, 16) * 0.5).astype(np.float32)
    labels = rng.randint(0, 40, (24,)).astype(np.int64)
    labels[:3] = -100
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    jx.stop_gradient = jw.stop_gradient = False
    loss = paddle.nn.functional.fused_linear_cross_entropy(
        jx, jw, paddle.to_tensor(labels))
    loss.backward()
    inp["ce.x"], inp["ce.w"], inp["ce.labels"] = x, w, labels
    ref["ce"] = {"loss": float(loss.numpy()), "dx": _np(jx.grad),
                 "dw": _np(jw.grad)}


def _reference_gpt(inp, ref):
    jm = _gpt()
    cfg = jm.config
    inp.update({f"gpt.{k}": v for k, v in reference_state(jm).items()})
    inp["gpt_config"] = np.array(json.dumps(
        {f: getattr(cfg, f) for f in GPT_FIELDS}))
    rng = np.random.RandomState(3)
    ids = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    inp["gpt_ids"], inp["gpt_labels"] = ids, labels
    # the single-device eager loop with the clip
    o = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters(),
                             grad_clip=paddle.nn.ClipGradByGlobalNorm(0.5))
    losses = []
    for _ in range(2):
        loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
        loss.backward()
        o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    ref["eager"] = {"losses": losses, "state": reference_state(jm)}
    for name, make in EAGER_RULES.items():
        jm = _gpt()
        o = make(jm.parameters())
        for _ in range(2):
            jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels)).backward()
            o.step()
            o.clear_grad()
        ref[f"eager.{name}"] = reference_state(jm)
    # the engine on the dp 2 x mp 2 mesh (GSPMD over 4 virtual devices)
    strategy = jfleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1,
                               "sp_degree": 1}
    prev = jmesh._global_mesh
    jfleet.init(is_collective=True, strategy=strategy)
    try:
        hcg = jfleet.get_hybrid_communicate_group()
        jm2 = _gpt()
        o2 = paddle.optimizer.SGD(learning_rate=0.1,
                                  parameters=jm2.parameters())
        eng = JEngine(jm2, o2, lambda m, i, l: m.loss(i, l), mesh=hcg.mesh)
        tids, tlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
        losses = [float(eng.train_step(tids, tlab).numpy())]
        s1 = reference_state(jm2)
        losses += [float(eng.train_step(tids, tlab).numpy())
                   for _ in range(2)]
        ref["engine"] = {"losses": losses, "state1": s1,
                         "state3": reference_state(jm2)}
    finally:
        jfleet_base._hcg = None
        jmesh.set_global_mesh(prev)


def _reference_llama(inp, ref):
    paddle.seed(5)
    cfg = jllama_tiny(num_kv_heads=2)
    jm = JLlama(cfg)
    inp.update({f"llama.{k}": v for k, v in reference_state(jm).items()})
    inp["llama_config"] = np.array(json.dumps(
        {f: getattr(cfg, f) for f in ("vocab_size", "hidden_size",
                                      "num_layers", "num_heads",
                                      "num_kv_heads",
                                      "max_position_embeddings")}))
    rng = np.random.RandomState(6)
    ids = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int64)
    inp["llama_ids"], inp["llama_labels"] = ids, labels
    loss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss.backward()
    ref["llama"] = {"loss": float(loss.numpy()),
                    "grads": {n: _np(p.grad)
                              for n, p in jm.named_parameters()}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inp, ref = {}, {}
    old = jflags.flag("FLAGS_shard_weight_update")
    try:
        _reference_layers(inp, ref)
        _reference_fused_ce(inp, ref)
        _reference_gpt(inp, ref)
        _reference_llama(inp, ref)
    finally:
        jflags.set_flags({"FLAGS_shard_weight_update": old})
    np.savez(d / "inputs.npz", **inp)
    got = spawn_ranks(WORKER, ["tp", d], WORLD, d, RANK_TIMEOUT_S)
    return got, ref


def _mp_pair(got, dp_rank=0):
    """The two ranks of dp rank ``dp_rank``'s mp group, mp rank order."""
    pair = [g for g in got if g["hcg"]["dp_rank"] == dp_rank]
    return sorted(pair, key=lambda g: g["hcg"]["mp_rank"])


def _layouts():
    m = GPTForPretraining(GPTConfig(**{f: getattr(jgpt_tiny(), f)
                                       for f in GPT_FIELDS}), device="cpu")
    return mp_layouts(m)


def _merged(states):
    return {k: v.numpy() for k, v in merge_state_dicts(states,
                                                       _layouts()).items()}


def test_fleet_topology_at_dp2_mp2(ranks):
    got, _ = ranks
    for r, g in enumerate(got):
        h = g["hcg"]
        assert h["degrees"] == [2, 2, 1, 1, 1]
        assert (h["dp_rank"], h["mp_rank"]) == divmod(r, 2)
        assert h["mp_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert h["dp_ranks"] == h["dp_sp_ranks"] == [r % 2, r % 2 + 2]
        assert h["mesh"] == {"pp": 1, "dp": 2, "sharding": 1, "sp": 1,
                             "mp": 2}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_mp_layer_shard_matches_reference_layer(ranks, name):
    got, ref = ranks
    _, kind, x_layout, y_layout = LAYERS[name]
    want = ref[f"layer.{name}"]
    tol = dict(rtol=1e-5, atol=1e-5)
    for g in got:
        r = g["hcg"]["mp_rank"]
        res = g["layers"][name]
        np.testing.assert_allclose(
            res["y"].numpy(),
            shard_of(torch.from_numpy(want["y"]), y_layout, r, 2).numpy(),
            **tol)
        if kind == "float":
            np.testing.assert_allclose(
                res["dx"].numpy(),
                shard_of(torch.from_numpy(want["dx"]), x_layout, r,
                         2).numpy(), **tol)
        for n, gw in want["grads"].items():
            layout = "replicated" if n == "bias" and name.startswith("row") \
                else ("rows" if name.startswith(("row", "vocab")) else "cols")
            np.testing.assert_allclose(
                res["grads"][n].numpy(),
                shard_of(torch.from_numpy(gw), layout, r, 2).numpy(),
                err_msg=n, **tol)
        assert set(res["distributed"]) == {
            n for n in want["grads"]
            if not (n == "bias" and name.startswith("row"))}


def test_vocab_parallel_fused_ce_matches_reference(ranks):
    got, ref = ranks
    want = ref["ce"]
    for g in got:
        r = g["hcg"]["mp_rank"]
        np.testing.assert_allclose(float(g["ce"]["loss"]), want["loss"],
                                   rtol=1e-6)
        np.testing.assert_allclose(g["ce"]["dx"].numpy(), want["dx"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            g["ce"]["dw"].numpy(),
            shard_of(torch.from_numpy(want["dw"]), "rows", r, 2).numpy(),
            rtol=1e-5, atol=1e-5)


def test_eager_loop_with_group_aware_clip_matches_single_device(ranks):
    got, ref = ranks
    want = ref["eager"]
    assert got[0]["eager"]["wrapper"] == "TensorParallel"
    assert got[0]["eager"]["optimizer"] == "HybridParallelOptimizer"
    losses = np.mean([g["eager"]["losses"].numpy() for g in got
                      if g["hcg"]["mp_rank"] == 0], axis=0)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for dp_rank in (0, 1):
        merged = _merged([g["eager"]["state"]
                          for g in _mp_pair(got, dp_rank)])
        for k, w in want["state"].items():
            np.testing.assert_allclose(merged[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("rule", sorted(EAGER_RULES))
def test_eager_norm_rule_at_dp2_mp2_matches_single_device(ranks, rule):
    got, ref = ranks
    want = ref[f"eager.{rule}"]
    for dp_rank in (0, 1):
        merged = _merged([g["eager_rules"][rule]
                          for g in _mp_pair(got, dp_rank)])
        for k, w in want.items():
            np.testing.assert_allclose(merged[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("after", [1, 3])
def test_gpt_engine_dp2_mp2_matches_reference_mesh(ranks, after):
    got, ref = ranks
    want = ref["engine"]
    for g in got:
        assert not g["engine"]["wus"]
        np.testing.assert_allclose(g["engine"]["losses"].numpy()[:after],
                                   want["losses"][:after], rtol=1e-5)
    key = f"state{after}"
    for dp_rank in (0, 1):
        merged = _merged([g["engine"][key] for g in _mp_pair(got, dp_rank)])
        assert set(merged) == set(want[key])
        for k, w in want[key].items():
            np.testing.assert_allclose(merged[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_llama_at_mp2_matches_reference(ranks):
    got, ref = ranks
    want = ref["llama"]
    layouts = mp_layouts(LlamaForCausalLM(llama_tiny(num_kv_heads=2),
                                          device="cpu"))
    pair = _mp_pair(got)
    for g in pair:
        np.testing.assert_allclose(float(g["llama"]["loss"]), want["loss"],
                                   rtol=1e-5)
    merged = merge_state_dicts([g["llama"]["grads"] for g in pair], layouts)
    for k, w in want["grads"].items():
        np.testing.assert_allclose(merged[k].numpy(), w, rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_model_built_at_mp2_holds_the_mp1_slices(ranks):
    got, _ = ranks
    full = GPTForPretraining(GPTConfig(**{f: getattr(jgpt_tiny(), f)
                                          for f in GPT_FIELDS}),
                             device="cpu", seed=11)
    shards = split_state_dict(full.state_dict(), mp_layouts(full), 2)
    for g in got:
        r = g["hcg"]["mp_rank"]
        assert set(g["init"]) == set(shards[r])
        for k, v in shards[r].items():
            assert torch.equal(g["init"][k], v), k


@pytest.mark.parametrize("mp", [2, 4])
def test_split_then_merge_is_identity_and_qkv_holds_its_heads(mp):
    m = GPTForPretraining(GPTConfig(**{f: getattr(jgpt_tiny(), f)
                                       for f in GPT_FIELDS}), device="cpu")
    layouts = mp_layouts(m)
    state = m.state_dict()
    shards = split_state_dict(state, layouts, mp)
    back = merge_state_dicts(shards, layouts)
    assert all(torch.equal(back[k], v) for k, v in state.items())
    h, heads = m.config.hidden_size, m.config.num_heads
    per = h // mp
    w = state["gpt.layers.0.attn.qkv.weight"]
    for r, sh in enumerate(shards):
        got = sh["gpt.layers.0.attn.qkv.weight"]
        assert got.shape == (h, 3 * per)
        for s in range(3):  # q, k, v of heads r * heads/mp ...
            assert torch.equal(got[:, s * per:(s + 1) * per],
                               w[:, s * h + r * per:s * h + (r + 1) * per])
    assert layouts["gpt.layers.0.attn.qkv.weight"] == "qkv"
    assert layouts["gpt.layers.0.attn.proj.bias"] == "replicated"
    assert layouts["gpt.embeddings.word_embeddings.weight"] == "rows"
    assert set(layouts.values()) <= set(MP_LAYOUTS)
