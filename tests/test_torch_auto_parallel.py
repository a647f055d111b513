"""Auto-parallel (``paddle_tpu_torch.distributed.auto_parallel``) against the
reference (``paddle_tpu``) on its virtual meshes.

* Plan derivation and completion: the candidate plans' ``{name: spec}``
  and ``complete_annotations``' placements equal the reference's exactly
  on tiny GPT, on the reference test's interleaved model and with a user
  annotation (``tests/test_auto_parallel.py:51–122``), at mp 2 and mp 8.
* Two gloo ranks (``tests/torch_a11_worker.py auto``) at mp 2:
  - tiny GPT built at one rank and realised by ``Engine.prepare`` (the
    Megatron plan) against the same GPT built at mp 2 from its mp layers:
    the loss and every gradient equal (within float32 sum order; they read
    bit-equal), the same collectives (12 all-reduces), the same 2 engine
    losses;
  - the test's MLP (``fc1 -> gelu -> fc2``) of mp layers built at one
    rank through ``auto_parallelize``: the reference's winner
    (``megatron``) and the reference's collectives (one all-reduce); under
    a budget between the plans' peaks, the plan over it scores
    ``(1, ...)`` and the other wins, as in the reference; realised by
    ``prepare``, the MLP of mp layers and the MLP of plain ``Linear``s
    give the logical loss and gradients (their shards).
* ``analyze_collectives``/``plan_cost``/``estimate_cost`` on known work,
  and ``Engine.cost`` leaves the RNG stream where it was.

tiny GPT's winner differs from the reference's (ROADMAP §C): the
reference's GSPMD partition of the Megatron plan launches 12 all-reduces
and 4 all-gathers (909,312 bytes) where the port's realisation launches
the Megatron pattern's 12 all-reduces (164,608 bytes), so the reference
ranks ``embedding-only`` first and the port ``megatron``; and a plain
``Linear`` pair is realised with gathers (see
``test_plain_linear_mlp_ranks_by_its_gathering_collectives``). The tests
hold those rankings to the port's own measured scores.
"""
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import auto_parallel as jap
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.distributed import auto_parallel as tap
from paddle_tpu_torch.distributed.mesh import Mesh
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_a11_worker.py"
RANK_TIMEOUT_S = 240
GPT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=32, hidden_dropout=0.0,
           attention_dropout=0.0)
MLP_H, MLP_FF, MLP_B = 256, 768, 64


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]).reshape(n), ("mp",))


def _tmesh(n):
    return Mesh(np.arange(n), ("mp",))


def _norm(s):
    """A placement for comparison: None and all-None are replicated."""
    if s is None:
        return None
    t = tuple(s)
    return None if all(e is None for e in t) else t


def _specs(model):
    return {n: _norm(getattr(p, "pspec", None))
            for n, p in model.named_parameters()}


def _plans(plans):
    return [(p.name, {n: _norm(s) for n, s in p.param_specs.items()})
            for p in plans]


def _gpts():
    jm = JGPT(JGPTConfig(**GPT, use_mp_layers=False))
    for _, p in jm.named_parameters():
        p.pspec = None
    return jm, GPTForPretraining(GPTConfig(**GPT), device="cpu")


# -- (a) plan derivation and completion --------------------------------------
@pytest.mark.parametrize("mp", [2, 8])
def test_candidate_plans_equal_the_reference(mp):
    jm, tm = _gpts()
    want = _plans(jap.derive_candidate_plans(jm, _jmesh(mp)))
    got = _plans(tap.derive_candidate_plans(tm, _tmesh(mp)))
    assert [n for n, _ in got] == ["megatron", "replicated", "embedding-only"]
    assert got == want


@pytest.mark.parametrize("mp", [2, 8])
def test_complete_annotations_equals_the_reference(mp):
    jm, tm = _gpts()
    jap.complete_annotations(jm, _jmesh(mp))
    tap.complete_annotations(tm, _tmesh(mp))
    got = _specs(tm)
    assert got == _specs(jm)
    assert got["gpt.layers.0.attn.qkv.weight"] == (None, "mp")
    assert got["gpt.layers.0.attn.qkv.bias"] == ("mp",)
    assert got["gpt.layers.1.mlp.down.weight"] == ("mp", None)
    assert got["gpt.embeddings.word_embeddings.weight"] == ("mp", None)


def _interleaved(pkg, **kw):
    class Odd(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.solo = pkg.Linear(32, 32, **kw)

    class Block(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg.Linear(32, 128, **kw)
            self.fc2 = pkg.Linear(128, 32, **kw)

    class Net(pkg.Layer):
        def __init__(self):
            super().__init__()
            self.odd = Odd()
            self.block = Block()

    return Net()


def test_interleaved_params_pair_per_parent_as_the_reference():
    jm, tm = _interleaved(jnn), _interleaved(tnn, device="cpu")
    jap.complete_annotations(jm, _jmesh(8))
    tap.complete_annotations(tm, _tmesh(8))
    got = _specs(tm)
    assert got == _specs(jm)
    assert got["block.fc1.weight"] == (None, "mp")
    assert got["block.fc2.weight"] == ("mp", None)
    assert got["odd.solo.weight"] is None


def test_user_annotation_wins_as_in_the_reference():
    from paddle_tpu_torch.distributed.sharding_api import (PartitionSpec,
                                                           shard_tensor)

    jm, tm = _gpts()
    name = "gpt.layers.0.attn.qkv.weight"
    dict(jm.named_parameters())[name].pspec = jax.sharding.PartitionSpec()
    # the port's annotation goes through shard_tensor on the parameter
    p = dict(tm.named_parameters())[name]
    assert shard_tensor(p, _tmesh(8), PartitionSpec()) is p
    jplans = jap.derive_candidate_plans(jm, _jmesh(8))
    tplans = tap.derive_candidate_plans(tm, _tmesh(8))
    assert _plans(tplans) == _plans(jplans)
    jap.complete_annotations(jm, _jmesh(8))
    tap.complete_annotations(tm, _tmesh(8))
    assert _specs(tm) == _specs(jm)
    assert _specs(tm)[name] is None  # P(): replicated, as the user said


# -- (b) two gloo ranks at mp 2 ------------------------------------------------
class _JMLP(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = jnn.Linear(MLP_H, MLP_FF)
        self.fc2 = jnn.Linear(MLP_FF, MLP_H)

    def forward(self, x):
        return self.fc2(JF.gelu(self.fc1(x), approximate=True))


def _reference_mlp(inp, ref):
    paddle.seed(1)
    jm = _JMLP()
    rng = np.random.RandomState(0)
    x = rng.randn(MLP_B, MLP_H).astype(np.float32)
    y = rng.randn(MLP_B, MLP_H).astype(np.float32)
    inp.update({f"mlp.{k}": v for k, v in reference_state(jm).items()})
    inp["mlp_x"], inp["mlp_y"] = x, y
    mesh = _jmesh(2)
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    tx, ty = paddle.to_tensor(x), paddle.to_tensor(y)

    def build():
        e = JEngine(jm, opt, lambda m, a, b: ((m(a) - b) ** 2).mean(),
                    mesh=mesh, dp_axes=(), donate=False)
        args = e._prepare(tx, ty)
        return e._jit.lower(*args).compile()

    plans = jap.derive_candidate_plans(jm, mesh)
    best = jap.select_plan(jm, plans, build)
    ref["mlp"] = {"winner": best.name,
                  "counts": {p.name: p.report["comm_counts"] for p in plans},
                  "peaks": {p.name: p.report["peak_memory_bytes"]
                            for p in plans}}
    peaks = sorted(ref["mlp"]["peaks"].values())
    budget = (peaks[0] + peaks[-1]) // 2
    for _, p in jm.named_parameters():  # the winner's specs are no user's
        p.pspec = None
    bplans = jap.derive_candidate_plans(jm, mesh)
    chosen = jap.select_plan(jm, bplans, build, memory_budget=budget)
    ref["mlp"]["budget"] = {"chosen": chosen.name,
                            "scores": {p.name: p.score for p in bplans}}
    with torch.no_grad():
        tm = torch.nn.Sequential(torch.nn.Linear(MLP_H, MLP_FF),
                                 torch.nn.GELU(approximate="tanh"),
                                 torch.nn.Linear(MLP_FF, MLP_H))
        tm[0].weight.copy_(torch.from_numpy(inp["mlp.fc1.weight"]).T)
        tm[0].bias.copy_(torch.from_numpy(inp["mlp.fc1.bias"]))
        tm[2].weight.copy_(torch.from_numpy(inp["mlp.fc2.weight"]).T)
        tm[2].bias.copy_(torch.from_numpy(inp["mlp.fc2.bias"]))
    loss = ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    ref["mlp"]["loss"] = float(loss.detach())
    ref["mlp"]["grads"] = {"fc1.weight": tm[0].weight.grad.T.numpy(),
                           "fc1.bias": tm[0].bias.grad.numpy(),
                           "fc2.weight": tm[2].weight.grad.T.numpy(),
                           "fc2.bias": tm[2].bias.grad.numpy()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("auto")
    inp, ref = {}, {}
    paddle.seed(3)
    jm = JGPT(JGPTConfig(**GPT, use_mp_layers=False))
    inp.update({f"gpt.{k}": v for k, v in reference_state(jm).items()})
    inp["gpt_config"] = np.array(json.dumps(GPT))
    rng = np.random.RandomState(0)
    inp["ids"] = rng.randint(0, GPT["vocab_size"], (2, 32)).astype(np.int64)
    inp["labels"] = rng.randint(0, GPT["vocab_size"], (2, 32)).astype(np.int64)
    _reference_mlp(inp, ref)
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["auto", d], 2, d, RANK_TIMEOUT_S), ref


def test_auto_realised_gpt_matches_the_hand_mp_layer_gpt(ranks):
    got, _ = ranks
    assert sorted(g["mp_rank"] for g in got) == [0, 1]
    for g in got:
        hand, auto = g["loss"]
        torch.testing.assert_close(auto, hand, rtol=1e-6, atol=0)
        for n, (gh, ga) in g["grads"].items():
            assert gh.shape == ga.shape, n
            torch.testing.assert_close(ga, gh, rtol=1e-5, atol=1e-7,
                                       msg=n)
        h_steps, a_steps = g["steps"]
        np.testing.assert_allclose(a_steps, h_steps, rtol=1e-6)


def test_auto_realised_gpt_launches_the_hand_placements_collectives(ranks):
    got, _ = ranks
    for g in got:
        hand, auto = g["kinds"]
        assert auto == hand == {"all-reduce": 12}
        specs = g["specs"]
        assert specs["layers.0.attn.qkv.weight"] == (None, "mp")
        assert specs["embeddings.word_embeddings.weight"] == ("mp", None)


def test_gpt_ranking_follows_the_measured_scores(ranks):
    got, _ = ranks
    for g in got:
        scores = {n: sc for n, sc, _ in g["plans"]}
        assert g["winner"] == min(scores, key=scores.get)
        reports = {n: rep for n, _, rep in g["plans"]}
        assert reports["replicated"]["comm_counts"] == {}
        assert reports["megatron"]["comm_counts"] == {"all-reduce": 12}
        assert reports["megatron"]["flops"] < reports["replicated"]["flops"]
        assert reports["megatron"]["peak_memory_bytes"] \
            < reports["replicated"]["peak_memory_bytes"]


def test_mlp_selection_picks_the_reference_winner(ranks):
    got, ref = ranks
    want = ref["mlp"]
    for g in got:
        res = g["mlp_mp_layers"]
        assert res["winner"] == want["winner"] == "megatron"
        assert res["kinds"] == want["counts"]["megatron"] \
            == {"all-reduce": 1}


def test_plain_linear_mlp_ranks_by_its_gathering_collectives(ranks):
    """A plain ``Linear`` placed P(None, mp) gathers its output and one
    placed P(mp, None) splits its input (the port cannot see the data flow
    between them that GSPMD sees), so its Megatron plan pays an all-gather
    and its ranking follows its own measured scores (ROADMAP §C)."""
    got, _ = ranks
    for g in got:
        res = g["mlp_linear"]
        scores = {n: sc for n, sc, _ in res["plans"]}
        assert res["winner"] == min(scores, key=scores.get)
        assert res["kinds"] == {"all-gather": 2, "all-reduce": 1}


@pytest.mark.parametrize("kind", ["mp_layers", "linear"])
def test_mlp_over_budget_plan_is_rejected_as_in_the_reference(ranks, kind):
    got, ref = ranks
    want = ref["mlp"]["budget"]
    assert want["scores"]["replicated"][0] == 1
    assert want["scores"]["megatron"][0] == 0
    for g in got:
        res = g[f"mlp_{kind}"]
        assert res["scores"]["replicated"][0] == 1
        assert res["scores"]["megatron"][0] == 0
        assert res["chosen"] == want["chosen"] == "megatron"


def test_mlp_realised_loss_and_gradients_are_the_logical_ones(ranks):
    got, ref = ranks
    want = ref["mlp"]["grads"]
    for g in got:
        for kind in ("mp_layers", "linear"):
            np.testing.assert_allclose(float(g[f"mlp_{kind}"]["loss"]),
                                       ref["mlp"]["loss"], rtol=1e-5)
        r = g["mp_rank"]
        for kind in ("mp_layers", "linear"):
            grads = g[f"mlp_{kind}"]["grads"]
            # fc1 holds columns r*FF/2.., its bias with them; fc2 rows
            half = MLP_FF // 2
            sl = {"fc1.weight": (slice(None), slice(r * half, (r + 1) * half)),
                  "fc1.bias": (slice(r * half, (r + 1) * half),),
                  "fc2.weight": (slice(r * half, (r + 1) * half),),
                  "fc2.bias": (slice(None),)}
            for n, s in sl.items():
                np.testing.assert_allclose(grads[n].numpy(), want[n][s],
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{kind} {n}")


# -- cost ----------------------------------------------------------------------
def test_analyze_collectives_counts_and_bytes():
    rec = [("all-reduce", 64), ("all-gather", 32), ("all-reduce", 64)]
    assert tap.analyze_collectives(rec) == {
        "counts": {"all-reduce": 2, "all-gather": 1}, "bytes": 160.0}
    assert tap.analyze_collectives([]) == {"counts": {}, "bytes": 0.0}


def test_estimate_cost_and_plan_cost_on_a_matmul():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = tap.estimate_cost(torch.matmul, a, b)
    assert c["flops"] == 2 * 8 * 16 * 4
    assert c["bytes_accessed"] == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    run = tap.StepRun(989e12, 0, [("all-reduce", 450e9)], 10)
    rep = tap.plan_cost(run)
    assert rep["time_proxy"] == pytest.approx(2.0)
    assert rep["comm_counts"] == {"all-reduce": 1}
    assert rep["peak_memory_bytes"] == 10


def test_engine_cost_leaves_the_rng_stream():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.random import get_rng_state

    pt.seed(5)
    m = GPTForPretraining(GPTConfig(**dict(GPT, hidden_dropout=0.1)),
                          device="cpu").train()
    from paddle_tpu_torch.nn import functional as F

    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=m.parameters())
    eng = tap.Engine(m, optimizer=opt, loss=lambda logits, labels:
                     F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                     labels.reshape(-1)))
    before = {k: v.clone() for k, v in get_rng_state().items()}
    state = {k: v.clone() for k, v in m.state_dict().items()}
    ids = torch.randint(0, GPT["vocab_size"], (2, 16))
    rep = eng.cost(ids, ids)
    assert rep["flops"] > 0
    after = get_rng_state()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(torch.equal(state[k], v) for k, v in m.state_dict().items())
