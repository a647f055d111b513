"""Pipeline parallelism of the port (``PipelineLayer``,
``PipelineTrainStep``, ``PipelineParallelModel.train_batch``) over four
gloo ranks on the CPU, against the reference (``paddle_tpu``) on its
virtual ``pp`` mesh, as ``tests/test_pp_1f1b.py`` builds it.

The four ranks (``tests/torch_hybrid_worker.py pp``) are started once for
the file. Each builds only its own stage of the layer, loads its keys of
the reference's weights (``models.pp_split_state_dict``) and runs 3 SGD
(lr 0.05) steps of 4 micro-batches on an (8, 16) batch, float32, inputs
from seeded numpy; the test merges the stages' states
(``pp_merge_state_dicts``):

* the reference test's Embed, 6 Blocks, Head at pp = 4 (``fleet.init`` at
  pp_degree = 4) and at pp = 2 (pp 2 x dp 2, each pipeline on the whole
  batch), both schedules: the losses on every rank and the merged weights
  against the reference's, rtol 2e-4 / atol 1e-5 (``test_pp_1f1b.py``'s);
* pp 2 x dp 2 as the reference computes it: each dp rank on its half of
  the batch, the gradients and losses averaged over dp, against the
  reference's pp = 2 step on the whole batch (its mesh replicates the
  batch over dp): same tolerances;
* a tiny GPT at pp = 2 with the LM head tied to the embedding through a
  ``SharedLayerDesc`` on the first and the last stage, 1F1B through
  ``fleet.distributed_model(...).train_batch``: same tolerances, and the
  two copies of the tied weights stay bit-equal;
* 1F1B's stash high-water mark is at most S - s on stage s, F-then-B's is
  n_micro;
* ``HybridParallelEngine`` over the pp 2 x dp 2 mesh runs pp as replicas
  of a whole model, as the reference's engine does: 2 SGD steps of an MLP
  on each dp rank's half against the reference's engine on its (pp 2,
  dp 2) mesh, losses rtol 1e-5, weights rtol 1e-4 / atol 1e-6;
* a middle stage that changes the carrier's shape raises the reference's
  ``ValueError`` on every rank, and (in-process) every other error of the
  reference with its words.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from jax.sharding import Mesh
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.meta_parallel import pp_layers as jpp
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
    PipelineParallelModel as JPPModel, PipelineTrainStep as JStep)
from paddle_tpu.models import gpt as jgpt
import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed import build_mesh
from paddle_tpu_torch.distributed.mesh import Mesh as TMesh
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
from paddle_tpu_torch.models import (pp_merge_state_dicts,
                                     pp_split_state_dict)
from torch_hybrid_worker import ebh, gpt_pipe
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
WORLD = 4
SCHEDULES = ("1F1B", "F-then-B")
V, D = 32, 64
GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_position_embeddings", "hidden_dropout",
              "attention_dropout")


class JEmbed(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.emb = jnn.Embedding(V, D)

    def forward(self, ids):
        return self.emb(ids)


class JBlock(jnn.Layer):
    def __init__(self, d_in=D, d_out=D):
        super().__init__()
        self.fc = jnn.Linear(d_in, d_out)

    def forward(self, x):
        y = paddle.tanh(self.fc(x))
        return x + y if tuple(y.shape) == tuple(x.shape) else y


class JHead(jnn.Layer):
    def __init__(self, d_in=D):
        super().__init__()
        self.proj = jnn.Linear(d_in, V)

    def forward(self, x):
        return self.proj(x)


_ce = jnn.CrossEntropyLoss()


def _jce(logits, labels):
    return _ce(logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]))


def _jebh(n_stages, wide=False):
    paddle.seed(3)
    if wide:
        descs = [jpp.LayerDesc(JEmbed), jpp.LayerDesc(JBlock),
                 jpp.LayerDesc(JBlock, D, 2 * D), jpp.LayerDesc(JHead, 2 * D)]
    else:
        descs = [jpp.LayerDesc(JEmbed)] + [jpp.LayerDesc(JBlock)
                                           for _ in range(6)] \
            + [jpp.LayerDesc(JHead)]
    return jpp.PipelineLayer(descs, num_stages=n_stages, loss_fn=_jce)


def _jtied(layer, x):
    if "int" in str(x.dtype):
        return layer(x)
    return paddle.matmul(x, layer.word_embeddings.weight, transpose_y=True)


def _gpt_cfg():
    return dataclasses.replace(jgpt.gpt_tiny(), num_layers=2,
                               hidden_dropout=0.0, attention_dropout=0.0)


def _jgpt_pipe(n_stages):
    paddle.seed(5)
    cfg = _gpt_cfg()
    shared = lambda: jpp.SharedLayerDesc(  # noqa: E731
        "embed", jgpt.GPTEmbeddings, _jtied, "word_embeddings.weight", cfg)
    descs = [shared()] + [jpp.LayerDesc(jgpt.GPTDecoderLayer, cfg)
                          for _ in range(cfg.num_layers)] \
        + [jpp.LayerDesc(jnn.LayerNorm, cfg.hidden_size, epsilon=1e-5),
           shared()]
    return jpp.PipelineLayer(descs, num_stages=n_stages, loss_fn=_jce)


def _mesh(pp):
    return Mesh(np.array(jax.devices()[:pp]), ("pp",))


def _run_reference(pl, n_stages, ids, labels, schedule):
    opt = paddle.optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
    step = JStep(pl, opt, _mesh(n_stages), n_micro=4, schedule=schedule)
    losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels))
                    .item()) for _ in range(3)]
    return {"losses": losses, "state": reference_state(pl)}


def _reference(inp):
    ref = {}
    rng = np.random.RandomState(11)
    ids = rng.randint(0, V, (8, 16)).astype(np.int64)
    labels = rng.randint(0, V, (8, 16)).astype(np.int64)
    inp["pp_ids"], inp["pp_labels"] = ids, labels
    cfg = _gpt_cfg()
    inp["gpt_config"] = np.array(json.dumps(
        {f: getattr(cfg, f) for f in GPT_FIELDS}))
    gids = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int64)
    glabels = rng.randint(0, cfg.vocab_size, (8, 16)).astype(np.int64)
    inp["gpt_pp_ids"], inp["gpt_pp_labels"] = gids, glabels
    for n in (4, 2):
        inp.update({f"ebh{n}.{k}": v
                    for k, v in reference_state(_jebh(n)).items()})
        for sch in SCHEDULES:
            ref[f"ebh{n}_{sch}"] = _run_reference(_jebh(n), n, ids, labels,
                                                  sch)
    inp.update({f"gpt_pp.{k}": v
                for k, v in reference_state(_jgpt_pipe(2)).items()})
    for sch in SCHEDULES:
        ref[f"gpt2_{sch}"] = _run_reference(_jgpt_pipe(2), 2, gids, glabels,
                                            sch)
    # the reference's engine over a (pp 2, dp 2) mesh: pp replicates
    rng = np.random.RandomState(5)
    x, y = rng.rand(16, 8).astype(np.float32), rng.rand(16, 4).astype(
        np.float32)
    paddle.seed(7)
    m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    inp["mlp_x"], inp["mlp_y"] = x, y
    inp.update({f"mlp.{k}": v for k, v in reference_state(m).items()})
    eng = JEngine(m, paddle.optimizer.SGD(learning_rate=0.1,
                                          parameters=m.parameters()),
                  lambda mm, a, b: ((mm(a) - b) ** 2).mean(),
                  mesh=jbuild_mesh(("pp", "dp"), (2, 2)))
    ref["engine_pp"] = {
        "losses": [float(eng.train_step(paddle.to_tensor(x),
                                        paddle.to_tensor(y)).numpy())
                   for _ in range(2)],
        "state": reference_state(m)}
    try:
        _run_reference(_jebh(4, wide=True), 4, ids, labels, "1F1B")
    except ValueError as e:
        ref["carrier_error"] = str(e)
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp")
    inp = {}
    ref = _reference(inp)
    np.savez(d / "inputs.npz", **inp)
    got = spawn_ranks(WORKER, ["pp", d], WORLD, d, RANK_TIMEOUT_S)
    return got, ref, inp


def _skeleton(run, inp):
    """A port layer of the run's descs (every stage, no fleet): the map
    of stage keys to the reference's."""
    if run.startswith("gpt"):
        return gpt_pipe(inp, 2)
    return ebh(4 if run.startswith("ebh4") else 2)


RUNS = [f"{r}_{s}" for r in ("ebh4", "ebh2", "ebh2dp", "gpt2")
        for s in SCHEDULES]


@pytest.mark.parametrize("run", RUNS)
def test_pipeline_matches_the_reference(ranks, run):
    got, ref, inp = ranks
    want = ref[run.replace("ebh2dp", "ebh2")]
    for g in got:
        np.testing.assert_allclose(g[run]["losses"].numpy(), want["losses"],
                                   rtol=2e-4, atol=1e-5)
    stages = sorted((g[run] for g in got if g[run]["dp_rank"] == 0),
                    key=lambda r: r["stage"])
    merged = pp_merge_state_dicts([r["state"] for r in stages],
                                  _skeleton(run, inp))
    assert sorted(merged) == sorted(want["state"])
    for k, w in want["state"].items():
        np.testing.assert_allclose(merged[k].numpy(), w, rtol=2e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("sch", SCHEDULES)
def test_tied_copies_stay_equal_and_train_batch_runs_the_schedule(ranks,
                                                                  sch):
    got, _, _ = ranks
    last = next(g[f"gpt2_{sch}"] for g in got
                if g[f"gpt2_{sch}"]["stage"] == 1)
    first = next(g[f"gpt2_{sch}"] for g in got
                 if g[f"gpt2_{sch}"]["stage"] == 0)
    for name in ("word_embeddings.weight", "position_embeddings.weight"):
        assert torch.equal(last["state"][f"stage1_4.{name}"],
                           first["state"][f"stage0_0.{name}"])
    assert first["kind"] == "PipelineTrainStep"


def test_1f1b_stash_is_bounded_by_the_stages(ranks):
    got, _, _ = ranks
    for g in got:
        for run, S in (("ebh4", 4), ("ebh2", 2), ("gpt2", 2)):
            one, gp = g[f"{run}_1F1B"], g[f"{run}_F-then-B"]
            assert one["stash"] <= S - one["stage"], (run, one["stage"])
            assert gp["stash"] == 4


def test_a_stage_that_changes_the_carrier_raises_on_every_rank(ranks):
    got, ref, _ = ranks
    want = ref["carrier_error"]
    assert want.startswith("pipeline stages must preserve")
    for g in got:
        assert g["carrier_error"].replace("torch.", "") == want


class _HCG:
    """A hybrid communicate group's pp degree and mesh."""

    def __init__(self, pp):
        self.pp = pp
        self.mesh = None

    def get_pipe_parallel_world_size(self):
        return self.pp


class _Strategy:
    def __init__(self, **cfg):
        self.pipeline_configs = dict({"accumulate_steps": 4,
                                      "micro_batch_size": 2}, **cfg)


def _message(fn):
    try:
        fn()
    except (ValueError, TypeError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error")


def test_errors_carry_the_reference_words():
    jpl, tpl = _jebh(1), ebh(1)
    jopt = paddle.optimizer.SGD(0.05, parameters=jpl.parameters())
    topt = pt.optimizer.SGD(0.05, parameters=tpl.parameters())
    ids = np.zeros((6, 4), np.int64)
    # the schedule's name, and the stages against the mesh's pp axis
    assert _message(lambda: JStep(jpl, jopt, _mesh(1), 4, schedule="zb")) \
        == _message(lambda: tmp.PipelineTrainStep(
            tpl, topt, build_mesh(["pp"], [1]), 4, schedule="zb"))
    assert _message(lambda: JStep(jpl, jopt, _mesh(2), 4)) == _message(
        lambda: tmp.PipelineTrainStep(tpl, topt, TMesh(np.arange(2),
                                                       ("pp",)), 4))
    # a batch the micro-batches do not divide
    assert _message(lambda: JStep(jpl, jopt, _mesh(1), 4)(
        paddle.to_tensor(ids), paddle.to_tensor(ids))) == _message(
        lambda: tmp.PipelineTrainStep(tpl, topt, build_mesh(["pp"], [1]),
                                      4)(torch.from_numpy(ids),
                                         torch.from_numpy(ids)))
    # train_batch's scaler, model type and micro-batch checks
    for args, kw in ((jpl, {}), (jnn.Linear(4, 4), {})):
        jm_, tm_ = (JPPModel(args, _HCG(2), _Strategy()),
                    tmp.PipelineParallelModel(
                        tpl if args is jpl else pt.nn.Linear(4, 4,
                                                             device="cpu"),
                        _HCG(2), _Strategy()))
        for scaler in (object(), None):
            assert _message(lambda: jm_.train_batch(
                (paddle.to_tensor(ids), paddle.to_tensor(ids)), jopt,
                scaler=scaler)) == _message(lambda: tm_.train_batch(
                    (torch.from_numpy(ids), torch.from_numpy(ids)), topt,
                    scaler=scaler))


def test_single_stage_layer_runs_every_segment_and_keeps_reference_names():
    """No pp group: every stage is built, ``forward`` runs them in order,
    and the state (a shared key once, under its first position) splits
    and merges back."""
    jpl = _jgpt_pipe(2)
    tpl = gpt_pipe({"gpt_config": np.array(json.dumps(
        {f: getattr(_gpt_cfg(), f) for f in GPT_FIELDS}))}, 2)
    jsd = reference_state(jpl)
    assert sorted(tpl.state_dict()) == sorted(jsd)
    from paddle_tpu_torch.models import load_reference_state_dict

    load_reference_state_dict(tpl, jsd)
    parts = pp_split_state_dict(jsd, tpl)
    assert "stage1_4.word_embeddings.weight" in parts[1]
    assert "stage0_0.word_embeddings.weight" in parts[0]
    back = pp_merge_state_dicts(parts, tpl)
    assert sorted(back) == sorted(jsd)
    ids = np.random.RandomState(2).randint(0, 1024, (2, 8)).astype(np.int64)
    with torch.no_grad():
        out = tpl(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jpl(paddle.to_tensor(ids)).numpy()), rtol=1e-5, atol=1e-6)


def test_engine_runs_pp_as_replicas_as_the_reference(ranks):
    got, ref, _ = ranks
    want = ref["engine_pp"]
    for r, g in enumerate(got):
        res = g["engine_pp"]
        assert res["sync_ranks"] == [r - r % 2, r - r % 2 + 1]  # dp group
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["state"].items():
            np.testing.assert_allclose(res["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
