"""Sequence parallelism of the port at sp = 2 over two gloo ranks on the
CPU, against the reference (``paddle_tpu``) under ``shard_map`` on two
virtual devices (as ``tests/test_sequence_parallel.py`` builds it).

The two ranks (``tests/torch_hybrid_worker.py sp``, ``fleet.init`` at
sp_degree = 2) are started once for the file; each holds its half of the
sequence. Inputs are float32 numpy from seeds.

* ``ring_attention`` and ``ulysses_attention``, causal and not, (B, T, H,
  D) = (2, 32, 4, 8): each rank's output rows and the gradients of
  ``sum(out ** 2)`` with respect to its q, k and v shards against the
  reference's (forward rtol = atol = 2e-5, gradients 1e-4, the reference
  test's own tolerances; measured: outputs within 4.8e-7, gradients
  within 3.9e-6, absolute);
* the chunked-Q ring: T = 2048, so each rank's 1024 rows run as two
  512-row chunks (same tolerances);
* tiny GPT with ``sequence_parallel=True, attention_impl="ring"`` through
  ``HybridParallelEngine(mesh=hcg.mesh)`` (each rank is handed the whole
  batch; the engine keeps its 16 of the 32 tokens) against the reference's
  engine on a (dp 1, sp 2) mesh, 3 SGD steps: losses rtol 1e-5, every
  weight after them rtol 1e-4 / atol 1e-6 (measured: 6.9e-8 relative,
  1.5e-8 absolute); the ring runs, and each rank's tokens take their
  global positions; the ring shift passes down and its gradient back;
* the same GPT on labels padded on the sequence's tail (rank 1 holds 18 of
  the 75 valid labels): 3 steps and ``eval_step`` against the reference's
  engine, the mean over valid rows taken over both ranks;
* ``split_sequence`` refuses a length the group does not divide, and
  ``split_batch`` cuts the dimension ``batch_specs`` names (in-process,
  no ranks).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as paddle
from jax.sharding import Mesh, PartitionSpec as P
from paddle_tpu.core.compat import shard_map
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet.meta_parallel.sequence_parallel import (
    ring_attention as jring, ulysses_attention as julysses)
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    sequence_parallel as tsp
from torch_port_util import reference_state, spawn_ranks

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_hybrid_worker.py"
RANK_TIMEOUT_S = 240
SP = 2
CASES = {"ring_causal": (jring, True, (2, 32, 4, 8)),
         "ring_full": (jring, False, (2, 32, 4, 8)),
         "ulysses_causal": (julysses, True, (2, 32, 4, 8)),
         "ulysses_full": (julysses, False, (2, 32, 4, 8)),
         "ring_chunked": (jring, True, (1, 2048, 2, 8))}


def _mesh(axes, shape):
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes)


def _spmd(fn):
    spec = P(None, "sp", None, None)
    return jax.jit(shard_map(fn, mesh=_mesh(("sp",), (SP,)),
                             in_specs=(spec,) * 3, out_specs=spec,
                             check_vma=False))


def _reference_attention(inp, ref):
    for i, (name, (fn, causal, shape)) in enumerate(CASES.items()):
        rng = np.random.RandomState(i)
        q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
        inp.update({f"{name}.q": q, f"{name}.k": k, f"{name}.v": v})
        f = _spmd(lambda a, b, c, fn=fn, causal=causal:
                  fn(a, b, c, "sp", causal=causal))
        out = f(q, k, v)
        grads = jax.grad(lambda a, b, c: (f(a, b, c) ** 2).sum(),
                         argnums=(0, 1, 2))(q, k, v)
        ref[name] = {"o": np.asarray(out), "dq": np.asarray(grads[0]),
                     "dk": np.asarray(grads[1]), "dv": np.asarray(grads[2])}


def _reference_gpt(inp, ref):
    def make(sp_on):
        paddle.seed(23)
        return JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                              sequence_parallel=sp_on))

    m = make(False)
    inp.update({f"gpt.{k}": v for k, v in reference_state(m).items()})
    cfg = m.config
    inp["gpt_config"] = np.array(json.dumps({f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "max_position_embeddings", "hidden_dropout",
        "attention_dropout")}))
    rng = np.random.RandomState(9)
    ids = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    labels = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
    inp["gpt_ids"], inp["gpt_labels"] = ids, labels
    mesh = _mesh(("dp", "sp"), (1, SP))
    prev = jmesh._global_mesh
    jmesh.set_global_mesh(mesh)
    try:
        m2 = make(True)
        assert m2.gpt.layers[0].attn._ring_mesh() is not None
        o2 = paddle.optimizer.SGD(learning_rate=0.01,
                                  parameters=m2.parameters())
        eng = JEngine(m2, o2, lambda mm, i, l: mm.loss(i, l), mesh=mesh)
        losses = [float(eng.train_step(paddle.to_tensor(ids),
                                       paddle.to_tensor(labels)).numpy())
                  for _ in range(3)]
        ref["gpt"] = {"losses": losses, "state": reference_state(m2)}
        # padding (ignore_index) on the tail of each row: 7 of rank 0's
        # 64 tokens, 46 of rank 1's
        pad = labels.copy()
        for row, keep in enumerate((16, 30, 9, 20)):
            pad[row, keep:] = -100
        inp["gpt_labels_pad"] = pad
        m3 = make(True)
        eng = JEngine(m3, paddle.optimizer.SGD(learning_rate=0.1,
                                               parameters=m3.parameters()),
                      lambda mm, i, l: mm.loss(i, l), mesh=mesh)
        tids, tpad = paddle.to_tensor(ids), paddle.to_tensor(pad)
        losses = [float(eng.train_step(tids, tpad).numpy())
                  for _ in range(3)]
        ref["gpt_pad"] = {
            "losses": losses, "state": reference_state(m3),
            "eval": float(eng.eval_step(lambda mm, i, l: mm.loss(i, l),
                                        tids, tpad).numpy())}
    finally:
        jmesh.set_global_mesh(prev)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp")
    inp, ref = {}, {}
    _reference_attention(inp, ref)
    _reference_gpt(inp, ref)
    np.savez(d / "inputs.npz", **inp)
    return spawn_ranks(WORKER, ["sp", d], SP, d, RANK_TIMEOUT_S), ref


def _rows(a, r):
    t = a.shape[1] // SP
    return a[:, r * t:(r + 1) * t]


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_shards_match_reference_shard_map(ranks, name):
    got, ref = ranks
    want = ref[name]
    for r, g in enumerate(got):
        assert g["sp_ranks"] == [0, 1]
        res = g[name]
        np.testing.assert_allclose(res["o"].numpy(), _rows(want["o"], r),
                                   rtol=2e-5, atol=2e-5)
        for key in ("dq", "dk", "dv"):
            np.testing.assert_allclose(res[key].numpy(),
                                       _rows(want[key], r), rtol=1e-4,
                                       atol=1e-4, err_msg=key)


def test_ring_shift_passes_down_and_its_gradient_back(ranks):
    """Rank i's tensor lands on rank i - 1; the gradient goes back up."""
    got, _ = ranks
    for r, g in enumerate(got):
        y, dx = g["ring_shift"]
        assert y.tolist() == [float((r + 1) % 2 + 1)] * 3
        assert dx.tolist() == [float((r - 1) % 2 + 1)] * 3


@pytest.mark.parametrize("what", ["train", "eval"])
def test_gpt_sp2_padded_labels_match_reference(ranks, what):
    """The padding sits on the sequence's tail, so rank 1 holds 18 valid
    labels and rank 0 holds 57: the engine's mean over valid rows is the
    group's (ops/valid_mean.py), which gives the reference's mean over the
    logical batch in the losses, the weights after 3 SGD steps (lr 0.1)
    and ``eval_step``'s loss, which cuts the sequence as ``train_step``
    does (losses rtol 1e-5, weights rtol 1e-4 / atol 1e-6). A mean of the
    ranks' means is 0.25% to 0.34% off in the losses and 0.10% in
    ``eval_step``'s."""
    got, ref = ranks
    want = ref["gpt_pad"]
    for g in got:
        res = g["gpt_pad"]
        if what == "eval":
            np.testing.assert_allclose(float(res["eval"]), want["eval"],
                                       rtol=1e-5)
            continue
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["state"].items():
            np.testing.assert_allclose(res["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)


class _Ranks:
    """A stand-in sequence group: ``split_batch`` reads its size and rank
    only."""

    def __init__(self, nranks, rank):
        self.nranks, self.rank = nranks, rank


def test_split_sequence_raises_when_the_length_does_not_divide():
    x = torch.arange(14).reshape(2, 7)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        tsp.split_sequence(x, _Ranks(2, 1))
    assert tsp.split_sequence(x[:, :6], _Ranks(2, 1)).tolist() == [
        [3, 4, 5], [10, 11, 12]]


# name -> (batch shapes, batch_specs, the shapes of rank 1's shard; None
# when it raises)
SPLITS = {
    "default_cuts_dim1": ([(2, 8), (2, 8), (2,)], None,
                          [(2, 4), (2, 4), (2,)]),
    "spec_names_sp": ([(2, 3, 8), (2, 8)], [(None, None, "sp"),
                                            (("dp",), "sp")],
                      [(2, 3, 4), (2, 4)]),
    "spec_without_sp_keeps_whole": ([(2, 8), (2, 6)], [("dp", "sp"),
                                                       ("dp", None)],
                                    [(2, 4), (2, 6)]),
    "unequal_lengths_need_specs": ([(2, 8), (2, 6)], None, None),
}


@pytest.mark.parametrize("name", sorted(SPLITS))
def test_split_batch_cuts_what_the_specs_name(name):
    shapes, specs, want = SPLITS[name]
    batch = [torch.arange(int(np.prod(s))).reshape(s) for s in shapes]
    if want is None:
        with pytest.raises(ValueError, match="batch_specs"):
            tsp.split_batch(batch, _Ranks(2, 1), specs)
        return
    got = tsp.split_batch(batch, _Ranks(2, 1), specs)
    assert [tuple(g.shape) for g in got] == want
    for b, g in zip(batch, got):  # rank 1 holds the second half
        d = next((i for i in range(b.dim()) if g.shape[i] != b.shape[i]),
                 None)
        assert torch.equal(g, b if d is None
                           else b.narrow(d, g.shape[d], g.shape[d]))


def test_gpt_ring_attention_sp2_matches_reference(ranks):
    got, ref = ranks
    want = ref["gpt"]
    for g in got:
        assert g["gpt"]["ring"] and g["positions_global"]
        np.testing.assert_allclose(g["gpt"]["losses"].numpy(),
                                   want["losses"], rtol=1e-5)
        for k, w in want["state"].items():
            np.testing.assert_allclose(g["gpt"]["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)
