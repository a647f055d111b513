"""Port parity of distributed training (``paddle_tpu_torch.distributed``)
over two gloo ranks on the CPU.

One group of two processes (``tests/torch_dist_worker.py``) runs every
multi-rank check once for the whole file; each test reads what the ranks
wrote. The ranks are started with ``subprocess`` and a time limit, so a
rank that hangs fails the fixture (and every test of the file), never the
suite's clock.

* the collectives against numpy on the ranks' seeded inputs (exact, or
  rtol 1e-6 where a sum of two float32 values is compared);
* the quantized all-reduce-mean against the reference's blockwise
  quantization on the same inputs (rtol 1e-6: the same float32 ops);
* the model-parallel helpers over both ranks against the single-rank
  computation (rtol 1e-5, float32 sum order);
* ``build_bucket_plan`` against the reference's (exact geometry);
* ``DataParallel``'s eager loop and ``HybridParallelEngine`` at dp = 2 on
  half batches against ``paddle_tpu``'s engine on a 2-device ``dp`` mesh on
  the full batch, as ``tests/test_distributed.py`` builds them (float32
  sum order only: losses rtol 1e-5, weights rtol 1e-4 / atol 1e-5; GPT
  1e-4 and 1e-3 / 1e-5, the reference test's own); GPT again on labels
  padded unevenly over the two halves, through 2 steps and ``eval_step``.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.fleet import grad_buckets as jgb
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.framework import flags as jflags
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.fleet import grad_buckets as tgb

HERE = Path(__file__).resolve().parent
WORKER = HERE / "torch_dist_worker.py"
RANK_TIMEOUT_S = 240


def _x(rank, shape=(4, 6), seed=0):
    return np.random.RandomState(seed + 10 * rank).randn(*shape).astype(
        np.float32)


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _reference(d):
    """The reference's runs on its 2-device dp mesh (replicated update),
    and the inputs the ranks read."""
    inp, ref = {}, {}
    old = jflags.flag("FLAGS_shard_weight_update")
    jflags.set_flags({"FLAGS_shard_weight_update": False})
    try:
        rng = np.random.RandomState(5)
        x = rng.rand(16, 8).astype(np.float32)
        y = rng.rand(16, 4).astype(np.float32)
        inp["mlp_x"], inp["mlp_y"] = x, y
        for acc in (1, 2):
            paddle.seed(7)
            m = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(),
                               jnn.Linear(16, 4))
            if acc == 1:
                inp.update({f"mlp.{k}": np.asarray(v, np.float32)
                            for k, v in m.state_dict().items()})
            o = paddle.optimizer.SGD(learning_rate=0.1,
                                     parameters=m.parameters())
            eng = JEngine(m, o, _mse, mesh=jbuild_mesh(("dp",), (2,)),
                          grad_accumulate=acc)
            ref[f"mlp_losses_{acc}"] = [
                float(eng.train_step(paddle.to_tensor(x),
                                     paddle.to_tensor(y)).numpy())
                for _ in range(3)]
            ref[f"mlp_state_{acc}"] = {k: np.asarray(v, np.float32)
                                       for k, v in m.state_dict().items()}
        paddle.seed(21)
        cfg = jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
        gm = JGPT(cfg)
        inp.update({f"gpt.{k}": np.asarray(v, np.float32)
                    for k, v in gm.state_dict().items()})
        inp["gpt_config"] = np.array(json.dumps({
            f: getattr(cfg, f) for f in (
                "vocab_size", "hidden_size", "num_layers", "num_heads",
                "max_position_embeddings", "hidden_dropout",
                "attention_dropout")}))
        rng = np.random.RandomState(3)
        ids = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
        labels = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int64)
        inp["gpt_ids"], inp["gpt_labels"] = ids, labels
        o = paddle.optimizer.SGD(learning_rate=0.01,
                                 parameters=gm.parameters())
        eng = JEngine(gm, o, lambda m, i, l: m.loss(i, l),
                      mesh=jbuild_mesh(("dp",), (2,)))
        ref["gpt_loss"] = float(eng.train_step(
            paddle.to_tensor(ids), paddle.to_tensor(labels)).numpy())
        ref["gpt_wte"] = np.asarray(
            gm.gpt.embeddings.word_embeddings.weight.numpy(), np.float32)
        # padding (ignore_index) mostly in rank 1's half of the batch
        pad = labels.copy()
        pad[2:, 4:] = -100
        pad[1, 28:] = -100
        inp["gpt_labels_pad"] = pad
        paddle.seed(21)
        gm = JGPT(cfg)
        eng = JEngine(gm, paddle.optimizer.SGD(learning_rate=0.1,
                                               parameters=gm.parameters()),
                      lambda m, i, l: m.loss(i, l),
                      mesh=jbuild_mesh(("dp",), (2,)))
        tids, tpad = paddle.to_tensor(ids), paddle.to_tensor(pad)
        ref["gpt_pad"] = {
            "losses": [float(eng.train_step(tids, tpad).numpy())
                       for _ in range(2)],
            "eval": float(eng.eval_step(lambda m, i, l: m.loss(i, l), tids,
                                        tpad).numpy()),
            "state": {k: np.asarray(v, np.float32)
                      for k, v in gm.state_dict().items()}}
    finally:
        jflags.set_flags({"FLAGS_shard_weight_update": old})
    np.savez(d / "inputs.npz", **inp)
    return ref


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    ref = _reference(d)
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PADDLE_TRAINERS_NUM="2",
                   PADDLE_TRAINER_ID=str(r),
                   PADDLE_TRAINER_ENDPOINTS=f"127.0.0.1:{port}",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=str(HERE.parent))
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(d)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a gloo rank did not finish in {RANK_TIMEOUT_S}s")
    got = []
    for r, p in enumerate(procs):
        f = d / f"rank{r}.pt"
        assert p.returncode == 0 and f.exists(), \
            f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
        res = torch.load(f, weights_only=False)
        assert "error" not in res, res["error"]
        got.append(res)
    return got, ref


def test_ranks_joined_one_world(ranks):
    got, _ = ranks
    assert [(g["rank"], g["world"]) for g in got] == [(0, 2), (1, 2)]


def _expect(name):
    """What every rank (or rank r, as a list) should hold for ``name``."""
    a, b = _x(0), _x(1)
    both = np.stack([a, b])
    return {
        "all_reduce_sum": a + b,
        "all_reduce_max": np.maximum(a, b),
        "all_reduce_min": np.minimum(a, b),
        "all_reduce_prod": a * b,
        "all_reduce_avg": (a + b) / 2,
        "all_gather_list": both,
        "all_gather_stacked": both,
        "all_gather_into_tensor_0": np.concatenate([a, b], 0),
        "all_gather_into_tensor_1": np.concatenate([a, b], 1),
        "reduce_scatter_list": [a[:2] + b[:2], a[2:] + b[2:]],
        "reduce_scatter_tensor": [a[:2] + b[:2], a[2:] + b[2:]],
        "broadcast_src1": b,
        "scatter_src0": [a[:2], a[2:]],
        "alltoall": [np.stack([a[:2], b[:2]]), np.stack([a[2:], b[2:]])],
        "alltoall_single": [np.concatenate([a[:2], b[:2]]),
                            np.concatenate([a[2:], b[2:]])],
        "group_all_reduce": a + b,
        "split": [np.stack(np.split(a, 2, axis=1)),
                  np.stack(np.split(b, 2, axis=1))],
    }[name]


@pytest.mark.parametrize("name", [
    "all_reduce_sum", "all_reduce_max", "all_reduce_min", "all_reduce_prod",
    "all_reduce_avg", "all_gather_list", "all_gather_stacked",
    "all_gather_into_tensor_0", "all_gather_into_tensor_1",
    "reduce_scatter_list", "reduce_scatter_tensor", "broadcast_src1",
    "scatter_src0", "alltoall", "alltoall_single", "group_all_reduce",
    "split"])
def test_collective_matches_numpy(ranks, name):
    got, _ = ranks
    want = _expect(name)
    for r in range(2):
        w = want[r] if isinstance(want, list) else want
        np.testing.assert_allclose(got[r][name].numpy(), w, rtol=1e-6,
                                   atol=0, err_msg=f"rank {r}")


def test_reduce_lands_on_dst_and_groups_count_their_ranks(ranks):
    got, _ = ranks
    np.testing.assert_allclose(got[1]["reduce_dst1"].numpy(),
                               _x(0) + _x(1), rtol=1e-6)
    for r in range(2):
        assert got[r]["group"].tolist() == [2, r, 1, 2]


def test_p2p_raises_as_the_reference(ranks):
    got, _ = ranks
    assert got[0]["p2p_raised"] == ["send", "recv", "isend", "irecv"]
    for fn in (C.send, C.recv, C.isend, C.irecv):
        with pytest.raises(NotImplementedError, match="p2p"):
            fn(torch.zeros(1))


def test_quantized_all_reduce_mean_matches_reference_blockwise(ranks):
    """The reference's blockwise int8 (EQuARX) arithmetic, replayed here
    with its own quantizer: each rank's shard i is the mean of both ranks'
    dequantized shard i, re-quantized, and gathered."""
    from paddle_tpu.distributed import collective as jcol

    got, _ = ranks
    flats = [_x(r, (512,), seed=3) * (1 + r) for r in range(2)]
    qs = [jcol.blockwise_quantize(f, 128) for f in flats]
    deq = [np.asarray(jcol.blockwise_dequantize(q, s)) for q, s in qs]
    shards = [(deq[0][i * 256:(i + 1) * 256] + deq[1][i * 256:(i + 1) * 256])
              / 2 for i in range(2)]
    want = np.concatenate([np.asarray(jcol.blockwise_dequantize(
        *jcol.blockwise_quantize(s, 128))) for s in shards])
    for r in range(2):
        np.testing.assert_allclose(got[r]["quant_mean"].numpy(), want,
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(got[r]["quant_err"].numpy(),
                                   flats[r] - deq[r], rtol=1e-6, atol=1e-7)


def test_blockwise_quantize_matches_reference():
    from paddle_tpu.distributed import collective as jcol

    flat = _x(0, (1024,), seed=9) * 3
    jq, js = jcol.blockwise_quantize(flat, 128)
    tq, ts = C.blockwise_quantize(torch.from_numpy(flat), 128)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(C.blockwise_dequantize(tq, ts).numpy(),
                               np.asarray(jcol.blockwise_dequantize(jq, js)),
                               rtol=1e-7)


def _single_rank_mp():
    """The helpers' layers computed on one rank with the whole weights."""
    from paddle_tpu_torch.nn.functional.loss import cross_entropy

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
    out = {}
    for tag in ("col", "row"):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = xs @ ws
        (y * torch.arange(6.0)).sum().backward()
        out[tag] = (y.detach(), xs.grad, ws.grad)
    logits = torch.from_numpy(rng.randn(5, 10).astype(np.float32))
    labels = torch.from_numpy(np.array([0, 9, 4, 5, -100], np.int64))
    lg = logits.clone().requires_grad_()
    loss = cross_entropy(lg, labels, reduction="none", ignore_index=-100)
    (loss * torch.arange(1.0, 6.0)).sum().backward()
    out["ce"] = (loss.detach(), lg.grad)
    return out


def test_mp_helpers_over_two_ranks_match_the_single_rank_layer(ranks):
    got, _ = ranks
    one = _single_rank_mp()
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in range(2):
        g = got[r]
        y, dx, dw = one["col"]
        np.testing.assert_allclose(g["col_y"], y, **tol)
        np.testing.assert_allclose(g["col_dx"], dx, **tol)
        np.testing.assert_allclose(g["col_dw"], dw[:, r * 3:(r + 1) * 3],
                                   **tol)
        y, dx, dw = one["row"]
        np.testing.assert_allclose(g["row_y"], y, **tol)
        np.testing.assert_allclose(g["row_dx"], dx, **tol)
        np.testing.assert_allclose(g["row_dw"], dw[r * 4:(r + 1) * 4], **tol)
        loss, dl = one["ce"]
        np.testing.assert_allclose(g["ce_loss"], loss, **tol)
        np.testing.assert_allclose(g["ce_dlogits"], dl[:, r * 5:(r + 1) * 5],
                                   **tol)
    assert got[0]["ce_loss"][-1] == 0 and not got[0]["ce_dlogits"][-1].any()


@pytest.mark.parametrize("nranks,bucket_bytes,block", [
    (1, None, 128), (2, 4096, 128), (4, 1 << 14, 64), (8, 300, 128)])
def test_build_bucket_plan_matches_reference(nranks, bucket_bytes, block):
    shapes = [(16, 8), (8,), (8, 33), (33,), (5, 7, 3), (1,), (64, 64)]
    dts = ["float32", "float32", "bfloat16", "bfloat16", "float32",
           "float32", "float32"]
    jparams = []
    for s, dt in zip(shapes, dts):
        t = paddle.zeros(s, dtype=dt)
        jparams.append(t)
    tparams = [torch.zeros(s, dtype=getattr(torch, dt))
               for s, dt in zip(shapes, dts)]
    jp = jgb.build_bucket_plan(jparams, nranks=nranks,
                               bucket_bytes=bucket_bytes, block=block)
    tp = tgb.build_bucket_plan(tparams, nranks=nranks,
                               bucket_bytes=bucket_bytes, block=block)
    assert len(tp) == len(jp) > 1
    for jb, tb in zip(jp.buckets, tp.buckets):
        assert (tb.indices, tb.shapes, tb.sizes, tb.offsets, tb.size,
                tb.padded, tb.itemsize) == (
                    jb.indices, jb.shapes, jb.sizes, jb.offsets, jb.size,
                    jb.padded, jb.itemsize)
        assert str(tb.dtype).replace("torch.", "") == str(jb.dtype)
    for q in (False, True):
        assert tp.sync_bytes(q) == jp.sync_bytes("all_reduce", q)
    # the flat view round-trips the gradients of its bucket
    rng = np.random.RandomState(0)
    b = tp.buckets[0]
    arrs = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(b.dtype)
            for s in b.shapes]
    flat = tp.flatten(b, arrs)
    assert flat.shape == (b.padded,) and not flat[b.size:].any()
    for a, v in zip(arrs, tp.unflatten(b, flat)):
        assert torch.equal(a, v)


def test_data_parallel_eager_loop_matches_the_reference_dp_mesh(ranks):
    got, ref = ranks
    want = ref["mlp_state_1"]
    for r in range(2):
        st = got[r]["dp_state"]
        assert set(st) == set(want)  # no wrapper prefix
        for k in want:
            np.testing.assert_allclose(st[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
            assert torch.equal(st[k], got[0]["dp_state"][k])


@pytest.mark.parametrize("acc", [1, 2])
def test_engine_at_dp2_matches_the_reference_dp_mesh(ranks, acc):
    got, ref = ranks
    for r in range(2):
        np.testing.assert_allclose(
            got[r][f"mlp_engine_losses_{acc}"].numpy(),
            ref[f"mlp_losses_{acc}"], rtol=1e-5)
        st, want = got[r][f"mlp_engine_state_{acc}"], ref[f"mlp_state_{acc}"]
        for k in want:
            np.testing.assert_allclose(st[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_gpt_engine_at_dp2_matches_the_reference_dp_mesh(ranks):
    got, ref = ranks
    for r in range(2):
        np.testing.assert_allclose(float(got[r]["gpt_loss"]),
                                   ref["gpt_loss"], rtol=1e-4)
        np.testing.assert_allclose(got[r]["gpt_wte"].numpy(), ref["gpt_wte"],
                                   rtol=1e-3, atol=1e-5)
        assert got[r]["dp_buckets"] >= 1  # the gradients went through buckets


@pytest.mark.parametrize("what", ["train", "eval"])
def test_gpt_engine_at_dp2_weights_padded_labels_as_the_reference(ranks,
                                                                   what):
    """Rank 0's half holds 60 valid labels, rank 1's 8: the engine's mean
    over valid rows is the global one (ops/valid_mean.py), so the losses,
    the weights after 2 SGD steps (lr 0.1) and ``eval_step``'s loss match
    the reference's logical batch (losses rtol 1e-5, weights rtol 1e-4 /
    atol 1e-6). A mean of the ranks' means is 0.29% and 3.1% off in the
    two losses and 8.3% in ``eval_step``'s."""
    got, ref = ranks
    want = ref["gpt_pad"]
    for r in range(2):
        res = got[r]["gpt_pad"]
        if what == "eval":
            np.testing.assert_allclose(float(res["eval"]), want["eval"],
                                       rtol=1e-5)
            continue
        np.testing.assert_allclose(res["losses"].numpy(), want["losses"],
                                   rtol=1e-5)
        for k, w in want["state"].items():
            np.testing.assert_allclose(res["state"][k].numpy(), w,
                                       rtol=1e-4, atol=1e-6, err_msg=k)


def test_shard_weight_update_raises_at_dp2(ranks):
    """``FLAGS_shard_weight_update`` at dp = 2 builds the ZeRO-1 sharded
    update (it used to raise): with SGD its reduce-scatter, shard update
    and all-gather give the reference dp mesh's replicated update (rtol
    1e-4 / atol 1e-5, float32 sum order), and each rank keeps no moment.
    Its AdamW and quantized parity: tests/test_torch_zero.py."""
    got, ref = ranks
    for r in range(2):
        assert got[r]["zero_built"] == [True, 2]
        np.testing.assert_allclose(got[r]["zero_losses"].numpy(),
                                   ref["mlp_losses_1"], rtol=1e-5)
        for k, want in ref["mlp_state_1"].items():
            np.testing.assert_allclose(got[r]["zero_state"][k].numpy(),
                                       want, rtol=1e-4, atol=1e-5, err_msg=k)
