"""Port parity of ``paddle_tpu_torch.distributed.engine.HybridParallelEngine``
on the CPU, at one rank.

* The reference's ``TestEngineLadder`` (``tests/test_memory_pressure.py``)
  ported: a transient out-of-memory retried bit-identically; the sticky
  degrade bit-identical to an engine configured with ``grad_accumulate=2``
  from the start; the structured exhaustion with its post-mortem; and
  ``FLAGS_shard_weight_update`` building the ZeRO-1 update where the
  reference's ``maybe_build`` does (its parity: tests/test_torch_zero.py).
* The engine against the reference's engine on ``gpt_tiny`` (float32,
  dropout 0, a one-device ``dp`` mesh), 3 steps at accumulation 1 and 2:
  losses rtol 1e-5; with SGD the parameters rtol 1e-4 / atol 1e-6 (AdamW's
  first steps are close to lr * sign(g), so its parameters are not
  compared there, as in tests/test_torch_train_step.py). The engine's own
  update rule (each parameter's decay gate and lr scale, which the
  reference's engine applies and its compiled step does not) is held
  against the reference's engine with AdamW, a decay gate that leaves out
  the biases and norms and an lr scale of 10 on the final norm: parameters
  after 3 steps within rtol 1e-5 / atol 2e-5 (2% of one step's lr; an
  element whose gradient is near AdamW's epsilon moves up to ~1e-5 between
  the two f32 sum orders, while a wrong gate or scale moves a parameter by
  ~1e-1).
* The accumulation's loss scaling checked against the reference's rule
  ``a + (g / acc).astype(a.dtype)`` computed chunk by chunk: bit-equal in
  float32 and bfloat16.
* The RNG stream restored before a rung, an out-of-memory inside the update
  halting, the sentinel attached, ``DataParallel`` at one rank, a world of
  one over gloo, ``eval_step`` and ``prefetch``; ``prefetch``'s batch
  layout cuts each rank's tokens once at sp 2 (two gloo ranks,
  ``tests/torch_a11_worker.py prefetch``) and a prefetched batch is not
  cut again in the step.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.engine import HybridParallelEngine as JEngine
from paddle_tpu.distributed.mesh import build_mesh as jbuild_mesh
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import DataParallel, HybridParallelEngine
from paddle_tpu_torch.distributed.mesh import Mesh
from paddle_tpu_torch.fault import inject, memory
from paddle_tpu_torch.fault.sentinel import StabilitySentinel
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from torch_port_util import port_of, reference_state

GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
              "max_position_embeddings", "hidden_dropout",
              "attention_dropout")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    prev = flags.get_flags(["FLAGS_shard_weight_update",
                            "FLAGS_hbm_admission"])
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    yield
    inject.disarm()
    flags.set_flags(prev)


def _mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _linear(seed=5):
    pt.seed(seed)
    return pt.nn.Linear(8, 4, device="cpu")


class TestEngineLadder:
    def _run(self, spec=None, accum=1, steps=4):
        inject.disarm()
        if spec:
            inject.arm(spec)
        m = _linear()
        opt = pt.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
        eng = HybridParallelEngine(m, opt, _mse, grad_accumulate=accum)
        losses = []
        for s in range(steps):
            rng = np.random.RandomState(300 + s)
            x = rng.randn(8, 8).astype(np.float32)
            y = rng.randn(8, 4).astype(np.float32)
            losses.append(eng.train_step(x, y).item())
        inject.disarm()
        return losses, [p.detach().clone() for p in m.parameters()], eng

    def test_transient_oom_retry_bit_identical(self):
        l1, w1, e1 = self._run("hbm.oom:op=engine.step,at=2,times=1")
        l2, w2, _ = self._run(None)
        assert e1.grad_accumulate == 1  # the retry recovered; no degrade
        assert l1 == l2
        assert all(torch.equal(a, b) for a, b in zip(w1, w2))

    def test_degrade_bit_identical_to_accumulate_from_start(self):
        """OOM on every full-batch dispatch: the ladder re-runs each step
        through the accumulate path at 2x, bit-identical to an engine
        configured with grad_accumulate=2 from the start (sticky)."""
        d0 = profiler.counters().get("hbm_degraded_steps", 0)
        l1, w1, e1 = self._run("hbm.oom:op=engine.step,from=1")
        l2, w2, _ = self._run(None, accum=2)
        assert e1.grad_accumulate == 2
        assert e1._dispatch_op == "engine.accum"
        assert l1 == l2
        assert all(torch.equal(a, b) for a, b in zip(w1, w2))
        assert profiler.counters().get("hbm_degraded_steps", 0) == d0 + 1

    def test_ladder_exhaustion_halts_structured(self):
        with pytest.raises(memory.HbmExhausted) as ei:
            self._run("hbm.oom:from=1")
        actions = [a["action"] for a in ei.value.attempts]
        assert actions == ["classify", "free_pressure", "retry",
                           "degrade_x2", "degrade_x4"]
        assert memory.is_oom(ei.value.__cause__)
        fp = ei.value.attempts[1]
        assert fp["evicted_executables"] == 0 and "released_bytes" in fp
        doc = json.loads(open(ei.value.dump_path).read())
        assert doc["reason"] == "hbm_exhausted"
        assert doc["extra"]["where"] == "engine.step"
        assert "budget_bytes" in doc["extra"]
        assert isinstance(doc["extra"]["attributions"], list)
        assert [a["action"] for a in doc["extra"]["attempts"]] == actions
        assert "hbm" in doc["context"]

    def test_shard_weight_update_raises_at_dp_gt_1(self):
        """The ZeRO-1 sharded update is built where the reference's
        ``maybe_build`` builds it (its dp = 2 parity is
        tests/test_torch_zero.py); with or without it, an engine at dp = 2
        asks for the world of 2 ranks it needs."""
        from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
            ShardedWeightUpdate

        m = _linear()
        opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
        mesh = Mesh(np.arange(2), ("dp",))
        params = list(m.parameters())
        flags.set_flags({"FLAGS_shard_weight_update": True})
        wus = ShardedWeightUpdate.maybe_build(opt, params, mesh, ("dp",))
        assert isinstance(wus, ShardedWeightUpdate) and wus.nranks == 2
        assert all(b.padded % (2 * 128) == 0 for b in wus.plan.buckets)
        # the reference builds no sharded update for accumulation, a
        # norm-based rule or a mesh with another axis
        assert ShardedWeightUpdate.maybe_build(opt, params, mesh, ("dp",),
                                               grad_accumulate=2) is None
        lamb = pt.optimizer.Lamb(0.1, parameters=m.parameters())
        assert ShardedWeightUpdate.maybe_build(lamb, params, mesh,
                                               ("dp",)) is None
        mesh2 = Mesh(np.arange(4).reshape(2, 2), ("dp", "mp"))
        assert ShardedWeightUpdate.maybe_build(opt, params, mesh2,
                                               ("dp",)) is None
        with pytest.raises(ValueError, match="world of 2"):
            HybridParallelEngine(m, opt, _mse, mesh=mesh)
        flags.set_flags({"FLAGS_shard_weight_update": False})
        assert ShardedWeightUpdate.maybe_build(opt, params, mesh,
                                               ("dp",)) is None
        with pytest.raises(ValueError, match="world of 2"):
            HybridParallelEngine(m, opt, _mse, mesh=mesh)


def test_mesh_axes_beyond_dp_raise():
    """``pp`` and ``ep`` are replica axes, as in the reference's GSPMD
    step: like the mp, sharding and sp axes they need a world of the mesh's
    size (their multi-rank runs: tests/test_torch_pipeline.py and
    test_torch_moe.py). What the reference's step cannot run raises
    naming why: a PipelineLayer holding one stage of a pp group, and a
    MoELayer whose ep_group has more than one rank."""
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp

    m = _linear()
    opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
    for axis in ("pp", "ep", "mp", "sharding", "sp"):
        mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", axis))
        with pytest.raises(ValueError, match="world of 2"):
            HybridParallelEngine(m, opt, _mse, mesh=mesh)
    moe = tmp.MoELayer(8, 16, 4, ep_group=Group(ranks=[0, 1]), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE layer's forward"):
        HybridParallelEngine(moe, pt.optimizer.SGD(
            0.1, parameters=moe.parameters()), _mse,
            mesh=Mesh(np.arange(2).reshape(1, 2), ("dp", "ep")))
    pl = tmp.PipelineLayer([tmp.LayerDesc(pt.nn.Linear, 8, 8, device="cpu")
                            for _ in range(2)], num_stages=2)
    pl._pp_group = Group(ranks=[0, 1])  # as if built over a pp group of 2
    with pytest.raises(NotImplementedError, match="train_batch"):
        HybridParallelEngine(pl, pt.optimizer.SGD(
            0.1, parameters=pl.parameters()), _mse,
            mesh=Mesh(np.arange(2).reshape(1, 2), ("dp", "pp")))
    # a world of one with an axis of one rank runs as before
    mesh = Mesh(np.arange(1).reshape(1, 1), ("dp", "mp"))
    assert HybridParallelEngine(m, opt, _mse, mesh=mesh).dp == 1


def _gpt_pair():
    paddle.seed(1)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    return jm, port_of(jm).train()


def _gpt_batch(seed=3, B=2, T=32):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, T)).astype(np.int64)
    labels = rng.randint(0, 1024, (B, T)).astype(np.int64)
    labels[0, :3] = -100
    return ids, labels


@pytest.mark.parametrize("acc", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_engine_matches_the_reference_engine(opt, acc):
    jm, tm = _gpt_pair()
    ids, labels = _gpt_batch()
    make = {"sgd": lambda mod, ps: mod.SGD(learning_rate=0.1, parameters=ps),
            "adamw": lambda mod, ps: mod.AdamW(learning_rate=1e-3,
                                               parameters=ps)}[opt]
    jeng = JEngine(jm, make(paddle.optimizer, jm.parameters()),
                   lambda m, i, l: m.loss(i, l),
                   mesh=jbuild_mesh(("dp",), (1,)), grad_accumulate=acc)
    want = [float(jeng.train_step(paddle.to_tensor(ids),
                                  paddle.to_tensor(labels)).numpy())
            for _ in range(3)]
    teng = HybridParallelEngine(tm, make(pt.optimizer, tm.parameters()),
                                lambda m, i, l: m.loss(i, l),
                                grad_accumulate=acc)
    got = [teng.train_step(ids, labels).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    if opt == "sgd":
        jst = jm.state_dict()
        for n, p in tm.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jst[n], np.float32),
                                       rtol=1e-4, atol=1e-6, err_msg=n)


def _gated_adamw(pkg, model):
    """AdamW with a strong decay that leaves out the biases and norms, and
    an lr scale of 10 on the final norm's weight."""
    model.gpt.final_ln.weight.optimize_attr["learning_rate"] = 10.0
    decay = {p.name for n, p in model.named_parameters()
             if not n.endswith("bias") and "ln" not in n}
    return pkg.optimizer.AdamW(learning_rate=1e-3,
                               parameters=model.parameters(),
                               weight_decay=5.0,
                               apply_decay_param_fun=lambda n: n in decay)


@pytest.mark.parametrize("acc", [1, 2])
def test_engine_update_gates_and_scales_as_the_reference_engine(acc):
    jm, tm = _gpt_pair()
    ids, labels = _gpt_batch()
    jeng = JEngine(jm, _gated_adamw(paddle, jm), lambda m, i, l: m.loss(i, l),
                   mesh=jbuild_mesh(("dp",), (1,)), grad_accumulate=acc)
    for _ in range(3):
        jeng.train_step(paddle.to_tensor(ids), paddle.to_tensor(labels))
    teng = HybridParallelEngine(tm, _gated_adamw(pt, tm),
                                lambda m, i, l: m.loss(i, l),
                                grad_accumulate=acc)
    for _ in range(3):
        teng.train_step(ids, labels)
    jst = jm.state_dict()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jst[n], np.float32),
                                   rtol=1e-5, atol=2e-5, err_msg=n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_accumulate_scaling_gives_the_reference_rule_bits(dtype):
    """One engine step at grad_accumulate=2 leaves in ``.grad`` exactly
    ``a + (g / 2).astype(a.dtype)`` over the two chunks, ``a`` from zero:
    the reference's accumulate body."""
    cfg = gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    m = GPTForPretraining(cfg, dtype=dtype, device="cpu", seed=4).train()
    ids, labels = (torch.from_numpy(a) for a in _gpt_batch(seed=5))
    want = {n: torch.zeros_like(p) for n, p in m.named_parameters()}
    losses = []
    for i in range(2):
        m.zero_grad(set_to_none=True)
        loss = m.loss(ids[i:i + 1], labels[i:i + 1])
        loss.backward()
        losses.append((loss.detach() / 2).float())
        for n, p in m.named_parameters():
            want[n] = want[n] + (p.grad / 2).to(dtype)
    m.zero_grad(set_to_none=True)
    opt = pt.optimizer.SGD(0.0, parameters=m.parameters())
    eng = HybridParallelEngine(m, opt, lambda mm, i, l: mm.loss(i, l),
                               grad_accumulate=2)
    got_loss = eng.train_step(ids, labels)
    assert torch.equal(got_loss, losses[0] + losses[1])
    for n, p in m.named_parameters():
        assert torch.equal(p.grad, want[n]), n


def test_recovered_step_draws_what_a_healthy_one_would():
    """A real out-of-memory raised inside the loss, after the forward drew
    its dropout masks: the retry restores the RNG stream first, so the
    recovered run equals one that never failed, bit for bit."""
    cfg = gpt_tiny(hidden_dropout=0.1, attention_dropout=0.1)

    def run(fail_at):
        pt.seed(11)
        m = GPTForPretraining(cfg, device="cpu", seed=2).train()
        opt = pt.optimizer.AdamW(1e-3, parameters=m.parameters())
        calls = [0]

        def loss_fn(mm, i, l):
            loss = mm.loss(i, l)
            calls[0] += 1
            if calls[0] == fail_at:
                raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                             "allocate 2.00 GiB")
            return loss

        eng = HybridParallelEngine(m, opt, loss_fn)
        ids, labels = _gpt_batch(seed=6)
        losses = [eng.train_step(ids, labels).item() for _ in range(3)]
        return losses, [p.detach().clone() for p in m.parameters()]

    r0 = profiler.counters().get("hbm_oom_recoveries", 0)
    l1, w1 = run(fail_at=2)
    assert profiler.counters().get("hbm_oom_recoveries", 0) == r0 + 1
    l2, w2 = run(fail_at=0)
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))


def test_oom_inside_the_update_halts(monkeypatch):
    m = _linear()
    opt = pt.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
    eng = HybridParallelEngine(m, opt, _mse)

    def boom(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory (in the update)")

    monkeypatch.setattr(opt, "_update", boom)
    x, y = np.ones((8, 8), np.float32), np.ones((8, 4), np.float32)
    with pytest.raises(memory.HbmExhausted) as ei:
        eng.train_step(x, y)
    assert [a["action"] for a in ei.value.attempts] == ["classify", "halt"]
    assert ei.value.attempts[-1]["why"] == "the update had started"
    assert eng._update_failed


def test_a_failed_update_does_not_halt_a_later_steps_ladder(monkeypatch):
    """An update that raised something other than an out-of-memory marks
    only its own step: a later step's forward out-of-memory runs the
    ladder (free pressure, then a retry that succeeds)."""
    m = _linear()
    opt = pt.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
    fail = {"update": True, "loss": False}
    update = opt._update

    def flaky_update(*a, **k):
        if fail["update"]:
            fail["update"] = False
            raise ValueError("not an out-of-memory")
        return update(*a, **k)

    def loss_fn(mm, x, y):
        if fail["loss"]:
            fail["loss"] = False
            raise torch.OutOfMemoryError("CUDA out of memory.")
        return _mse(mm, x, y)

    monkeypatch.setattr(opt, "_update", flaky_update)
    eng = HybridParallelEngine(m, opt, loss_fn)
    x, y = np.ones((8, 8), np.float32), np.ones((8, 4), np.float32)
    with pytest.raises(ValueError, match="not an out-of-memory"):
        eng.train_step(x, y)
    assert eng._update_failed
    fail["loss"] = True
    eng.train_step(x, y)
    assert [a["action"] for a in eng.last_oom_attempts] == [
        "classify", "free_pressure", "retry"]
    assert not eng._update_failed


class _MemAnchor:
    """An anchor in memory that saves every step's state."""

    def __init__(self):
        self.saved = {}

    def maybe_save(self, step, state):
        self.saved[step] = {k: v.clone() for k, v in state.items()}
        return True

    def resume(self, state, max_step):
        ok = [s for s in self.saved if s <= max_step]
        if not ok:
            return -1
        step = max(ok)
        with torch.no_grad():
            for k, v in self.saved[step].items():
                state[k].copy_(v)
        return step

    def invalidate(self, step):
        self.saved.pop(step, None)

    def protect(self, step):
        pass

    def release(self, step):
        pass


def test_sentinel_attached_rolls_back_a_spiked_step():
    m = _linear()
    opt = pt.optimizer.SGD(0.01, parameters=m.parameters())
    state = dict(m.named_parameters())
    sent = StabilitySentinel(window=16, warmup=3, zmax=8.0,
                             anchor=_MemAnchor(), state=state)
    eng = HybridParallelEngine(m, opt, _mse)
    eng.attach_sentinel(sent)
    inject.arm("loss.spike:at=6,scale=1000")
    verdict = None
    try:
        for s in range(8):
            rng = np.random.RandomState(50 + s)
            eng.train_step(rng.randn(8, 8).astype(np.float32),
                           rng.randn(8, 4).astype(np.float32))
            sent.maybe_anchor(opt._step_count)
            verdict = verdict or sent.take_verdict()
    finally:
        inject.disarm()
    assert verdict is not None and verdict.action == "rollback"
    assert verdict.step == 6 and verdict.signal == "loss"
    assert sent.rollback(verdict) == 5
    sent.close()


def test_data_parallel_at_one_rank_is_the_identity_without_a_prefix():
    m = _linear()
    dp = DataParallel(m)
    assert set(dp.state_dict()) == {"weight", "bias"}
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                         .astype(np.float32))
    _mse(dp, x, torch.zeros(8, 4)).backward()
    grads = [p.grad.clone() for p in m.parameters()]
    c0 = profiler.counters()
    dp.apply_collective_grads()
    c1 = profiler.counters()
    assert all(torch.equal(g, p.grad) for g, p in zip(grads, m.parameters()))
    assert c1.get("dp_buckets", 0) == c0.get("dp_buckets", 0) + 1
    assert c1.get("dp_all_reduces", 0) == c0.get("dp_all_reduces", 0)
    assert dp.scale_loss(3.0) == 3.0


def test_world_of_one_over_gloo_syncs_as_the_identity():
    """A process group of one rank: the engine's DataParallel sync is the
    reference's single-participant identity (buckets counted, no
    all-reduce), and its step equals one without DataParallel, bit for
    bit."""
    from paddle_tpu_torch import distributed as tdist

    x, y = np.ones((4, 8), np.float32), np.zeros((4, 4), np.float32)
    plain = _linear()
    HybridParallelEngine(plain, pt.optimizer.SGD(
        0.1, parameters=plain.parameters()), _mse).train_step(x, y)
    env = tdist.init_parallel_env(device="cpu")
    try:
        assert (env.rank, env.world_size, tdist.get_world_size()) == (0, 1, 1)
        assert tdist.global_mesh().shape == {"dp": 1}
        m = _linear()
        opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
        eng = HybridParallelEngine(DataParallel(m), opt, _mse)
        c0 = profiler.counters()
        eng.train_step(x, y)
        c1 = profiler.counters()
        assert c1.get("dp_all_reduces", 0) == c0.get("dp_all_reduces", 0)
        assert c1.get("dp_buckets", 0) == c0.get("dp_buckets", 0) + 1
        assert all(torch.equal(a, b)
                   for a, b in zip(m.parameters(), plain.parameters()))
    finally:
        tdist.destroy_process_group()
    assert not tdist.is_initialized() and tdist.get_world_size() == 1


def test_eval_step_and_prefetch():
    m = _linear()
    opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
    eng = HybridParallelEngine(m, opt, _mse)
    x = np.ones((2, 8), np.float32)
    out = eng.eval_step(lambda mm, xb: mm(xb), x)
    assert out.shape == (2, 4) and not out.requires_grad
    batches = [(np.full((2, 8), i, np.float32),) for i in range(3)]
    pf = eng.prefetch(batches)
    got = [b[0][0, 0].item() for b in pf]
    assert got == [0.0, 1.0, 2.0]


def test_prefetched_batch_is_not_cut_again(monkeypatch):
    """A batch from ``prefetch`` carries its layout (``placement``), so
    the step does not cut its sequence a second time; a raw batch is cut
    by ``split_batch`` under sequence parallelism."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        sequence_parallel as tsp

    m = _linear()
    opt = pt.optimizer.SGD(0.1, parameters=m.parameters())
    eng = HybridParallelEngine(m, opt, _mse)
    (x, y), = list(eng.prefetch([(np.ones((2, 8), np.float32),
                                  np.zeros((2, 4), np.float32))]))
    assert x.placement == (None, None) and x.logical_shape == (2, 8)
    cuts = []
    monkeypatch.setattr(tsp, "split_batch",
                        lambda b, g, specs: cuts.append(len(b)) or b)
    eng._sp_group = object()  # as under sequence parallelism
    eng.train_step(x, y)
    assert cuts == []
    eng.train_step(np.ones((2, 8), np.float32), np.zeros((2, 4), np.float32))
    assert cuts == [2]


def test_prefetch_cuts_each_ranks_tokens_once_at_sp_2(tmp_path):
    """Two gloo ranks at sp 2 (``tests/torch_a11_worker.py prefetch``):
    ``prefetch`` of the global batch hands each rank its T/2 tokens, and
    ``eval_step`` and a train step on it give the losses of the same
    engine fed the global batch (cut inside the step)."""
    from pathlib import Path

    from torch_port_util import spawn_ranks

    cfg = jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0)
    paddle.seed(9)
    jm = JGPT(cfg)
    rng = np.random.RandomState(2)
    inp = {f"gpt.{k}": v for k, v in reference_state(jm).items()}
    inp["gpt_config"] = np.array(json.dumps(
        {f: getattr(cfg, f) for f in GPT_FIELDS}))
    inp["ids"] = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int64)
    inp["labels"] = rng.randint(0, cfg.vocab_size, (2, 32)).astype(np.int64)
    np.savez(tmp_path / "inputs.npz", **inp)
    worker = Path(__file__).resolve().parent / "torch_a11_worker.py"
    got = spawn_ranks(worker, ["prefetch", tmp_path], 2, tmp_path, 240)
    for g in got:
        r, res = g["sp_rank"], g["prefetch"]
        for (shape, placement, t), full in zip(
                res["batch"], (inp["ids"], inp["labels"])):
            assert shape == (2, 16) and placement == (None, "sp")
            np.testing.assert_array_equal(t.numpy(),
                                          full[:, r * 16:(r + 1) * 16])
        assert res["prefetch"] == res["direct"]


def test_a_recovered_step_leaves_no_reference_cycle():
    """The ladder drops the failed step's frames and tracebacks: once the
    engine is released, its model goes with it by reference counting
    alone (a kept cycle would pin a 7B model until the collector ran)."""
    import gc
    import weakref

    def build():
        m = _linear()
        opt = pt.optimizer.Adam(learning_rate=0.05, parameters=m.parameters())
        calls = [0]

        def loss_fn(mm, x, y):
            loss = _mse(mm, x, y)
            calls[0] += 1
            if calls[0] == 1:
                raise torch.OutOfMemoryError("CUDA out of memory.")
            return loss

        eng = HybridParallelEngine(m, opt, loss_fn)
        eng.train_step(np.ones((8, 8), np.float32), np.ones((8, 4), np.float32))
        assert [a["action"] for a in eng.last_oom_attempts] == [
            "classify", "free_pressure", "retry"]
        return weakref.ref(m)

    gc.disable()
    try:
        ref = build()
        assert ref() is None
    finally:
        gc.enable()
