"""Port parity: ``paddle_tpu_torch.fault`` retry, spike points, preemption
and the stability sentinel against the reference's ``paddle_tpu.fault``.

- ``retry_call``/``retrying``: the same backoff delays, ``on_retry`` calls
  and ``retry_attempts`` counts as the reference's, and the same re-raise.
- ``inject.spike``: the same multipliers at the same calls.
- ``PreemptionGuard``: ``save_now`` once with ``sync=True``, exit with
  ``RESUMABLE_EXIT_CODE``, the signal handlers restored on exit, and
  ``preempt.sigterm`` raising SIGTERM at its step, as the reference does.
- ``StabilitySentinel``: the same scripted signal sequence (loss, gradients,
  parameters, lr) gives the reference's verdicts (step, signal, action;
  value within rtol 1e-5, z within 1e-5 × max(1, |z|): float32 norms summed
  in another order) and its quarantine log; the reference runs with
  ``FLAGS_lazy_async`` off, its synchronous detection. Also the skip rung
  on a tiny GPT (parameters bit-equal, position quarantined), ``halt``'s
  ``StabilityError`` and ``rollback`` against an in-memory anchor.
- ``from_flags`` with ``FLAGS_stability_ckpt_dir`` builds the
  ``AutoCheckpoint`` anchor; ``VerdictBarrier`` at world 2 (two threads
  over a ``FileStore``) gives each rank the reference's agreed verdict and
  quarantine (the most severe, then the highest z; a silent rank adopts
  a peer's); ``for_engine`` on the engine with an ``AutoCheckpoint``
  anchor rolls a spiked step back to the reference's anchor, with the
  reference's losses and weights.
"""
import math
import signal

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprof
from paddle_tpu.fault import inject as jinject
from paddle_tpu.fault import preemption as jpre
from paddle_tpu.fault import retry as jretry
from paddle_tpu.fault import sentinel as jsent

import paddle_tpu_torch as pt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.fault import inject as tinject
from paddle_tpu_torch.fault import preemption as tpre
from paddle_tpu_torch.fault import retry as tretry
from paddle_tpu_torch.fault import sentinel as tsent


@pytest.fixture(autouse=True)
def _clean():
    yield
    jinject.disarm()
    tinject.disarm()
    for mod in (jsent, tsent):
        for s in list(mod._active):
            s.close()
    paddle.set_flags({"FLAGS_lazy_async": True})


# -- retry ----------------------------------------------------------------------

class _Flaky:
    def __init__(self, fails, exc=OSError):
        self.fails, self.exc, self.calls = fails, exc, 0

    def __call__(self, x):
        self.calls += 1
        if self.calls <= self.fails:
            raise self.exc(f"transient {self.calls}")
        return x * 2


def _run_retry(mod, prof, fails, **kw):
    sleeps, seen = [], []
    c0 = prof.counters().get("retry_attempts", 0)
    fn = _Flaky(fails)
    try:
        out = mod.retry_call(fn, 21, sleep=sleeps.append,
                             on_retry=lambda a, e, d: seen.append((a, str(e),
                                                                   d)), **kw)
    except OSError as e:
        out = f"raised {e}"
    return (out, fn.calls, sleeps, seen,
            prof.counters().get("retry_attempts", 0) - c0)


@pytest.mark.parametrize("fails", [0, 2, 3, 5])
def test_retry_call_matches_reference(fails):
    kw = dict(retries=3, base_delay=0.05, max_delay=0.15)
    assert _run_retry(tretry, tprof, fails, **kw) == _run_retry(
        jretry, jprof, fails, **kw)


def test_retry_passes_other_errors_and_decorates():
    fn = _Flaky(1, exc=ValueError)
    with pytest.raises(ValueError):
        tretry.retry_call(fn, 1, sleep=lambda d: None)
    assert fn.calls == 1

    @tretry.retrying(retries=2, sleep=lambda d: None)
    def double(x):
        """doc"""
        return x * 2

    assert double(4) == 8 and double.__name__ == "double"
    assert double.__doc__ == "doc"
    assert issubclass(tinject.InjectedFault, OSError)


# -- spike points -----------------------------------------------------------------

def test_spike_points_match_reference():
    spec = "grad.spike:at=2,scale=10000;loss.spike:step=3,nonfinite=1"
    jinject.arm(spec)
    tinject.arm(spec)
    calls = [("grad.spike", 0), ("grad.spike", 1), ("grad.spike", 2),
             ("loss.spike", 2), ("loss.spike", 3), ("loss.spike", 4)]
    want = [jinject.spike(p, step=s) for p, s in calls]
    got = [tinject.spike(p, step=s) for p, s in calls]
    assert got == want == [None, 10000.0, None, None, math.inf, None]
    assert tinject.fired_counts() == jinject.fired_counts()
    with pytest.raises(KeyError):
        tinject.spike("serve.crash")


# -- preemption ---------------------------------------------------------------

class _Ckpt:
    def __init__(self):
        self.saves = []

    def save_now(self, step, state, sync=False):
        self.saves.append((step, dict(state), sync))


def _preempted_run(mod, spec=None, preempt_at=None):
    ckpt, codes = _Ckpt(), []
    before = signal.getsignal(signal.SIGTERM)
    inject = jinject if mod is jpre else tinject
    if spec:
        inject.arm(spec)
    with mod.PreemptionGuard(checkpoint=ckpt, exit_fn=codes.append) as g:
        assert signal.getsignal(signal.SIGTERM) == g._handler
        for step in range(6):
            if step == preempt_at:
                g.preempt()
            if g.check(step, {"step": step}):
                break
    assert signal.getsignal(signal.SIGTERM) == before
    return ckpt.saves, codes, g.preempted


@pytest.mark.parametrize("how", ["preempt", "sigterm_point"])
def test_preemption_guard_matches_reference(how):
    kw = ({"preempt_at": 4} if how == "preempt"
          else {"spec": "preempt.sigterm:step=2"})
    got = _preempted_run(tpre, **kw)
    want = _preempted_run(jpre, **kw)
    assert got == want
    step = 4 if how == "preempt" else 2
    assert got == ([(step, {"step": step}, True)],
                   [tpre.RESUMABLE_EXIT_CODE], True)
    assert tpre.RESUMABLE_EXIT_CODE == jpre.RESUMABLE_EXIT_CODE == 75


def test_preemption_guard_counts_drains_and_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    c0 = tprof.counters().get("preemption_drains", 0)
    g = tpre.PreemptionGuard(exit_fn=lambda c: None)
    g.preempt()
    assert g.check(0) is True
    assert tprof.counters()["preemption_drains"] == c0 + 1
    assert any("preemption" in p.name for p in tmp_path.iterdir())


# -- sentinel parity ----------------------------------------------------------

KW = dict(window=16, warmup=4, zmax=8.0, max_skips=2, max_rollbacks=1,
          cooldown=100)
SHAPES = [(6, 5), (5,), (3, 4, 2)]


def _script():
    """(loss, grads, params, lr) per step: noise, then a gradient spike, a
    loss spike, a non-finite gradient and a skip-budget exhaustion."""
    rng = np.random.RandomState(0)
    out = []
    for step in range(26):
        loss = np.float32(2.0 + 0.05 * rng.standard_normal())
        grads = [(rng.standard_normal(s) * (1 + 0.05 * rng.standard_normal())
                  ).astype(np.float32) for s in SHAPES]
        params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        if step == 12:
            grads = [g * 100 for g in grads]
        if step == 15:
            loss = np.float32(loss * 50)
        if step == 18:
            grads[1][2] = np.nan
        if step == 23:
            grads = [g * 1000 for g in grads]
        out.append((loss, grads, params, 1e-3 * (1 + step % 3)))
    return out


def _observe_all(mod, to_t):
    s = mod.StabilitySentinel(**KW)
    verdicts = []
    for step, (loss, grads, params, lr) in enumerate(_script()):
        v = s.observe(step, loss=to_t(np.asarray(loss)),
                      grads=[to_t(g) for g in grads],
                      params=[to_t(p) for p in params], lr=lr,
                      pos=(0, step), sample_indices=[2 * step, 2 * step + 1])
        if v is not None:
            verdicts.append(v.to_dict())
    return verdicts, s.quarantine.entries(), s


def _close(a, b, rtol=1e-5):
    if isinstance(a, float) and (math.isinf(a) or math.isnan(a)):
        return (math.isinf(b) and a == b) or (math.isnan(a) and math.isnan(b))
    return abs(a - b) <= rtol * max(1.0, abs(b))


def test_sentinel_verdicts_and_quarantine_match_reference():
    paddle.set_flags({"FLAGS_lazy_async": False})
    want, wq, _ = _observe_all(jsent, paddle.to_tensor)
    got, gq, s = _observe_all(tsent, torch.from_numpy)
    assert [(v["step"], v["signal"], v["action"]) for v in got] == [
        (v["step"], v["signal"], v["action"]) for v in want]
    assert [v["action"] for v in got] == ["skip", "skip", "halt", "halt"]
    for g, w in zip(got, want):
        assert g["pos"] == w["pos"] and g["late"] is w["late"] is False
        assert _close(g["value"], w["value"]) and _close(g["zscore"],
                                                         w["zscore"])
        for k in tsent.SIGNALS:
            assert _close(g["signals"][k], w["signals"][k]), k
    assert [(e["step"], e["pos"], e["sample_indices"], e["action"])
            for e in gq] == [(e["step"], e["pos"], e["sample_indices"],
                              e["action"]) for e in wq]
    assert s.is_quarantined(pos=(0, 12)) and not s.is_quarantined(pos=(0, 3))
    ls = tsent.last_signals()
    assert set(ls) == set(tsent.SIGNALS) | {"loss_ema"}


def test_nonfinite_share_is_exact():
    s = tsent.StabilitySentinel(**KW)
    g = [torch.ones(10), torch.ones(30)]
    g[1][:3] = float("inf")
    v = s.observe(0, loss=torch.tensor(1.0), grads=g)
    assert v.signal == "nonfinite" and v.value == pytest.approx(3 / 40)
    v = s.observe(1, loss=torch.tensor(float("nan")), grads=[torch.ones(4)])
    assert v.signal == "nonfinite" and v.value == 1.0
    v = s.observe(2, loss=float("inf"))  # a host number, as the reference
    assert v.signal == "nonfinite" and v.value == 1.0


def test_halt_raises_stability_error_with_a_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FLIGHT_DIR", str(tmp_path))
    s = tsent.StabilitySentinel(**KW)
    v = s.observe(0, grads=[torch.tensor([float("inf")])])
    with pytest.raises(tsent.StabilityError, match="nonfinite") as ei:
        s.halt(v)
    assert ei.value.verdict is v and ei.value.history
    assert any("stability_halt" in p.name for p in tmp_path.iterdir())


def test_from_flags_anchor_waits_for_a11(tmp_path):
    """``FLAGS_stability_ckpt_dir`` builds the reference's anchor: an
    ``AutoCheckpoint`` there, every ``FLAGS_stability_anchor_interval``
    steps, keeping 2."""
    from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint

    pt.set_flags({"FLAGS_stability_ckpt_dir": str(tmp_path / "anchor"),
                  "FLAGS_stability_anchor_interval": 3})
    try:
        s = tsent.StabilitySentinel.from_flags()
    finally:
        pt.set_flags({"FLAGS_stability_ckpt_dir": "",
                      "FLAGS_stability_anchor_interval": 25})
    assert isinstance(s.anchor, AutoCheckpoint)
    assert (s.anchor.save_dir, s.anchor.interval, s.anchor.keep_last) == (
        str(tmp_path / "anchor"), 3, 2)
    s.close()
    s = tsent.StabilitySentinel.from_flags(warmup=2)
    assert (s.window, s.warmup, s.zmax) == (64, 2, 8.0)
    assert s.anchor is None


def test_skip_rung_on_a_tiny_gpt_leaves_parameters_bit_equal():
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny

    m = GPTForPretraining(gpt_tiny(hidden_dropout=0.0, attention_dropout=0.0),
                          device="cpu")
    params = m.parameters()
    opt = pt.optimizer.AdamW(1e-3, parameters=params)
    s = tsent.StabilitySentinel(window=16, warmup=3)
    rng = np.random.RandomState(0)
    tinject.arm("grad.spike:step=5,scale=10000")
    skipped = []
    for step in range(7):
        ids = torch.from_numpy(rng.randint(0, 1024, (2, 16)))
        loss = m.loss(ids, ids)
        loss.backward()
        s.note_batch((0, step))
        spiked = s.maybe_spike([p.grad for p in params], step=step)
        for p, g in zip(params, spiked):
            p.grad = g
        before = [p.detach().clone() for p in params]
        v = s.observe(step, loss, [p.grad for p in params], params,
                      lr=opt.get_lr())
        if v is None:
            opt.step()
        else:
            skipped.append((step, v.action, v.signal, v.pos))
            assert all(torch.equal(a, p) for a, p in zip(before, params))
        opt.clear_grad()
    assert skipped == [(5, "skip", "grad_norm", (0, 5))]
    assert s.is_quarantined(pos=(0, 5))


class _MemAnchor:
    """An anchor in memory: ``maybe_save`` every ``every`` steps."""

    def __init__(self, every):
        self.every, self.saved, self.calls = every, {}, []

    def maybe_save(self, step, state):
        if step % self.every:
            return False
        self.saved[step] = {k: v.clone() for k, v in state.items()}
        return True

    def resume(self, state, max_step):
        ok = [s for s in self.saved if s <= max_step]
        if not ok:
            return -1
        step = max(ok)
        for k, v in self.saved[step].items():
            state[k].copy_(v)
        return step

    def invalidate(self, step):
        self.calls.append(("invalidate", step))
        self.saved.pop(step, None)

    def protect(self, step):
        self.calls.append(("protect", step))

    def release(self, step):
        self.calls.append(("release", step))


def test_rollback_restores_the_newest_clean_anchor():
    w = torch.zeros(4)
    state = {"w": w}
    anchor = _MemAnchor(every=3)
    s = tsent.StabilitySentinel(window=16, warmup=3, anchor=anchor,
                                state=state)
    rng = np.random.RandomState(1)
    verdict = None
    for step in range(10):
        w += 1.0  # the update of this step, already applied
        g = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
        if step == 7:
            g = g * 1e4
        verdict = s.observe(step, grads=[g], committed=True)
        s.maybe_anchor(step)
        if verdict is not None:
            break
    # the spike of step 7 is judged at step 8's observe: late, so rollback
    assert (verdict.step, verdict.action, verdict.late) == (7, "rollback",
                                                            True)
    anchor_step = s.rollback(verdict)
    assert anchor_step == 6 and torch.equal(w, torch.full((4,), 7.0))
    assert ("protect", 6) in anchor.calls
    assert s.is_quarantined(step=7)
    s.close()
    assert ("release", 6) in anchor.calls


def test_rollback_without_anchor_halts():
    s = tsent.StabilitySentinel(**KW)
    v = tsent.StabilityVerdict("rollback", 3, None, "loss", 9.0, 50.0, True,
                               {})
    with pytest.raises(tsent.StabilityError, match="no anchor"):
        s.rollback(v)


# -- the A11c hooks: VerdictBarrier, for_engine --------------------------------
def _barrier_round(mod, store_mod, d, verdicts):
    """One ``VerdictBarrier.exchange`` round of two ranks (threads over a
    FileStore): each rank's agreed verdict and its sentinel's quarantine."""
    import threading

    store = store_mod.FileStore(str(d))
    sents = [mod.StabilitySentinel(**KW) for _ in range(2)]
    bars = [mod.VerdictBarrier(store, 2, r, sentinel=sents[r], timeout_s=30)
            for r in range(2)]
    out = [None, None]

    def run(r):
        v = verdicts[r]
        if v is not None:
            v = mod.StabilityVerdict(*v)
        out[r] = bars[r].exchange(v)

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    res = [(o.action, o.step, o.signal, o.origin_rank) if o else None
           for o in out]
    quar = [[(e["step"], e["action"]) for e in s.quarantine.entries()]
            for s in sents]
    for s in sents:
        s.close()
    return res, quar


BARRIER_CASES = {
    # rank 0 skips, rank 1 rolls back: both leave with the rollback; rank 0
    # was outranked (its own rung spent), nothing adopted there
    "severity": [("skip", 5, (0, 5), "loss", 9.0, 20.0, False, {}),
                 ("rollback", 5, (0, 5), "grad_norm", 9.0, 12.0, True, {})],
    # only rank 1 tripped: rank 0 adopts its verdict and quarantines
    "adopt": [None, ("skip", 7, (0, 7), "loss", 9.0, 30.0, False, {})],
    # equal severity: the higher z wins
    "zscore": [("skip", 3, None, "loss", 9.0, 10.0, False, {}),
               ("skip", 3, None, "upd_ratio", 9.0, 40.0, False, {})],
    "quiet": [None, None],
}


@pytest.mark.parametrize("case", sorted(BARRIER_CASES))
def test_verdict_barrier_at_world_2_adopts_the_most_severe_verdict(
        case, tmp_path):
    from paddle_tpu.distributed import coord as jcoord
    from paddle_tpu_torch.distributed import coord as tcoord

    verdicts = BARRIER_CASES[case]
    got = _barrier_round(tsent, tcoord, tmp_path / "t", verdicts)
    want = _barrier_round(jsent, jcoord, tmp_path / "r", verdicts)
    assert got == want
    if case == "adopt":
        assert got == ([("skip", 7, "loss", 1), ("skip", 7, "loss", None)],
                       [[(7, "skip")], []])


def _engine_rollback_run(pkg, d):
    """A Linear trained by SGD through the engine with a sentinel from
    ``for_engine`` on an ``AutoCheckpoint`` anchor (every 2 steps); the
    batch of step 6 spikes. Returns the losses, each verdict's rollback
    and the weights after it."""
    rng = np.random.RandomState(4)
    w0 = rng.randn(4, 1).astype(np.float32)
    batches = [(rng.randn(8, 4).astype(np.float32),
                rng.randn(8, 1).astype(np.float32)) for _ in range(9)]
    if pkg == "port":
        from paddle_tpu_torch.distributed import HybridParallelEngine
        from paddle_tpu_torch.distributed.checkpoint import AutoCheckpoint
        lin = pt.nn.Linear(4, 1, device="cpu")
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w0))
            lin.bias.zero_()
        opt = pt.optimizer.SGD(learning_rate=0.05,
                               parameters=lin.parameters())
        conv, inj, sent = torch.from_numpy, tinject, tsent
        weight = lambda: lin.weight.detach().numpy().copy()  # noqa: E731
    else:
        from paddle_tpu.distributed.checkpoint import AutoCheckpoint
        from paddle_tpu.distributed.engine import HybridParallelEngine
        from paddle_tpu.distributed.mesh import build_mesh
        lin = paddle.nn.Linear(4, 1)
        lin.weight.set_value(w0)
        lin.bias.set_value(np.zeros(1, np.float32))
        opt = paddle.optimizer.SGD(learning_rate=0.05,
                                   parameters=lin.parameters())
        conv, inj, sent = paddle.to_tensor, jinject, jsent
        weight = lambda: np.asarray(lin.weight.numpy()).copy()  # noqa: E731
    kw = {} if pkg == "port" else {"mesh": build_mesh(("dp",), (1,))}
    eng = HybridParallelEngine(lin, opt,
                               lambda m, x, y: ((m(x) - y) ** 2).mean(), **kw)
    anchor = AutoCheckpoint(str(d), interval_steps=2, keep_last=2)
    s = sent.StabilitySentinel.for_engine(eng, anchor, window=16, warmup=3,
                                          zmax=8.0, max_rollbacks=1)
    inj.arm({"loss.spike": {"step": 6, "scale": 1000}})
    log = []
    for k in range(1, 9):
        s.note_batch((0, k))
        loss = eng.train_step(*(conv(a) for a in batches[k]))
        log.append(("loss", k, float(np.asarray(
            loss.detach() if pkg == "port" else loss.numpy()))))
        s.maybe_anchor(opt._step_count)
        v = s.take_verdict()
        if v is not None:
            a = s.rollback(v)
            log.append(("rollback", v.step, v.action, a, opt._step_count,
                        weight()))
    inj.disarm()
    s.close()
    return log


def test_for_engine_rolls_back_to_the_anchor_as_the_reference(tmp_path):
    paddle.set_flags({"FLAGS_lazy_async": False})
    got = _engine_rollback_run("port", tmp_path / "t")
    want = _engine_rollback_run("ref", tmp_path / "r")
    assert [e[:5] if e[0] == "rollback" else e[:2] for e in got] \
        == [e[:5] if e[0] == "rollback" else e[:2] for e in want]
    rb = [e for e in got if e[0] == "rollback"]
    assert [e[1:5] for e in rb] == [(6, "rollback", 4, 4)]
    for g, w in zip(got, want):
        if g[0] == "loss":
            np.testing.assert_allclose(g[2], w[2], rtol=1e-5)
        else:
            np.testing.assert_allclose(g[5], w[5], rtol=1e-6)
