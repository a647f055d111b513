"""Port parity of the Paddle-API training slice as a whole: a tiny GPT
trained by the loop a Paddle user writes (``to_tensor`` ids, ``model.loss``,
``loss.backward()``, ``opt.step()``, ``opt.clear_grad()``, ``sched.step()``)
with AdamW, a ``LinearWarmup(CosineAnnealingDecay)`` schedule, global-norm
clipping and a decay gate on ``p.name``, in both packages from the same
weights (loaded by name through the converter), in f32 with dropout 0.

The loss trajectory is held to rtol 1e-4 (as ``test_torch_train_step.py``
holds its own), the lrs exactly. A resume from ``state_dict()`` after step 3
must continue the trajectory, and ``compile_train_step`` with a
``grad_clip`` must give the reference's compiled trajectory, which applies
no clip, no decay gate and no per-parameter lr scale.
"""
import copy

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from torch_port_util import cpu_device, port_of

STEPS, RESUME_AT = 6, 3
LR, T_MAX, WARMUP, CLIP = 3e-3, 8, 2, 0.5
B, T = 2, 32


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


def _batch():
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1024, (B, T)).astype(np.int64)
    labels = rng.randint(0, 1024, (B, T)).astype(np.int64)
    return ids, labels


def _reference_model():
    paddle.seed(3)
    return JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0,
                          attention_impl="exact"))


def _port_model(jm):
    """The port GPT carrying ``jm``'s weights; ``copy.deepcopy`` of it keeps
    the parameters' names, so the optimizer's state keys carry over."""
    return port_of(jm, attention_impl="exact").train()


def _optimizer(pkg, model, clip=CLIP, weight_decay=0.01):
    decay = [p.name for n, p in model.named_parameters()
             if not n.endswith("bias") and "ln" not in n]
    sched = pkg.optimizer.lr.LinearWarmup(
        pkg.optimizer.lr.CosineAnnealingDecay(LR, T_max=T_MAX),
        warmup_steps=WARMUP, start_lr=0.0, end_lr=LR)
    opt = pkg.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(),
        weight_decay=weight_decay, apply_decay_param_fun=lambda n: n in decay,
        grad_clip=pkg.nn.ClipGradByGlobalNorm(clip))
    return opt, sched


def _eager(pkg, model, opt, sched, steps):
    ids, labels = (pkg.to_tensor(a) for a in _batch())
    losses, lrs = [], []
    for _ in range(steps):
        lrs.append(opt.get_lr())
        loss = model.loss(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss.numpy() if pkg is paddle else loss.item()))
    return losses, lrs


@pytest.fixture(scope="module")
def reference_run():
    jm = _reference_model()
    tm = _port_model(jm)  # before the reference trains
    opt, sched = _optimizer(paddle, jm)
    return tm, _eager(paddle, jm, opt, sched, STEPS)


def test_eager_loop_matches_reference(reference_run):
    tm, (want, want_lrs) = reference_run
    tm = copy.deepcopy(tm)  # deepcopy keeps the parameters' names
    opt, sched = _optimizer(tp, tm)
    assert opt._gate_names == [p.name for p in tm.parameters()]
    got, lrs = _eager(tp, tm, opt, sched, STEPS)
    assert lrs == want_lrs and lrs[0] == 0.0 and lrs[WARMUP] > lrs[-1]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[1]


def test_the_clip_binds(reference_run):
    """At the first step the global norm exceeds the clip, so the clip
    decides the trajectory the test above holds."""
    tm, _ = reference_run
    m = copy.deepcopy(tm)
    ids, labels = (tp.to_tensor(a) for a in _batch())
    m.loss(ids, labels).backward()
    gn = np.sqrt(sum(float((p.grad ** 2).sum()) for p in m.parameters()))
    assert gn > 2 * CLIP


def test_resume_from_state_dict(reference_run):
    tm, (want, _) = reference_run
    tm, fresh = copy.deepcopy(tm), copy.deepcopy(tm)
    opt, sched = _optimizer(tp, tm)
    head, _ = _eager(tp, tm, opt, sched, RESUME_AT)
    model_sd = copy.deepcopy(tm.state_dict())
    opt_sd = copy.deepcopy(opt.state_dict())
    _eager(tp, tm, opt, sched, 1)  # the capture must not follow this step
    assert fresh.set_state_dict(model_sd) == ([], [])
    opt2, sched2 = _optimizer(tp, fresh)
    opt2.set_state_dict(opt_sd)
    assert sorted(opt2._accumulators) == sorted(opt._accumulators)
    assert sched2.last_epoch == RESUME_AT and opt2._step_count == RESUME_AT
    tail, _ = _eager(tp, fresh, opt2, sched2, STEPS - RESUME_AT)
    np.testing.assert_allclose(head + tail, want, rtol=1e-4)


def _compiled(pkg, model, opt, sched, steps):
    step = pkg.jit.compile_train_step(model, lambda m, i, l: m.loss(i, l),
                                      opt)
    batch = [pkg.to_tensor(a) for a in _batch()]
    out = []
    for _ in range(steps):
        loss = step(*batch)
        sched.step()
        out.append(float(loss.numpy() if pkg is paddle else loss.item()))
    return out


def test_compiled_step_stays_unclipped_as_the_reference():
    """The reference's compiled step calls ``_functional_update`` without
    the parameters: no clip, the decay on every parameter, no lr scale. A
    strong decay and an lr scale make both show in the losses."""
    jm = _reference_model()
    tm = _port_model(jm)
    tm_eager = copy.deepcopy(tm)
    for m in (jm, tm, tm_eager):
        m.gpt.final_ln.weight.optimize_attr["learning_rate"] = 10.0
    jopt, jsched = _optimizer(paddle, jm, weight_decay=5.0)
    want = _compiled(paddle, jm, jopt, jsched, STEPS)
    topt, tsched = _optimizer(tp, tm, weight_decay=5.0)
    got = _compiled(tp, tm, topt, tsched, STEPS)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    eopt, esched = _optimizer(tp, tm_eager, weight_decay=5.0)
    eager, _ = _eager(tp, tm_eager, eopt, esched, STEPS)
    assert abs(eager[-1] - got[-1]) > 1e-3 * abs(got[-1])
