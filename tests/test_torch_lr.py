"""Port parity of ``paddle_tpu_torch.optimizer.lr``: each of the reference's
15 schedulers over 30 steps gives the same lr sequence as the JAX package's,
exactly (both are plain Python floats), and a ``state_dict`` round trip
continues the same sequence.
"""
import copy

import pytest

import paddle_tpu as paddle
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 30
# ReduceOnPlateau's metric: falls, then stalls long enough to cut the lr
METRICS = [1.0 - 0.1 * min(i, 6) for i in range(STEPS)]

SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 9, 20],
                                                 [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=12,
                                                   end_lr=0.001, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=7, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=5,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(1e-4, T_max=16), warmup_steps=4,
        start_lr=0.0, end_lr=1e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.3, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.2, milestones=[4, 10, 25],
                                                 gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.2, step_size=7, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.9 if e % 2 else 0.99),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.1, T_max=12, eta_min=0.01),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     step_size_down=6),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=3, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.1, step_size_up=5, mode="exp_range", exp_gamma=0.9),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, factor=0.5,
                                                   patience=2, cooldown=1),
}


def _run(sched, steps, start=0):
    out = []
    for i in range(start, start + steps):
        out.append(sched())
        if isinstance(sched, (tlr.ReduceOnPlateau,
                              paddle.optimizer.lr.ReduceOnPlateau)):
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


def test_every_reference_scheduler_is_ported():
    names = {n for n, v in vars(paddle.optimizer.lr).items()
             if isinstance(v, type)
             and issubclass(v, paddle.optimizer.lr.LRScheduler)
             and v is not paddle.optimizer.lr.LRScheduler}
    assert len(names) == 15
    assert names <= {k.split("_")[0] for k in SCHEDULERS}
    assert all(issubclass(getattr(tlr, n), tlr.LRScheduler) for n in names)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_sequence_equals_reference(name):
    want = _run(SCHEDULERS[name](paddle.optimizer.lr), STEPS)
    got = _run(SCHEDULERS[name](tlr), STEPS)
    assert got == want
    assert len(set(got)) > 1


def _resumed(mod, name):
    """10 steps, a deep-copied capture, 5 more steps the capture must not
    follow, then a fresh scheduler from the capture for the last 20."""
    sched = SCHEDULERS[name](mod)
    head = _run(sched, 10)
    state = copy.deepcopy(sched.state_dict())
    _run(sched, 5, start=10)
    fresh = SCHEDULERS[name](mod)
    fresh.set_state_dict(state)
    return head + _run(fresh, STEPS - 10, start=10)


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_state_dict_round_trip_continues_the_sequence(name):
    """The resumed lrs equal the reference's resumed lrs, and the
    uninterrupted run's: except MultiplicativeDecay's, whose running lr
    ``_cur`` the reference's ``state_dict`` leaves out (it keeps only the
    attributes without a leading underscore), so both restart it from the
    base lr."""
    want = _resumed(paddle.optimizer.lr, name)
    got = _resumed(tlr, name)
    assert got == want
    uninterrupted = _run(SCHEDULERS[name](tlr), STEPS)
    assert (got == uninterrupted) == (name != "MultiplicativeDecay")
