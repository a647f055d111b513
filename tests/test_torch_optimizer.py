"""Port parity: ``paddle_tpu_torch.optimizer`` update rules against the JAX
package's ``_functional_update`` (the rule its compiled train step runs), and
the eager ``step()`` with a scheduler, a grad clip, ``L1Decay``, per-parameter
lr scales and the decay gate on ``p.name`` against the reference's eager
``step()``.

Both packages start from the same parameters and see the same gradient
sequence, made with numpy from a seed; k steps later the parameters must
agree. f32: within 1e-6 (the port fuses some products into one rounding
where XLA rounds twice). bf16: within 2 bf16 ulps of the reference's value,
since XLA may keep excess f32 precision inside its fused update where the
port rounds after each foreach op, and one ulp of drift can carry over.
"""
from types import SimpleNamespace

import jax

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import optimizer as topt

NAMES = ["w0", "b0", "w1"]
SHAPES = [(6, 5), (5,), (4, 6)]
STEPS = 5
LR = 0.01

CASES = {
    "sgd": (lambda o, **k: o.SGD(LR, **k), {}),
    "sgd_l2": (lambda o, **k: o.SGD(LR, weight_decay=0.05, **k), {}),
    "momentum": (lambda o, **k: o.Momentum(LR, momentum=0.9, **k), {}),
    "nesterov": (lambda o, **k: o.Momentum(LR, momentum=0.9,
                                           use_nesterov=True, **k), {}),
    "adam": (lambda o, **k: o.Adam(LR, **k), {}),
    "adamw": (lambda o, **k: o.AdamW(LR, weight_decay=0.01, **k), {}),
    "adamw_decay_fun": (lambda o, **k: o.AdamW(
        LR, weight_decay=0.5,
        apply_decay_param_fun=lambda n: not n.startswith("b"), **k), {}),
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return p0, grads


def _reference(case, p0, grads, dtype):
    opt = CASES[case][0](paddle.optimizer, parameters=[])
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ps = [jnp.asarray(p, jdt) for p in p0]
    params = [SimpleNamespace(name=n) for n in NAMES]
    state = {"t": jnp.float32(1.0),
             "accums": [opt._init_accums(p) for p in ps]}
    for gs in grads:
        ps, state = opt._functional_update(
            ps, [jnp.asarray(g, jdt) for g in gs], state, jnp.float32(LR),
            params)
    return [np.asarray(p.astype(jnp.float32)) for p in ps]


def _port_params(p0, dtype):
    return [torch.from_numpy(p).to(dtype).requires_grad_() for p in p0]


def _port_steps(opt, ps, grads, dtype):
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()


def _ulp(x):
    """One bf16 ulp at each element of the f32 array x."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case, dtype):
    p0, grads = _data()
    want = _reference(case, p0, grads, dtype)
    ps = _port_params(p0, dtype)
    opt = CASES[case][0](topt, parameters=list(zip(NAMES, ps)))
    _port_steps(opt, ps, grads, dtype)
    assert opt._step_count == STEPS
    for name, p, w in zip(NAMES, ps, want):
        got = p.detach().float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, w, atol=1e-6, rtol=1e-6,
                                       err_msg=name)
        else:
            ulps = np.abs(got - w) / _ulp(w)
            assert ulps.max() <= 2, (name, float(ulps.max()))


def test_adam_moments_stay_in_parameter_dtype():
    p0, grads = _data()
    ps = _port_params(p0, torch.bfloat16)
    opt = topt.AdamW(LR, parameters=ps)
    _port_steps(opt, ps, grads[:1], torch.bfloat16)
    sd = opt.state_dict()
    assert sd["@step"] == 1
    assert {k for k in sd if k != "@step"} == {
        f"param_{i}.{m}" for i in range(3) for m in ("moment1", "moment2")}
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items() if k != "@step")


def test_state_dict_round_trip_continues_the_same_trajectory():
    p0, grads = _data(seed=1)
    ps = _port_params(p0, torch.float32)
    opt = topt.AdamW(LR, parameters=list(zip(NAMES, ps)))
    _port_steps(opt, ps, grads[:2], torch.float32)
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in opt.state_dict().items()}
    qs = [p.detach().clone().requires_grad_() for p in ps]
    opt2 = topt.AdamW(LR, parameters=list(zip(NAMES, qs)))
    opt2.set_state_dict(sd)
    assert opt2._step_count == 2
    _port_steps(opt, ps, grads[2:], torch.float32)
    _port_steps(opt2, qs, grads[2:], torch.float32)
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)


def test_step_skips_parameters_without_grad_and_clear_grad():
    """``clear_grad()`` drops the gradients whatever ``set_to_zero`` says,
    as the reference's does (``paddle_tpu/core/tensor.py:162``)."""
    p0, grads = _data()
    ps = _port_params(p0, torch.float32)
    opt = topt.SGD(LR, parameters=ps)
    ps[0].grad = torch.from_numpy(grads[0][0])
    before = ps[1].detach().clone()
    opt.step()
    assert torch.equal(ps[1], before)
    opt.clear_grad()
    assert ps[0].grad is None
    ps[0].grad = torch.from_numpy(grads[0][0])
    opt.clear_grad(set_to_zero=False)
    assert ps[0].grad is None


def test_unported_options_raise():
    """``grad_clip`` and an ``LRScheduler`` learning rate, which raised until
    ``nn/clip.py`` and ``optimizer/lr.py`` were ported, are accepted:
    ``get_lr()`` reads the scheduler and ``step()`` calls the clip."""
    p = torch.zeros(2, requires_grad=True)
    calls = []

    def clip(params_grads):
        calls.append(len(params_grads))
        return params_grads

    sched = topt.lr.StepDecay(0.5, step_size=1, gamma=0.1)
    opt = topt.SGD(sched, parameters=[p], grad_clip=clip)
    assert opt.get_lr() == 0.5
    p.grad = torch.ones(2)
    opt.step()
    assert calls == [1]
    sched.step()
    assert opt.get_lr() == sched() == 0.5 * 0.1


# -- the eager step against the reference's -----------------------------------
def _sched(o):
    return o.lr.LinearWarmup(o.lr.CosineAnnealingDecay(LR, T_max=4),
                             warmup_steps=2, start_lr=0.0, end_lr=LR)


def _clip(pkg, kind, *a):
    return getattr(pkg.nn, kind)(*a)


def _tpkg():
    import paddle_tpu_torch
    return paddle_tpu_torch


EAGER = {
    # name: (make(optimizer module, package, parameters) -> (opt, sched),
    #        per-parameter attributes)
    "scheduler": (lambda o, pk, ps: (lambda s: (o.AdamW(s, parameters=ps),
                                                s))(_sched(o)), {}),
    "clip_global": (lambda o, pk, ps: (o.AdamW(
        LR, parameters=ps,
        grad_clip=_clip(pk, "ClipGradByGlobalNorm", 0.5)), None), {}),
    "clip_global_sgd": (lambda o, pk, ps: (o.SGD(
        LR, parameters=ps,
        grad_clip=_clip(pk, "ClipGradByGlobalNorm", 0.5)), None), {}),
    "clip_norm_sgd": (lambda o, pk, ps: (o.SGD(
        LR, parameters=ps, grad_clip=_clip(pk, "ClipGradByNorm", 0.5)),
        None), {}),
    "clip_value_sgd": (lambda o, pk, ps: (o.SGD(
        LR, parameters=ps, grad_clip=_clip(pk, "ClipGradByValue", 0.5)),
        None), {}),
    "need_clip_off": (lambda o, pk, ps: (o.SGD(
        LR, parameters=ps,
        grad_clip=_clip(pk, "ClipGradByGlobalNorm", 0.5)), None),
        {"w0": {"need_clip": False}}),
    "l1_decay": (lambda o, pk, ps: (o.Momentum(
        LR, parameters=ps, weight_decay=o.L1Decay(0.05)), None), {}),
    "param_lr": (lambda o, pk, ps: (o.Adam(LR, parameters=ps), None),
                 {"b0": {"learning_rate": 0.5}, "w1": {"learning_rate": 0.1}}),
    "decay_gate": (lambda o, pk, ps: (o.AdamW(
        LR, parameters=ps, weight_decay=0.5,
        apply_decay_param_fun=lambda n: n.startswith("w")), None), {}),
}


def _apply_attrs(p, attrs):
    for k, v in attrs.items():
        if k == "learning_rate":
            p.optimize_attr["learning_rate"] = v
        else:
            setattr(p, k, v)


def _reference_eager(case, p0, grads):
    from paddle_tpu.core.tensor import Parameter as JParameter

    make, attrs = EAGER[case]
    ps = [JParameter(p, name=n) for n, p in zip(NAMES, p0)]
    for n, p in zip(NAMES, ps):
        _apply_attrs(p, attrs.get(n, {}))
    opt, sched = make(paddle.optimizer, paddle, ps)
    lrs = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = paddle.to_tensor(g)
        lrs.append(opt.get_lr())
        opt.step()
        if sched is not None:
            sched.step()
    return [np.asarray(p.numpy()) for p in ps], lrs


@pytest.mark.parametrize("case", sorted(EAGER))
def test_eager_step_matches_reference(case):
    """The port's parameters are ``Parameter``s named as the reference's and
    given as ``(structured name, parameter)`` pairs, so the decay gate must
    read ``p.name`` (``w0``, ...), not the pair's name (``layer.w0``)."""
    from paddle_tpu_torch.core.tensor import Parameter

    p0, grads = _data(seed=4)
    want, want_lrs = _reference_eager(case, p0, grads)
    make, attrs = EAGER[case]
    ps = [Parameter(torch.from_numpy(p.copy()), name=n)
          for n, p in zip(NAMES, p0)]
    for n, p in zip(NAMES, ps):
        _apply_attrs(p, attrs.get(n, {}))
    opt, sched = make(topt, _tpkg(), [(f"layer.{p.name}", p) for p in ps])
    lrs = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        lrs.append(opt.get_lr())
        opt.step()
        if sched is not None:
            sched.step()
    assert lrs == want_lrs
    for name, p, w in zip(NAMES, ps, want):
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    # the clip leaves p.grad unclipped, as the reference's step does
    np.testing.assert_array_equal(ps[0].grad.numpy(), grads[-1][0])


def test_scheduler_state_rides_in_the_optimizer_state_dict():
    ps = _port_params(_data()[0], torch.float32)
    sched = _sched(topt)
    opt = topt.AdamW(sched, parameters=ps)
    for _ in range(3):
        sched.step()
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 3
    sched2 = _sched(topt)
    opt2 = topt.AdamW(sched2, parameters=ps)
    opt2.set_state_dict(sd)
    assert sched2.last_epoch == 3 and opt2.get_lr() == opt.get_lr()


def test_param_attr_lr_scale_and_minimize_match_reference():
    """``ParamAttr(learning_rate=...)`` reaches the update as the
    parameter's lr scale, and ``minimize(loss)`` is backward then step."""
    import paddle_tpu_torch as tp

    rng = np.random.RandomState(6)
    w0 = rng.randn(3, 2).astype(np.float32)
    x = rng.randn(4, 3).astype(np.float32)

    def run(pkg, to_np):
        lin = pkg.nn.Linear(3, 2, weight_attr=pkg.ParamAttr(
            learning_rate=0.5, initializer=pkg.nn.initializer.Assign(w0)))
        opt = pkg.optimizer.SGD(LR, parameters=lin.parameters())
        for _ in range(2):
            opt.minimize(pkg.sum(pkg.square(lin(pkg.to_tensor(x)))))
            opt.clear_grad()
        return to_np(lin.weight), to_np(lin.bias)

    want = run(paddle, lambda t: np.asarray(t.numpy()))
    from torch_port_util import cpu_device
    with cpu_device():
        got = run(tp, lambda t: t.detach().numpy())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert not np.allclose(got[0], w0)


# -- the rules of Adamax, RMSProp, Adagrad, Adadelta, Lamb and LarsMomentum ----
# Three steps, eager (the reference's ``step()``, the port's ``step()``) and
# compiled (the reference's ``_functional_update``, the port's
# ``_step(functional=True)``), in f32 and bf16. Every parameter and every
# accumulator is held to the reference's, under the same ``state_dict()``
# key and in the same dtype: f32 within rtol = atol = 1e-6, bf16 within one
# bf16 ulp (the two packages round after the same ops; only the f32 norms of
# Lamb and LARS sum in another order). The elementwise rules read bit-equal
# in bf16. The fourth step runs on an optimizer
# rebuilt from the third step's ``state_dict()`` and must equal the
# uninterrupted one.
NEW_STEPS = 3

NEW_RULES = {
    "adamax": lambda o, ps: o.Adamax(LR, parameters=ps),
    "rmsprop": lambda o, ps: o.RMSProp(LR, parameters=ps),
    "rmsprop_centered": lambda o, ps: o.RMSProp(
        LR, momentum=0.9, centered=True, parameters=ps),
    "adagrad": lambda o, ps: o.Adagrad(LR, initial_accumulator_value=0.1,
                                       parameters=ps),
    "adadelta": lambda o, ps: o.Adadelta(0.5, parameters=ps),
    "lamb": lambda o, ps: o.Lamb(LR, lamb_weight_decay=0.01, parameters=ps),
    "lamb_exclude": lambda o, ps: o.Lamb(
        LR, lamb_weight_decay=0.3, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: p.name.startswith("b")),
    "lars": lambda o, ps: o.LarsMomentum(LR, parameters=ps),
    # b0 starts at 0: its norm is 0, so its local lr is 1
    "lars_zero_norm": lambda o, ps: o.LarsMomentum(
        LR, lars_weight_decay=0.01, parameters=ps),
}


def _new_data(case):
    p0, grads = _data(seed=7)
    if case == "lars_zero_norm":
        p0[1] = np.zeros_like(p0[1])
    return p0, grads[:NEW_STEPS + 1]


def _ref_new(case, p0, grads, dtype, mode):
    """The reference's parameters and state_dict after each step, as
    (dtype name, f32 numpy) pairs."""
    from paddle_tpu.core.tensor import Parameter as JParameter

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ps = [JParameter(jnp.asarray(p, jdt), name=n) for n, p in zip(NAMES, p0)]
    opt = NEW_RULES[case](paddle.optimizer, ps)
    out = []
    state = None
    for gs in grads:
        if mode == "eager":
            for p, g in zip(ps, gs):
                p.grad = paddle.to_tensor(jnp.asarray(g, jdt))
            opt.step()
            sd = opt.state_dict()
            got = {k: v._data for k, v in sd.items() if k != "@step"}
            params = [p._data for p in ps]
        else:
            arrs = [p._data for p in ps]
            if state is None:
                state = opt._functional_state(ps)
            # jitted, and with no parameters (so no decay gate), as the
            # reference's CompiledTrainStep runs it
            arrs, state = jax.jit(opt._functional_update)(
                arrs, [jnp.asarray(g, jdt) for g in gs], state,
                jnp.float32(opt.get_lr()))
            for p, a in zip(ps, arrs):
                p._set_data(a)
            got = {f"{n}.{k}": v for n, st in zip(NAMES, state["accums"])
                   for k, v in st.items()}
            params = arrs
        snap = {n: (str(a.dtype), np.asarray(a.astype(jnp.float32)))
                for n, a in zip(NAMES, params)}
        snap.update({k: (str(v.dtype), np.asarray(v.astype(jnp.float32)))
                     for k, v in got.items()})
        out.append(snap)
    return out


def _port_new(case, p0, grads, dtype, mode, rebuild_after=None):
    from paddle_tpu_torch.core.tensor import Parameter

    ps = [Parameter(torch.from_numpy(p.copy()).to(dtype), name=n)
          for n, p in zip(NAMES, p0)]
    opt = NEW_RULES[case](topt, ps)
    out = []
    for i, gs in enumerate(grads):
        for p, g in zip(ps, gs):
            # in the parameter's dtype, which Lamb may have promoted (the
            # reference casts the gradient to it)
            p.grad = torch.from_numpy(g).to(dtype).to(p.dtype)
        opt._step(functional=(mode == "compiled"))
        sd = opt.state_dict()
        snap = {n: (str(p.dtype).replace("torch.", ""),
                    p.detach().float().numpy().copy())
                for n, p in zip(NAMES, ps)}
        snap.update({k: (str(v.dtype).replace("torch.", ""),
                         v.float().numpy().copy())
                     for k, v in sd.items() if k != "@step"})
        out.append(snap)
        if rebuild_after == i + 1:
            sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                  for k, v in sd.items()}
            ps = [Parameter(p.detach().clone(), name=p.name) for p in ps]
            opt = NEW_RULES[case](topt, ps)
            opt.set_state_dict(sd)
            assert opt._step_count == i + 1
    return out


def _assert_close(got, want, what, dtype):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in sorted(want):
        (gd, g), (wd, w) = got[k], want[k]
        assert gd == wd, (what, k, gd, wd)
        # a bf16 run's values that Lamb promoted to f32 carry its bf16 trust
        # ratio, rounded from f32 norms summed in another order: one bf16
        # ulp of the ratio can flip, so they are held to one bf16 ulp too
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{what} {k}")
        else:
            ulps = np.abs(g - w) / _ulp(w)
            assert ulps.max() <= 1, (what, k, float(ulps.max()))


@pytest.mark.parametrize("mode", ["eager", "compiled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(NEW_RULES))
def test_new_rule_matches_reference(case, dtype, mode):
    p0, grads = _new_data(case)
    want = _ref_new(case, p0, grads, dtype, mode)
    got = _port_new(case, p0, grads, dtype, mode)
    for i, (g, w) in enumerate(zip(got[:NEW_STEPS], want)):
        _assert_close(g, w, f"{case} step {i + 1}", dtype)
    resumed = _port_new(case, p0, grads, dtype, mode,
                        rebuild_after=NEW_STEPS)
    for k, (gd, g) in got[NEW_STEPS].items():
        rd, r = resumed[NEW_STEPS][k]
        assert gd == rd and np.array_equal(g, r), (case, k)
    _assert_close(got[NEW_STEPS], want[NEW_STEPS], f"{case} step 4", dtype)


def test_lamb_promotes_a_bf16_parameter_to_f32_as_the_reference():
    """The reference's f32 bias corrections make Lamb's update f32, so a
    bf16 parameter leaves the first step as f32 with bf16 moments, and the
    moments turn f32 on the second (``paddle_tpu/optimizer/__init__.py``
    ``Lamb._rule``)."""
    p0, grads = _new_data("lamb")
    got = _port_new("lamb", p0, grads[:2], torch.bfloat16, "eager")
    assert got[0]["w0"][0] == "float32"
    assert got[0]["w0.moment1"][0] == "bfloat16"
    assert got[1]["w0.moment1"][0] == "float32"
    other = _port_new("adamax", p0, grads[:2], torch.bfloat16, "eager")
    assert other[1]["w0"][0] == "bfloat16"


def test_lamb_exclude_fn_sees_the_parameter():
    from paddle_tpu_torch.core.tensor import Parameter

    seen = []
    p = Parameter(torch.ones(3), name="ln.bias")
    opt = topt.Lamb(LR, parameters=[("layer.ln.bias", p)],
                    exclude_from_weight_decay_fn=lambda q: seen.append(q)
                    or True)
    p.grad = torch.ones(3)
    opt.step()
    assert len(seen) == 1 and seen[0] is p


def test_elementwise_rule_flags_match_reference():
    for name in ("Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
                 "RMSProp", "Adagrad", "Adadelta", "Lamb", "LarsMomentum"):
        assert getattr(topt, name)._elementwise_rule == getattr(
            paddle.optimizer, name)._elementwise_rule, name
