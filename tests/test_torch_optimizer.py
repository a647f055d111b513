"""Port parity: ``paddle_tpu_torch.optimizer`` update rules against the JAX
package's ``_functional_update`` (the rule its compiled train step runs).

Both packages start from the same parameters and see the same gradient
sequence, made with numpy from a seed; k steps later the parameters must
agree. f32: within 1e-6 (the port fuses some products into one rounding
where XLA rounds twice). bf16: within 2 bf16 ulps of the reference's value,
since XLA may keep excess f32 precision inside its fused update where the
port rounds after each foreach op, and one ulp of drift can carry over.
"""
from types import SimpleNamespace

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
    p0, grads = _data()
    ps = _port_params(p0, torch.float32)
    opt = topt.SGD(LR, parameters=ps)
    ps[0].grad = torch.from_numpy(grads[0][0])
    before = ps[1].detach().clone()
    opt.step()
    assert torch.equal(ps[1], before)
    opt.clear_grad()
    assert torch.count_nonzero(ps[0].grad) == 0
    opt.clear_grad(set_to_zero=False)
    assert ps[0].grad is None


def test_unported_options_raise():
    p = torch.zeros(2, requires_grad=True)
    with pytest.raises(NotImplementedError, match="clip"):
        topt.SGD(LR, parameters=[p], grad_clip=object())
    with pytest.raises(TypeError, match="lr.py"):
        topt.SGD(object(), parameters=[p])
