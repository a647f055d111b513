"""Port parity of the table-driven ops (``paddle_tpu_torch.ops.generated``
over ``ops.json``) against the JAX package's (``paddle_tpu.ops.generated``
over ``ops.yaml``): one case per spec name, on the reference sweep's own
sampled inputs (``tests/test_op_sweep.py`` ``_inputs_for``: its domains and
shapes, seed 7) or, for the entries its sampler skips, inputs made for
them here.

Tolerances: float32 outputs rtol 1e-5, atol 1e-6; the special functions
(``SPECIAL``) rtol 1e-4; complex outputs by absolute error; integer and
bool outputs exactly; every dtype by name. Gradients of the differentiable
ops (the first output's sum) are held against the reference's tape with
the same rtol and atol 1e-5 (an input the output does not depend on has a
zero gradient in the reference and none in torch); ``sinc``'s at atol
5e-5, since near 0 both tapes' float32 formulas cancel. An alias must
resolve to the port's op of the same target name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.ops import generated as R
from paddle_tpu_torch.ops import generated as P
from test_op_sweep import _GRAD_EXCLUDE, _inputs_for
from torch_port_util import assert_same, cpu_device, flat_outputs

SPECIAL = {"gammaln", "gammainc", "gammaincc", "polygamma", "i0e", "i1e",
           "ndtr", "ndtri", "log_ndtr", "entr", "logit", "erfc", "expit",
           "xlogy", "xlog1py", "matrix_exp", "cbrt", "float_power"}


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


def _bespoke(name, rng):
    """Inputs for the entries the reference sweep's sampler skips."""
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "sgn": lambda: [np.array([[-1.5, 0.0, 2.0], [0.0, -0.3, 4.0]],
                                 np.float32)],
        "kthvalue": lambda: [f(2, 5)],
        "index_put": lambda: [f(4, 3), np.array([2, 0], np.int32), f(2, 3)],
        "masked_scatter": lambda: [f(2, 3), (rng.rand(2, 3) > 0.5).astype(
            np.float32), f(2, 3)],
        "unique_with_counts": lambda: [rng.randint(0, 3, (2, 4)).astype(
            np.float32)],
        "fill_diagonal_tensor": lambda: [f(4, 4), f(4)],
        "im2sequence": lambda: [f(2, 3, 4, 4)],
        "dpsgd": lambda: [f(2, 3), f(2, 3)],
    }[name]()


def _inputs(name, rng):
    spec = R.SPECS[name]
    return _bespoke(name, rng) if spec.get("skip_test") \
        else _inputs_for(spec, rng)


def _call(pkg, gen, name, inputs, grad=False):
    spec = R.SPECS[name]
    tensors = [pkg.to_tensor(a, stop_gradient=not (
        grad and np.asarray(a).dtype.kind == "f")) for a in inputs]
    out = gen.GENERATED[name](tensors if spec.get("variadic") else None) \
        if spec.get("variadic") else gen.GENERATED[name](*tensors)
    return tensors, out


def test_the_table_holds_the_reference_names_sections_and_fields():
    assert set(P.SPECS) == set(R.SPECS) and len(P.SPECS) == 183
    for name, r in R.SPECS.items():
        p = P.SPECS[name]
        assert p["section"] == r["section"], name
        keep = {k: v for k, v in r.items() if k not in ("expr", "ref")}
        assert {k: v for k, v in p.items() if k != "expr"} == keep, name
        assert ("expr" in p) == ("expr" in r), name
    assert set(P.GENERATED) == set(R.GENERATED)


@pytest.mark.parametrize("name", sorted(R.SPECS))
def test_generated_op_matches_reference(name):
    spec = R.SPECS[name]
    if spec.get("alias_of"):
        target = spec["alias_of"]
        fn = P.GENERATED[name]
        assert fn is P.GENERATED.get(target, getattr(tp, target)), name
        assert getattr(tp, name, fn) is fn
        return
    inputs = _inputs(name, np.random.RandomState(7))
    _, want = _call(paddle, R, name, inputs)
    _, got = _call(tp, P, name, inputs)
    got, want = flat_outputs(got), flat_outputs(want)
    assert len(got) == len(want), name
    rtol = 1e-4 if name in SPECIAL else 1e-5
    for i, (g, w) in enumerate(zip(got, want)):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert_same(g, w, rtol=rtol, what=f"{name}[{i}]")


def _grad_names():
    out = []
    for n, s in sorted(R.SPECS.items()):
        if s.get("alias_of") or s.get("skip_test") or not s.get("grad", True):
            continue
        if s.get("variadic") or not s.get("args", ["x"]):
            continue
        if n in _GRAD_EXCLUDE or 0 in s.get("nondiff", ()):
            continue
        out.append(n)
    return out


@pytest.mark.parametrize("name", _grad_names())
def test_generated_op_gradient_matches_reference_tape(name):
    inputs = _inputs(name, np.random.RandomState(9))
    jt, jout = _call(paddle, R, name, inputs, grad=True)
    tt, tout = _call(tp, P, name, inputs, grad=True)
    jout, tout = flat_outputs(jout)[0], flat_outputs(tout)[0]
    jout.sum().backward()
    if tout.requires_grad:  # else the output does not depend on the inputs
        tout.sum().backward()
    rtol = 1e-4 if name in SPECIAL else 1e-5
    atol = 5e-5 if name == "sinc" else 1e-5
    for i, (j, t) in enumerate(zip(jt, tt)):
        if np.asarray(inputs[i]).dtype.kind != "f":
            continue
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        assert_same(g, j.grad, rtol=rtol, atol=atol, what=f"{name} d/dx{i}")


def test_every_op_casts_by_name_under_amp():
    """Each table op passes its inputs through ``amp_cast`` with its own
    name: a custom white-list entry turns a float32 op into bfloat16."""
    x = tp.to_tensor(np.random.RandomState(0).rand(2, 3).astype(np.float32))
    with tp.amp.auto_cast(custom_white_list={"sinc"}):
        assert P.GENERATED["sinc"](x).dtype == torch.bfloat16
    assert P.GENERATED["sinc"](x).dtype == torch.float32
