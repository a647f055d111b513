"""``jit.to_static``'s control-flow conversion (``jit/dy2static.py``) against
the reference's (``paddle_tpu/jit/dy2static.py``), on the CPU, float32.

The 16 cases of ``tests/test_dy2static.py`` run through both packages on
the same inputs (and the same weights, copied by name): outputs and
gradients within 1e-5 (the same ops in float32; the reference compiles
them with XLA, the port runs them eagerly). Where the reference raises at
the call (a ``return`` inside a tensor branch reads a traced value under
``jax.jit``), the port's eager call runs the Python branch and its export
(``concrete_program``) raises the same ``TypeError``. Then the converted
function's ``torch.export`` program: its graph holds ``cond`` and
``while_loop`` nodes and its outputs equal the eager ones on inputs that
take each branch.
"""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_reference_state_dict
from torch_port_util import cpu_device

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _t(pkg, a):
    return pkg.to_tensor(np.asarray(a, dtype=np.float32))


def _both(make, *inputs):
    """make(pkg) -> fn; the reference's ``to_static(fn)`` and the port's on
    the same numpy inputs, as numpy."""
    outs = []
    for pkg in (paddle, tp):
        st = pkg.jit.to_static(make(pkg))
        args = [pkg.to_tensor(a) for a in inputs]
        outs.append(np.asarray(st(*args).numpy()))
    return outs


def _check(make, *inputs):
    ref, got = _both(make, *inputs)
    np.testing.assert_allclose(got, ref, **TOL)
    return got


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _i64(a):
    return np.asarray(a, dtype=np.int64)


# -- TestIfElse ---------------------------------------------------------------
@pytest.mark.parametrize("a", [[1.0, 2.0, 3.0], [-1.0, -2.0, -3.0]])
def test_tensor_if_both_paths(a):
    def make(pkg):
        def fn(x):
            if x.mean() > 0:
                y = x * 2.0
            else:
                y = x - 1.0
            return y
        return fn

    _check(make, _f32(a))


def test_if_updates_existing_var():
    def make(pkg):
        def fn(x):
            y = x + 1.0
            if x.sum() > 100.0:
                y = y * 10.0
            else:
                y = y / 2.0
            return y
        return fn

    _check(make, _f32([1.0, 2.0]))


@pytest.mark.parametrize("a", [[1.0, 5.0], [1.0, 1.5], [-1.0, -2.0]])
def test_nested_if(a):
    def make(pkg):
        def fn(x):
            if x.mean() > 0:
                if x.max() > 2.0:
                    y = x * 3.0
                else:
                    y = x * 2.0
            else:
                y = -x
            return y
        return fn

    _check(make, _f32(a))


def test_python_if_still_works():
    def make(pkg):
        def fn(x, flag=True):
            if flag:  # plain python predicate
                return x + 1.0
            return x - 1.0
        return fn

    np.testing.assert_allclose(_check(make, _f32([1.0])), [2.0])


# -- TestWhile ----------------------------------------------------------------
def test_tensor_bounded_while():
    def make(pkg):
        def fn(x):
            s = x * 0.0
            i = pkg.to_tensor(np.float32(0.0))
            while i < 5.0:
                s = s + x
                i = i + 1.0
            return s
        return fn

    np.testing.assert_allclose(_check(make, _f32([1.0, 2.0])), [5.0, 10.0])


def test_while_data_dependent_condition():
    def make(pkg):
        def fn(x):
            while x.sum() < 100.0:
                x = x * 2.0
            return x
        return fn

    _check(make, _f32([1.0, 2.0]))


# -- TestLogical --------------------------------------------------------------
@pytest.mark.parametrize("a", [[1.0, 2.0], [1.0, 20.0], [-1.0, -2.0]])
def test_and_or_not_on_tensors(a):
    def make(pkg):
        def fn(x):
            if (x.mean() > 0.0) and (x.max() < 10.0):
                y = x + 1.0
            else:
                y = x - 1.0
            return y
        return fn

    _check(make, _f32(a))


def test_return_in_tensor_branch_raises_clearly():
    """The reference raises at the call (its call is traced); the port's
    call is eager and takes the branch, and its export raises the same
    TypeError."""
    def make(pkg):
        def fn(x):
            if x.mean() > 0.0:
                return x + 1.0
            return x - 1.0
        return fn

    with pytest.raises(TypeError, match="traced Tensor"):
        paddle.jit.to_static(make(paddle))(_t(paddle, [1.0, 2.0]))
    st = tp.jit.to_static(make(tp))
    np.testing.assert_allclose(st(_t(tp, [1.0, 2.0])).numpy(), [2.0, 3.0])
    with pytest.raises(TypeError, match="traced Tensor"):
        st.concrete_program(_t(tp, [1.0, 2.0]))


# -- TestLayerForward ---------------------------------------------------------
def _gate(pkg, sum_loss):
    class Gate(pkg.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = pkg.nn.Linear(4, 4)

        def forward(self, x):
            h = self.fc(x)
            if sum_loss:
                if h.sum() > 0:
                    y = h * 2.0
                else:
                    y = h * 3.0
                return y.sum()
            if h.mean() > 0:
                out = pkg.nn.functional.relu(h)
            else:
                out = h * 0.1
            return out

    return Gate()


def _gates(sum_loss):
    paddle.seed(0)
    jg = _gate(paddle, sum_loss)
    tg = _gate(tp, sum_loss)
    load_reference_state_dict(tg, {k: np.asarray(v.numpy())
                                   for k, v in jg.state_dict().items()})
    return jg, tg


def test_layer_with_tensor_if():
    jg, tg = _gates(False)
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    ref = paddle.jit.to_static(jg)(paddle.to_tensor(x)).numpy()
    eager = tg(tp.to_tensor(x)).detach().numpy()
    got = tp.jit.to_static(tg)(tp.to_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got, eager)


def test_grads_flow_through_converted_if():
    jg, tg = _gates(True)
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    paddle.jit.to_static(jg)(paddle.to_tensor(x)).backward()
    tp.jit.to_static(tg)(tp.to_tensor(x)).backward()
    np.testing.assert_allclose(tg.fc.weight.grad.numpy(),
                               jg.fc.weight.grad.numpy(), **TOL)
    np.testing.assert_allclose(tg.fc.bias.grad.numpy(),
                               jg.fc.bias.grad.numpy(), **TOL)


# -- TestForRange -------------------------------------------------------------
def test_for_over_tensor_range():
    def make(pkg):
        def fn(x, n):
            s = x * 0.0
            for i in range(n):
                s = s + x
            return s
        return fn

    np.testing.assert_allclose(_check(make, _f32([1.0, 2.0]), _i64(4)),
                               [4.0, 8.0])


def test_for_uses_index():
    def make(pkg):
        def fn(x, n):
            s = x * 0.0
            for i in range(n):
                s = s + x * float(1.0) + i
            return s
        return fn

    np.testing.assert_allclose(_check(make, _f32([0.0, 0.0]), _i64(3)),
                               [3.0, 3.0])


def test_negative_step_range_stays_python():
    def make(pkg, n=3):
        def fn(x):
            s = x * 0.0
            for i in range(n, 0, -1):
                s = s + i
            return s
        return fn

    np.testing.assert_allclose(_check(make, _f32([0.0])), [6.0])


def test_loop_var_after_loop_matches_python():
    def make(pkg):
        def fn(x, n):
            s = x * 0.0
            for i in range(n):
                s = s + x
            return s + i
        return fn

    np.testing.assert_allclose(_check(make, _f32([1.0, 1.0]), _i64(3)),
                               [5.0, 5.0])


# -- TestTransformScope -------------------------------------------------------
def test_closure_overrides_global():
    def make(pkg, thresh=100.0):
        def fn(x):
            if x.mean() > thresh:
                y = x * 2.0
            else:
                y = x * 0.0
            return y
        return fn

    np.testing.assert_allclose(_check(make, _f32([1.0, 1.0])), [0.0, 0.0])


def test_no_control_flow_keeps_live_globals():
    outs = []
    for pkg in (paddle, tp):
        mod = types.ModuleType("m_live")
        exec("SCALE = 1.0\ndef f(x):\n    return x * SCALE\n", mod.__dict__)
        st = pkg.jit.to_static(mod.f)
        mod.SCALE = 3.0
        outs.append(np.asarray(st(_t(pkg, [1.0])).numpy()))
    np.testing.assert_allclose(outs[1], [3.0])
    np.testing.assert_allclose(outs[1], outs[0])


def test_not_to_static_and_unknown_decorator_keep_the_original():
    """``@not_to_static`` opts out and a decorator the transform does not
    know keeps the original function (the reference's fallbacks): both
    still run, and export through Python's own ``if`` on a fake tensor
    raises."""
    def deco(f):
        return f

    @tp.jit.not_to_static
    def opted(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = x
        return y

    @deco
    def decorated(x):
        if x.mean() > 0:
            y = x * 2.0
        else:
            y = x
        return y

    for fn in (opted, decorated):
        st = tp.jit.to_static(fn)
        assert st._fn is fn
        np.testing.assert_allclose(st(_t(tp, [1.0])).numpy(), [2.0])
        with pytest.raises(TypeError, match="traced Tensor"):
            st.concrete_program(tp.static.InputSpec([2], "float32"))


# -- the exported program ------------------------------------------------------
def _loop_and_branch(x):
    s = x * 0.0
    i = x.sum() * 0.0
    while i < 3.0:
        s = s + x
        i = i + 1.0
    if s.mean() > 0:
        y = s * 2.0
    else:
        y = s - 1.0
    return y


def test_export_holds_cond_and_while_loop():
    st = tp.jit.to_static(_loop_and_branch)
    ep = st.concrete_program(tp.static.InputSpec([None, 3], "float32"))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert {"cond", "while_loop"} <= targets, targets
    run = ep.module()
    for a in ([[1.0, 2.0, 3.0]], [[-1.0, -2.0, 0.5], [0.0, -4.0, 1.0]]):
        x = torch.tensor(a)
        np.testing.assert_array_equal(run(x).numpy(),
                                      _loop_and_branch(x).numpy())
    prog = st.program(tp.static.InputSpec([2, 3], "float32"))
    assert len(prog.blocks) >= 4  # main, cond's two branches, the loop's two
