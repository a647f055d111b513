"""``static.Program`` and ``TrainableProgram`` (``paddle_tpu_torch/static``)
against the reference's (``paddle_tpu/static/program.py``), on the CPU,
float32.

The 7 cases of ``tests/test_program_transforms.py``, each run through both
packages on the same weights (copied by name) and inputs: ``clone``,
``prune`` (dead ops eliminated), ``rebind_feeds``, ``append_backward`` and
``gradients`` re-trace the capture (values within 1e-5 of the reference's
and of the port's eager tape; the finite-difference check keeps the
reference's 1e-2), and the save → ``load_program`` → append loss → train
workflow on the ``.pdtrain`` companion: the port's 3 SGD losses within
1e-5 of the reference's, its gradients within 1e-5 of the eager tape's.
Op types are ATen's, not JAX primitives, so ops are compared by count and
values, not by name. Then the blocks of a ``cond``/``while_loop`` program.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu_torch.models import load_reference_state_dict
from paddle_tpu_torch.static import (InputSpec, Program, append_backward,
                                     gradients, load_program,
                                     save_inference_model)
from torch_port_util import cpu_device

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu():
    with cpu_device():
        yield


def _mlp(pkg):
    return pkg.nn.Sequential(pkg.nn.Linear(6, 16), pkg.nn.Tanh(),
                             pkg.nn.Linear(16, 3))


def _pair():
    paddle.seed(7)
    jm = _mlp(paddle)
    tm = _mlp(tp)
    load_reference_state_dict(tm, {k: np.asarray(v.numpy())
                                   for k, v in jm.state_dict().items()})
    return jm, tm


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jprog(fn, specs, layer=None):
    return paddle.static.Program.from_callable(
        fn, [paddle.static.InputSpec(s, "float32") for s in specs],
        layer=layer)


def _tprog(fn, specs, layer=None):
    return Program.from_callable(fn, [InputSpec(s, "float32")
                                      for s in specs], layer=layer)


def test_clone_is_independent_and_equal():
    jm, tm = _pair()
    p = _tprog(tm, [[2, 6]])
    p2 = p.clone()
    assert p2 is not p and p2.graph_module is not p.graph_module
    assert p2.global_block().all_op_types() == p.global_block().all_op_types()
    x = _x(2, 6)
    out = p.run(x)[0].numpy()
    np.testing.assert_array_equal(out, p2.run(x)[0].numpy())
    np.testing.assert_allclose(out, _jprog(jm, [[2, 6]]).clone().run(x)[0]
                               .numpy(), **TOL)


def test_prune_drops_dead_ops():
    jm, tm = _pair()

    def heads(pkg, m):
        def two_headed(x):
            h = m(x)
            return h, pkg.exp(pkg.sum(h * h))
        return two_headed

    p = _tprog(heads(tp, tm), [[2, 6]], layer=tm)
    pruned = p.prune(0)
    assert pruned.num_outputs == 1 and p.num_outputs == 2
    assert pruned.num_ops() < p.num_ops()
    assert p.num_ops() - pruned.num_ops() == 3  # mul, sum, exp
    x = _x(2, 6, seed=1)
    got = pruned.run(x)[0].numpy()
    np.testing.assert_array_equal(got, p.run(x)[0].numpy())
    jp = _jprog(heads(paddle, jm), [[2, 6]], layer=jm).prune(0)
    np.testing.assert_allclose(got, jp.run(x)[0].numpy(), **TOL)


def test_rebind_feeds_new_batch():
    jm, tm = _pair()
    p = _tprog(tm, [[2, 6]])
    p8 = p.rebind_feeds([InputSpec([8, 6], "float32")])
    x = _x(8, 6, seed=2)
    out = p8.run(x)[0].numpy()
    assert out.shape == (8, 3)
    np.testing.assert_allclose(out[:2], p.run(x[:2])[0].numpy(), **TOL)
    jp8 = _jprog(jm, [[2, 6]]).rebind_feeds(
        [paddle.static.InputSpec([8, 6], "float32")])
    np.testing.assert_allclose(out, jp8.run(x)[0].numpy(), **TOL)


def test_append_backward_matches_autograd():
    jm, tm = _pair()
    x = _x(4, 6, seed=3)
    bp = append_backward(program=_tprog(lambda x: (tm(x) ** 2).mean(),
                                        [[4, 6]], layer=tm))
    outs = bp.run(x)
    loss, grads = outs[0], outs[1:]
    assert len(grads) == len(list(tm.parameters()))
    l2 = (tm(torch.from_numpy(x)) ** 2).mean()
    l2.backward()
    np.testing.assert_allclose(float(loss), float(l2), **TOL)
    for g, p in zip(grads, tm.parameters()):
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), **TOL)
    jouts = paddle.static.append_backward(program=_jprog(
        lambda x: paddle.mean(jm(x) ** 2), [[4, 6]], layer=jm)).run(x)
    np.testing.assert_allclose(float(loss), float(jouts[0].numpy()), **TOL)
    for g, jg in zip(grads, jouts[1:]):
        np.testing.assert_allclose(g.numpy(), jg.numpy(), **TOL)


def test_gradients_wrt_feed():
    jm, tm = _pair()
    p = _tprog(lambda x: tm(x).sum(), [[2, 6]])  # tm's weights: constants
    gp = gradients(program=p, inputs=0)
    x = _x(2, 6, seed=4)
    gx = gp.run(x)[0].numpy()
    assert gx.shape == (2, 6)
    eps = 1e-3
    xp = x.copy()
    xp[0, 0] += eps
    xm = x.copy()
    xm[0, 0] -= eps
    fd = (float(p.run(xp)[0]) - float(p.run(xm)[0])) / (2 * eps)
    np.testing.assert_allclose(gx[0, 0], fd, rtol=1e-2, atol=1e-3)
    jg = paddle.static.gradients(program=_jprog(
        lambda x: paddle.sum(jm(x)), [[2, 6]]), inputs=0).run(x)[0]
    np.testing.assert_allclose(gx, jg.numpy(), **TOL)


def _trained(pkg, m, prefix, x, y, steps=3, lr=0.05):
    pkg.static.save_inference_model(
        prefix, [pkg.static.InputSpec([4, 6], "float32")], m)
    prog = pkg.static.load_program(prefix) if pkg is paddle else \
        load_program(prefix, device="cpu")
    mean = paddle.mean if pkg is paddle else torch.mean
    prog.append_backward(lambda outs, label: mean((outs[0] - label) ** 2))
    losses = [float(np.asarray(prog.train_step([x], [y], lr=lr).numpy()))
              for _ in range(steps)]
    return prog, losses


def test_save_load_append_loss_train_step(tmp_path):
    jm, tm = _pair()
    x, y = _x(4, 6, seed=5), _x(4, 3, seed=6)
    save_inference_model(str(tmp_path / "f"), [InputSpec([4, 6], "float32")],
                         tm)
    np.testing.assert_array_equal(
        load_program(str(tmp_path / "f"), device="cpu")(x)[0].numpy(),
        tm(torch.from_numpy(x)).detach().numpy())
    prog, losses = _trained(tp, tm, str(tmp_path / "t"), x, y)
    _, jlosses = _trained(paddle, jm, str(tmp_path / "j"), x, y)
    assert prog.param_names
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, jlosses, **TOL)
    loss0, grads = prog.gradients([x], [y])
    assert set(grads) == set(prog.param_names)
    assert all(torch.isfinite(g).all() for g in grads.values())
    m2 = _mlp(tp)
    m2.set_state_dict(prog.state_dict())
    np.testing.assert_allclose(m2(torch.from_numpy(x)).detach().numpy(),
                               prog(x)[0].numpy(), **TOL)


def test_grad_parity_with_eager(tmp_path):
    _, tm = _pair()
    prefix = str(tmp_path / "prog2")
    save_inference_model(prefix, [InputSpec([4, 6], "float32")], tm)
    prog = load_program(prefix, device="cpu")
    prog.append_backward(lambda outs, label: ((outs[0] - label) ** 2).mean())
    x, y = _x(4, 6, seed=8), _x(4, 3, seed=9)
    _, grads = prog.gradients([x], [y])
    loss = ((tm(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2).mean()
    loss.backward()
    named = dict(tm.named_parameters())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), named[name].grad.numpy(),
                                   **TOL)


class _TwoHeads(tp.nn.Layer):
    def __init__(self):
        super().__init__()
        self.a = tp.nn.Linear(6, 3)
        self.b = tp.nn.Linear(6, 2)

    def forward(self, x):
        return self.a(x), self.b(x)


def test_gradients_raise_on_a_parameter_the_loss_does_not_reach(tmp_path):
    """A loss on one head of a two-headed program: the other head's
    parameters get no gradient, and ``gradients``/``train_step`` raise
    naming them instead of stepping them by zeros; a loss on both heads
    trains."""
    prefix = str(tmp_path / "two")
    save_inference_model(prefix, [InputSpec([4, 6], "float32")], _TwoHeads())
    prog = load_program(prefix, device="cpu")
    x, y = _x(4, 6, seed=10), _x(4, 3, seed=11)
    prog.append_backward(lambda outs, label: ((outs[0] - label) ** 2).mean())
    for call in (prog.gradients, prog.train_step):
        with pytest.raises(ValueError, match=r"\['b.weight', 'b.bias'\]"):
            call([x], [y])
    prog.append_backward(lambda outs, label: ((outs[0] - label) ** 2).mean()
                         + outs[1].square().mean())
    before = prog.state_dict()["b.weight"].clone()
    prog.train_step([x], [y], lr=0.1)
    assert not torch.equal(prog.state_dict()["b.weight"], before)


def test_control_flow_program_blocks():
    """A ``static.nn.cond`` and ``while_loop`` program: the branches and the
    loop's condition and body are blocks after the main one, and the
    graph runs both branches as eager does."""
    def fn(x):
        def body(i, s):
            return i + 1, s + x

        _, s = tp.static.nn.while_loop(lambda i, s: i < 3, body,
                                       [torch.zeros((), dtype=torch.int64),
                                        x * 0.0])
        return tp.static.nn.cond(s.mean() > 0, lambda: s * 2.0,
                                 lambda: s - 1.0)

    p = Program.from_callable(fn, [InputSpec([2, 3], "float32")])
    assert len(p.blocks) == 5, [b.all_op_types() for b in p.blocks]
    main = p.global_block().all_op_types()
    assert "while_loop" in main and "cond" in main
    for sign in (1.0, -1.0):
        x = sign * _x(2, 3, seed=10) ** 2
        np.testing.assert_array_equal(p.run(x)[0].numpy(),
                                      fn(torch.from_numpy(x)).numpy())
