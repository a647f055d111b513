"""Port parity of ``paddle_tpu_torch.nn.clip`` (``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm``, ``clip_grad_norm_``) against the
JAX package's clips on the same gradients, made with numpy from a seed, in
float32 and bfloat16, with one parameter at ``need_clip=False``.

Both compute in float32 and cast back: f32 gradients are held to rtol 1e-5
(the sums' order differs), bf16 ones to one bf16 ulp (a scale that differs
in its last f32 bit can round a product the other way).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as tp
from paddle_tpu.core.tensor import Parameter as JParameter
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


SHAPES = [(6, 5), (5,), (4, 6), (3,)]


def _grads(scale):
    rng = np.random.RandomState(2)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _params(pkg, gs, dtype, need_clip):
    """Parameters with ``need_clip`` off on the second one, and each pair's
    gradient, in ``pkg``'s types."""
    if pkg is paddle:
        ps = [JParameter(np.zeros(g.shape, np.float32)) for g in gs]
        grads = [paddle.to_tensor(g, dtype=dtype) for g in gs]
    else:
        ps = [tp.Parameter(torch.zeros(g.shape), dtype=dtype) for g in gs]
        grads = [tp.to_tensor(g, dtype=dtype) for g in gs]
    if not need_clip:
        ps[1].need_clip = False
    return ps, grads


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.numpy().astype(np.float32))


CLIPS = {
    "value": lambda pkg: pkg.nn.ClipGradByValue(0.3, -0.2),
    "value_default_min": lambda pkg: pkg.nn.ClipGradByValue(0.3),
    "norm": lambda pkg: pkg.nn.ClipGradByNorm(0.8),
    "global_norm": lambda pkg: pkg.nn.ClipGradByGlobalNorm(1.5),
    "global_norm_loose": lambda pkg: pkg.nn.ClipGradByGlobalNorm(1e3),
}


def _check(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("need_clip", [True, False], ids=["all", "one_off"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CLIPS))
def test_clip_matches_reference(case, dtype, need_clip):
    gs = _grads(scale=0.7)
    jps, jgs = _params(paddle, gs, dtype, need_clip)
    want = CLIPS[case](paddle)(list(zip(jps, jgs)))
    tps, tgs = _params(tp, gs, dtype, need_clip)
    got = CLIPS[case](tp)(list(zip(tps, tgs)))
    assert [p for p, _ in got] == tps
    for (_, g), (_, w), src in zip(got, want, tgs):
        assert g.dtype == src.dtype
        _check(_np(g), _np(w), dtype)
    if not need_clip:  # passed through untouched
        assert got[1][1] is tgs[1]
    for g, src in zip(tgs, gs):  # the inputs are not written
        np.testing.assert_array_equal(_np(g), _np(tp.to_tensor(
            src, dtype=dtype)))


def test_global_norm_clip_reaches_its_bound():
    gs = _grads(scale=3.0)
    ps, tgs = _params(tp, gs, "float32", True)
    out = tp.nn.ClipGradByGlobalNorm(1.0)(list(zip(ps, tgs)))
    total = torch.sqrt(sum((g.double() ** 2).sum() for _, g in out))
    assert abs(float(total) - 1.0) < 1e-6


def test_clip_skips_missing_gradients():
    ps, tgs = _params(tp, _grads(1.0), "float32", True)
    pairs = list(zip(ps, tgs))
    pairs[0] = (ps[0], None)
    out = tp.nn.ClipGradByGlobalNorm(0.1)(pairs)
    assert out[0] == (ps[0], None)
    assert tp.nn.ClipGradByNorm(0.1)([(ps[0], None)]) == [(ps[0], None)]


# the inf norm in f32 only: the reference takes its scale in bf16 there
@pytest.mark.parametrize("dtype,norm_type", [
    ("float32", 2.0), ("float32", 1.0), ("float32", float("inf")),
    ("bfloat16", 2.0), ("bfloat16", 1.0)],
    ids=["f32-l2", "f32-l1", "f32-inf", "bf16-l2", "bf16-l1"])
def test_clip_grad_norm_matches_reference(dtype, norm_type):
    """In place on ``p.grad``, returning the total norm; as in the
    reference, ``need_clip`` is not read here."""
    gs = _grads(scale=0.7)
    jps, jgs = _params(paddle, gs, dtype, need_clip=False)
    for p, g in zip(jps, jgs):
        p.grad = g
    want = paddle.nn.clip_grad_norm_(jps, 0.5, norm_type)
    tps, tgs = _params(tp, gs, dtype, need_clip=False)
    for p, g in zip(tps, tgs):
        p.grad = g
    got = tp.nn.clip_grad_norm_(tps, 0.5, norm_type)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want.numpy()), rtol=1e-5)
    for p, jp in zip(tps, jps):
        assert p.grad.dtype == tgs[0].dtype
        _check(_np(p.grad), _np(jp.grad), dtype)


def test_clip_grad_norm_without_gradients():
    p = tp.Parameter(torch.zeros(2))
    assert float(tp.nn.clip_grad_norm_([p], 1.0)) == 0.0
