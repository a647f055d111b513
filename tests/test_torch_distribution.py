"""Port parity of ``paddle_tpu_torch.distribution`` against the JAX
package's, on the same numpy parameters from a seed.

The closed forms (``log_prob``, ``entropy``, ``probs``, ``mean``,
``variance``, ``kl_divergence`` through the registry or the method) are
held to the reference at rtol 1e-5, atol 1e-6 (1e-4 where ``lgamma`` or
``digamma`` enter), dtypes by name. Samples cannot be JAX's bits: they are
held by shape, dtype, range and moments (the mean within 5 standard
errors, the variance within 10%), and an explicit generator with one seed
must give the same draw twice.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distribution as RD
import paddle_tpu_torch as tp
import paddle_tpu_torch.distribution as PD
from torch_port_util import assert_same, cpu_device, public_names


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
LOGITS = _R.randn(3, 5).astype(np.float32)
PROBS = _R.rand(3).astype(np.float32) * 0.8 + 0.1
CONC = (_R.rand(2, 4) * 3 + 0.5).astype(np.float32)
CONC2 = (_R.rand(2, 4) * 3 + 0.5).astype(np.float32)
N = 20000


def _make(pkg, mod, kind, second=False):
    t = pkg.to_tensor
    if kind == "uniform":
        return mod.Uniform(t(np.array([0.0, -1.0], np.float32)),
                           t(np.array([2.0, 0.5], np.float32)))
    if kind == "normal":
        return mod.Normal(t(np.array([0.5, -1.0], np.float32)),
                          t(np.array([2.0, 0.3] if not second
                                     else [1.0, 0.7], np.float32)))
    if kind == "categorical":
        return mod.Categorical(t(LOGITS))
    if kind == "bernoulli":
        return mod.Bernoulli(t(PROBS))
    if kind == "beta":
        return mod.Beta(t(CONC[0, :2] if not second else CONC2[0, :2]),
                        t(CONC[1, :2] if not second else CONC2[1, :2]))
    if kind == "dirichlet":
        return mod.Dirichlet(t(CONC if not second else CONC2))
    if kind == "multinomial":
        return mod.Multinomial(6, t(np.array([0.2, 0.3, 0.5], np.float32)))
    raise KeyError(kind)


VALUES = {
    "uniform": np.array([1.0, 0.7], np.float32),
    "normal": np.array([0.1, -0.8], np.float32),
    "categorical": np.array([0, 4, 2], np.int64),
    "bernoulli": np.array([1.0, 0.0, 1.0], np.float32),
    "beta": np.array([0.3, 0.6], np.float32),
    "dirichlet": (CONC / CONC.sum(-1, keepdims=True)).astype(np.float32),
    "multinomial": np.array([1.0, 2.0, 3.0], np.float32),
}
CLOSED = {
    "uniform": ("log_prob", "entropy", "probs"),
    "normal": ("log_prob", "entropy", "probs"),
    "categorical": ("log_prob", "entropy"),
    "bernoulli": ("log_prob",),
    "beta": ("log_prob", "entropy", "mean", "variance"),
    "dirichlet": ("log_prob", "entropy", "mean", "variance"),
    "multinomial": ("log_prob", "mean", "variance"),
}
CASES = [(k, m) for k, ms in CLOSED.items() for m in ms]
GAMMA = {"beta", "dirichlet", "multinomial"}


@pytest.mark.parametrize("kind,method", CASES)
def test_closed_form_matches_reference(kind, method):
    r, p = _make(paddle, RD, kind), _make(tp, PD, kind)
    if method in ("mean", "variance"):
        want, got = getattr(r, method), getattr(p, method)
    elif method == "entropy":
        want, got = r.entropy(), p.entropy()
    else:
        v = VALUES[kind]
        want = getattr(r, method)(paddle.to_tensor(v))
        got = getattr(p, method)(tp.to_tensor(v))
    rtol = 1e-4 if kind in GAMMA else 1e-5
    assert_same(got, want, rtol=rtol, atol=1e-6 if rtol == 1e-5 else 1e-5,
                what=f"{kind}.{method}")


@pytest.mark.parametrize("kind", ["normal", "beta", "dirichlet"])
def test_kl_divergence_matches_reference(kind):
    want = RD.kl_divergence(_make(paddle, RD, kind),
                            _make(paddle, RD, kind, second=True))
    got = PD.kl_divergence(_make(tp, PD, kind),
                           _make(tp, PD, kind, second=True))
    assert_same(got, want, rtol=1e-4, atol=1e-5, what=kind)


def test_register_kl_takes_precedence():
    @PD.register_kl(PD.Uniform, PD.Uniform)
    def _kl(p, q):
        return torch.tensor(7.0)

    u = _make(tp, PD, "uniform")
    try:
        assert float(PD.kl_divergence(u, u)) == 7.0
    finally:
        PD._KL_REGISTRY.pop((PD.Uniform, PD.Uniform))


def _moments(kind, d):
    """(mean, variance, low, high) of one draw's entries."""
    if kind == "uniform":
        lo, hi = d.low.numpy(), d.high.numpy()
        return (lo + hi) / 2, (hi - lo) ** 2 / 12, lo, hi
    if kind == "normal":
        m, s = d.loc.numpy(), d.scale.numpy()
        return m, s ** 2, -np.inf, np.inf
    if kind == "bernoulli":
        p = d.probs_t.numpy()
        return p, p * (1 - p), 0.0, 1.0
    if kind in ("beta", "dirichlet"):
        return d.mean.numpy(), d.variance.numpy(), 0.0, 1.0
    if kind == "multinomial":
        return d.mean.numpy(), d.variance.numpy(), 0.0, 6.0
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["uniform", "normal", "bernoulli", "beta",
                                  "dirichlet", "multinomial"])
def test_samples_by_shape_range_and_moments(kind):
    d = _make(tp, PD, kind)
    gen = torch.Generator().manual_seed(5)
    s = d.sample([N], generator=gen)
    want = _make(paddle, RD, kind).sample([N])
    assert tuple(s.shape) == tuple(want.shape)
    assert s.dtype == torch.float32
    mean, var, lo, hi = _moments(kind, d)
    v = s.double().numpy()
    assert v.min() >= np.min(lo) and v.max() <= np.max(hi)
    np.testing.assert_array_less(np.abs(v.mean(0) - mean),
                                 5 * np.sqrt(var / N) + 1e-12)
    np.testing.assert_allclose(v.var(0), var, rtol=0.1)
    again = d.sample([N], generator=torch.Generator().manual_seed(5))
    assert torch.equal(s, again)


def test_categorical_samples_by_their_frequencies():
    d = _make(tp, PD, "categorical")
    s = d.sample([N], generator=torch.Generator().manual_seed(1))
    assert tuple(s.shape) == (N, 3) and s.dtype == torch.int64
    assert tuple(_make(paddle, RD, "categorical").sample([N]).shape) == \
        (N, 3)
    p = torch.softmax(torch.from_numpy(LOGITS).double(), -1).numpy()
    freq = np.stack([np.bincount(s[:, r].numpy(), minlength=5) / N
                     for r in range(3)])
    assert np.abs(freq - p).max() < 5 * np.sqrt(0.25 / N)


def test_the_module_holds_the_reference_names():
    ref = public_names(RD.__file__)
    assert ref <= set(vars(PD)), sorted(ref - set(vars(PD)))
