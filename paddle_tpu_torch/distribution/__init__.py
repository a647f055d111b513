"""``paddle.distribution`` (port of ``paddle_tpu/distribution/__init__.py``):
``Uniform``, ``Normal``, ``Categorical``, ``Bernoulli``, ``Beta``,
``Dirichlet``, ``Multinomial``, ``ExponentialFamily``, ``kl_divergence``
and ``register_kl``.

``sample`` draws from the port's generator of the parameters' device
(``core/random.py``), or from ``generator`` when one is passed; never from
torch's global stream. Gamma draws (``Beta``, ``Dirichlet``) use Marsaglia
and Tsang's method on that generator's normals and uniforms, since
``torch._standard_gamma`` takes no generator. The draws cannot be JAX's:
they are held to their moments. ``log_prob``, ``entropy``, ``mean``,
``variance`` and the KL divergences are the reference's closed forms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as random_state
from ..ops.creation import _as


def _f32(x):
    return _as(x).float() if isinstance(x, torch.Tensor) else \
        _as(np.asarray(x, np.float32))


def _gen(t, generator):
    return generator if generator is not None else \
        random_state.default_generator(t.device)


def _shape(shape, *params):
    return tuple(shape) + tuple(torch.broadcast_shapes(
        *[tuple(p.shape) for p in params]))


def _gamma(alpha, shape, gen):
    """Gamma(alpha, 1) draws of ``shape`` (``alpha`` broadcast to it):
    Marsaglia and Tsang's squeeze method, rounds of proposals until every
    entry is accepted; alpha < 1 through Gamma(alpha + 1) * U^(1/alpha)."""
    a = alpha.expand(shape)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty(shape, dtype=alpha.dtype, device=alpha.device)
    todo = torch.ones(shape, dtype=torch.bool, device=alpha.device)
    while bool(todo.any()):
        z = torch.randn(shape, generator=gen, dtype=alpha.dtype,
                        device=alpha.device)
        u = torch.rand(shape, generator=gen, dtype=alpha.dtype,
                       device=alpha.device)
        v = (1 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d
                        - d * v + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = torch.rand(shape, generator=gen, dtype=alpha.dtype,
                   device=alpha.device)
    return torch.where(boost, out * u ** (1.0 / a), out)


class Distribution:
    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        return torch.exp(self.log_prob(value))

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low, self.high = _as(low), _as(high)

    def sample(self, shape=(), seed=0, generator=None):
        u = torch.rand(_shape(shape, self.low, self.high),
                       generator=_gen(self.low, generator),
                       device=self.low.device)
        return self.low + u * (self.high - self.low)

    def log_prob(self, value):
        v, lo, hi = _as(value), self.low, self.high
        return torch.where((v >= lo) & (v < hi), -torch.log(hi - lo),
                           -torch.inf)

    def entropy(self):
        return torch.log(self.high - self.low)


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc, self.scale = _as(loc), _as(scale)

    def sample(self, shape=(), seed=0, generator=None):
        z = torch.randn(_shape(shape, self.loc, self.scale),
                        generator=_gen(self.loc, generator),
                        device=self.loc.device)
        return self.loc + z * self.scale

    def log_prob(self, value):
        v, m, s = _as(value), self.loc, self.scale
        return -((v - m) ** 2) / (2 * s ** 2) - torch.log(s) \
            - 0.5 * math.log(2 * math.pi)

    def entropy(self):
        return 0.5 + 0.5 * math.log(2 * math.pi) + torch.log(self.scale)

    def kl_divergence(self, other):
        m1, s1, m2, s2 = self.loc, self.scale, other.loc, other.scale
        return torch.log(s2 / s1) + (s1 ** 2 + (m1 - m2) ** 2) \
            / (2 * s2 ** 2) - 0.5


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _as(logits)

    def sample(self, shape=(), generator=None):
        """int64 draws of shape ``shape + logits.shape[:-1]``."""
        lg = self.logits
        k = lg.shape[-1]
        n = int(np.prod(shape)) if len(shape) else 1
        p = torch.softmax(lg.reshape(-1, k).float(), -1)
        draws = torch.multinomial(p, n, replacement=True,
                                  generator=_gen(lg, generator))  # (R, n)
        return draws.T.reshape(tuple(shape) + tuple(lg.shape[:-1]))

    def log_prob(self, value):
        logp = torch.log_softmax(self.logits, -1)
        return torch.gather(logp, -1, _as(value).long()[..., None])[..., 0]

    def entropy(self):
        lg = self.logits
        return -torch.sum(torch.softmax(lg, -1) * torch.log_softmax(lg, -1),
                          -1)


class Bernoulli(Distribution):
    def __init__(self, probs, name=None):
        self.probs_t = _as(probs)

    def sample(self, shape=(), generator=None):
        p = self.probs_t
        u = torch.rand(tuple(shape) + tuple(p.shape),
                       generator=_gen(p, generator), device=p.device)
        return (u < p).float()

    def log_prob(self, value):
        p, v = self.probs_t, _as(value)
        return v * torch.log(torch.clamp(p, min=1e-12)) \
            + (1 - v) * torch.log(torch.clamp(1 - p, min=1e-12))


def kl_divergence(p, q):
    fn = _registered_kl(p, q)
    if fn is not None:
        return fn(p, q)
    return p.kl_divergence(q)


class ExponentialFamily(Distribution):
    """Base of the exponential-family distributions; each subclass has its
    closed-form ``entropy``/``log_prob``."""


class Beta(ExponentialFamily):
    def __init__(self, alpha, beta, name=None):
        self.alpha, self.beta = _f32(alpha), _f32(beta)

    @property
    def mean(self):
        return self.alpha / (self.alpha + self.beta)

    @property
    def variance(self):
        a, b = self.alpha, self.beta
        return a * b / ((a + b) ** 2 * (a + b + 1))

    def sample(self, shape=(), generator=None):
        a, b = self.alpha, self.beta
        out = _shape(shape, a, b)
        gen = _gen(a, generator)
        x, y = _gamma(a, out, gen), _gamma(b, out, gen)
        return x / (x + y)

    def log_prob(self, value):
        a, b, v = self.alpha, self.beta, _as(value)
        return ((a - 1) * torch.log(torch.clamp(v, min=1e-12))
                + (b - 1) * torch.log(torch.clamp(1 - v, min=1e-12))
                - (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)))

    def entropy(self):
        a, b = self.alpha, self.beta
        return (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
                - (a - 1) * torch.digamma(a) - (b - 1) * torch.digamma(b)
                + (a + b - 2) * torch.digamma(a + b))


class Dirichlet(ExponentialFamily):
    def __init__(self, concentration, name=None):
        self.concentration = _f32(concentration)

    @property
    def mean(self):
        c = self.concentration
        return c / torch.sum(c, -1, keepdim=True)

    @property
    def variance(self):
        c = self.concentration
        a0 = torch.sum(c, -1, keepdim=True)
        return c * (a0 - c) / (a0 * a0 * (a0 + 1))

    def sample(self, shape=(), generator=None):
        c = self.concentration
        g = _gamma(c, tuple(shape) + tuple(c.shape), _gen(c, generator))
        return g / g.sum(-1, keepdim=True)

    def log_prob(self, value):
        c, v = self.concentration, _as(value)
        return (torch.sum((c - 1) * torch.log(torch.clamp(v, min=1e-12)), -1)
                + torch.lgamma(torch.sum(c, -1))
                - torch.sum(torch.lgamma(c), -1))

    def entropy(self):
        c = self.concentration
        a0 = torch.sum(c, -1)
        k = c.shape[-1]
        log_b = torch.sum(torch.lgamma(c), -1) - torch.lgamma(a0)
        return (log_b + (a0 - k) * torch.digamma(a0)
                - torch.sum((c - 1) * torch.digamma(c), -1))


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs_t = _f32(probs)

    @property
    def mean(self):
        return self.total_count * self.probs_t

    @property
    def variance(self):
        p = self.probs_t
        return self.total_count * p * (1 - p)

    def sample(self, shape=(), generator=None):
        """float32 counts of ``total_count`` draws, shape ``shape +
        probs.shape``."""
        p = self.probs_t
        k = p.shape[-1]
        n = int(np.prod(shape)) if len(shape) else 1
        rows = torch.clamp(p, min=1e-12).reshape(-1, k)
        draws = torch.multinomial(rows, n * self.total_count,
                                  replacement=True,
                                  generator=_gen(p, generator))
        draws = draws.reshape(rows.shape[0], n, self.total_count)
        counts = torch.zeros(rows.shape[0], n, k, device=p.device)
        counts.scatter_add_(2, draws, torch.ones_like(draws,
                                                      dtype=torch.float32))
        return counts.permute(1, 0, 2).reshape(tuple(shape)
                                               + tuple(p.shape))

    def log_prob(self, value):
        p, v = self.probs_t, _as(value)
        return (torch.lgamma(torch.sum(v, -1) + 1)
                - torch.sum(torch.lgamma(v + 1), -1)
                + torch.sum(v * torch.log(torch.clamp(p, min=1e-12)), -1))


_KL_REGISTRY = {}


def register_kl(cls_p, cls_q):
    """Decorator: ``fn(p, q)`` is ``kl_divergence`` for instances of
    ``cls_p`` and ``cls_q``."""

    def decorator(fn):
        _KL_REGISTRY[(cls_p, cls_q)] = fn
        return fn

    return decorator


def _registered_kl(p, q):
    for (cp, cq), fn in _KL_REGISTRY.items():
        if isinstance(p, cp) and isinstance(q, cq):
            return fn
    return None


@register_kl(Beta, Beta)
def _kl_beta_beta(p, q):
    a1, b1, a2, b2 = p.alpha, p.beta, q.alpha, q.beta
    s1 = a1 + b1
    return (torch.lgamma(s1) - torch.lgamma(a1) - torch.lgamma(b1)
            - (torch.lgamma(a2 + b2) - torch.lgamma(a2) - torch.lgamma(b2))
            + (a1 - a2) * torch.digamma(a1) + (b1 - b2) * torch.digamma(b1)
            + (a2 - a1 + b2 - b1) * torch.digamma(s1))


@register_kl(Dirichlet, Dirichlet)
def _kl_dir_dir(p, q):
    c1, c2 = p.concentration, q.concentration
    a0 = torch.sum(c1, -1)
    return (torch.lgamma(a0) - torch.sum(torch.lgamma(c1), -1)
            - torch.lgamma(torch.sum(c2, -1))
            + torch.sum(torch.lgamma(c2), -1)
            + torch.sum((c1 - c2) * (torch.digamma(c1)
                                     - torch.digamma(a0)[..., None]), -1))


__all__ = ["Distribution", "Uniform", "Normal", "Categorical", "Bernoulli",
           "ExponentialFamily", "Beta", "Dirichlet", "Multinomial",
           "kl_divergence", "register_kl"]
