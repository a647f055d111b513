"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``: ``L1Decay``,
``L2Decay``, ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Adamax``, ``RMSProp``, ``Adagrad``, ``Adadelta``, ``Lamb``,
``LarsMomentum``, and the schedulers of ``optimizer/lr.py``).

Each class's update is the reference's ``_rule`` written as tensor code over
the parameter list, with ``torch._foreach_*`` ops so one launch covers many
parameters. Updates are in place (the reference rebinds new arrays).

The reference runs each rule in the parameter's dtype: moments are
``zeros_like(p)``, the learning rate is cast to ``p.dtype``, and every Python
constant (beta1, 1 - beta1, epsilon, ...) is rounded to ``p.dtype`` by JAX's
weak typing before it multiplies. The port does the same, so a bf16 model
keeps bf16 moments and, e.g., beta2 = 0.999 acts as bf16(0.999) = 1.0. This
is not ``torch.optim.AdamW``, which adds epsilon after dividing by
sqrt(bias correction 2) and keeps its own rounding.

Each constant and each product rounds where the reference's XLA program
rounds it: after every op, in the dtype JAX's promotion gives (XLA keeps
no excess precision between bf16 ops, but keeps a bf16 product that is
promoted to f32 at once in f32, which only ``Lamb`` meets), so the
elementwise rules write one ``torch._foreach_*`` op for each of the
reference's ops. ``Lamb`` and ``LarsMomentum`` need each parameter's f32
norm and run parameter by parameter; under tensor parallelism the norm of
a sharded parameter is the logical one, its shard's squares summed over
its mp group (``_f32_norms``). ``Lamb`` follows the reference's promotion: its bias corrections
are f32 arrays, so a bf16 parameter comes out of the first step as float32
(the port rebinds ``p.data``), and its moments follow it on the next step.

The values that change from step to step (the learning rate and its
per-parameter scale, Adam's bias-corrected step size, AdamW's decay factor,
Lamb's bias corrections) enter the ``_foreach_*`` ops as 0-dim tensors on
the parameters' device (their ``Tensor`` overloads), made by
``core.lazy.host_scalars`` without waiting for the card: under the lazy
engine a Python float that changes every step would change the graph's
signature every step, so the loop would capture anew each step and never
replay. Each tensor form computes what the float form computed in f32 (a
product by the scalar, Adam's ``addcdiv`` with the scalar folded into its
numerator first); in bf16 the folded numerator rounds once more. SGD and
Momentum keep the float in ``alpha=`` (one fused multiply-add) while the
learning rate is a constant, and take the tensor form under a scheduler.
The folded numerator is a temporary the float form did not need, so
Adam's tail (and the scheduled SGD step) runs by chunks of at most
``_CHUNK_BYTES`` of parameters: its temporaries stay small beside a 7B
model's 13.5 GB of bf16 parameters.
An optimizer's moments are made eagerly and bound by address in the lazy
engine's graphs (``note_persistent``).

``_elementwise_rule`` marks the rules that are elementwise maps over
(parameter, gradient, state), which a flat shard of the parameters can run
(the reference's ZeRO-1 update reads it); the base class and the two
norm-based rules leave it False.

Parameters are given as tensors or as ``(name, tensor)`` pairs (e.g.
``model.named_parameters()``). ``state_dict()`` is keyed by the pair's name,
else by ``p.name`` (a ``Parameter``'s), else ``param_<i>``.
``apply_decay_param_fun`` sees ``p.name`` when the parameter has one, as the
reference's does, else the pair's name.

``step()`` is the reference's eager step: the parameters with a gradient
and ``stop_gradient`` off, through ``grad_clip`` (the updates take the
clipped gradients; ``p.grad`` keeps its own), ``regularization`` (``L2Decay``
or ``L1Decay``), the decay gate and each parameter's lr scale
``optimize_attr["learning_rate"]``. ``learning_rate`` may be an
``LRScheduler``, read by ``get_lr()`` at each step and carried in
``state_dict()`` as ``"LR_Scheduler"``. ``clear_grad()`` drops the gradients
(``p.grad = None``), as the reference's does.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import lazy
from . import lr
from .lr import LRScheduler

__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW", "Adamax", "RMSProp", "Adagrad", "Adadelta", "Lamb",
           "LarsMomentum", "lr", "LRScheduler"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


@functools.lru_cache(maxsize=4096)
def _rounded(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX's weak typing does (on
    the host: never a lazy graph's materialization point)."""
    with lazy.suspended():
        return float(torch.tensor(x, dtype=dtype))


def _scalars(p: torch.Tensor, *values, dtype=None) -> list:
    """``values`` as 0-dim tensors on ``p``'s device, each rounded to
    ``dtype`` (default ``p``'s)."""
    dt = dtype or p.dtype
    return lazy.host_scalars([_rounded(float(v), dt) for v in values], dt,
                             p.device)


# the most bytes of parameters one chunk of an update's temporaries covers
_CHUNK_BYTES = 256 << 20


def _chunks(ps, *lists):
    """``zip(ps, *lists)`` cut into consecutive chunks of at most
    ``_CHUNK_BYTES`` of ``ps`` (one parameter at least): each chunk as
    ``(ps_chunk, *lists_chunk)``."""
    start, size = 0, 0
    for i, p in enumerate(ps):
        size += p.numel() * p.element_size()
        if size >= _CHUNK_BYTES or i == len(ps) - 1:
            yield (ps[start:i + 1],) + tuple(x[start:i + 1] for x in lists)
            start, size = i + 1, 0


class Optimizer:
    _elementwise_rule = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError("parameters are required")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError("learning_rate must be a number or an LRScheduler")
        self._names: List[str] = []  # state keys
        self._gate_names: List[str] = []  # what apply_decay_param_fun sees
        self._parameter_list: List[torch.Tensor] = []
        for i, p in enumerate(parameters):
            name, p = p if isinstance(p, tuple) else (None, p)
            own = getattr(p, "name", None)
            own = own if isinstance(own, str) else None
            self._names.append(name or own or f"param_{i}")
            self._gate_names.append(own or name or f"param_{i}")
            self._parameter_list.append(p)
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self.regularization = (L2Decay(weight_decay)
                               if isinstance(weight_decay, (int, float))
                               else weight_decay)
        self._grad_clip = grad_clip
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._learning_rate = scheduler

    # -- rule (subclasses) --------------------------------------------------
    def _init_accums(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _wd_on(self, name: str) -> float:
        return 1.0

    def _gate(self, i: int) -> float:
        """Parameter i's decay gate in the eager step: ``_wd_on`` of the name
        the reference's gate sees (``Lamb`` reads the parameter itself)."""
        return self._wd_on(self._gate_names[i])

    def _lr_step(self, ps, gs, lr: float) -> None:
        """``ps -= lr * gs`` (the SGD and Momentum step): a float ``alpha``
        (one fused multiply-add) while the learning rate is a constant, the
        tensor form under a scheduler."""
        dt = ps[0].dtype
        if not isinstance(self._learning_rate, LRScheduler):
            torch._foreach_add_(ps, gs, alpha=-_rounded(lr, dt))
            return
        neg, = _scalars(ps[0], -_rounded(lr, dt))
        for p_c, g_c in _chunks(ps, gs):
            torch._foreach_add_(p_c, torch._foreach_mul(g_c, neg))

    def _update(self, ps, gs, states, lr: float, t: int, wd: float) -> None:
        """In place over one group of parameters that share device, dtype and
        decay gate: ``states[i]`` holds parameter i's accumulators."""
        raise NotImplementedError

    # -- step --------------------------------------------------------------
    def _regularized(self, ps, gs):
        reg = self.regularization
        if isinstance(reg, L2Decay) and reg.coeff:
            return torch._foreach_add(gs, ps,
                                      alpha=_rounded(reg.coeff, ps[0].dtype))
        if isinstance(reg, L1Decay) and reg.coeff:
            return torch._foreach_add(gs, torch._foreach_sign(ps),
                                      alpha=_rounded(reg.coeff, ps[0].dtype))
        return gs

    def step(self) -> None:
        """One eager update of every parameter that has a gradient."""
        self._step(functional=False)

    @torch.no_grad()
    def _step(self, functional: bool, with_params: bool = False) -> None:
        """``functional=True`` is the reference's compiled-step update
        (``_functional_update``, called without the parameters): no grad
        clip, the decay on every parameter and no per-parameter lr scale.
        ``with_params=True`` is the same update called with the parameters,
        as the reference's ``HybridParallelEngine`` calls it: no grad clip,
        but each parameter's decay gate and lr scale."""
        self._step_count += 1
        live = [i for i, p in enumerate(self._parameter_list)
                if p.requires_grad and p.grad is not None]
        pg = [(self._parameter_list[i], self._parameter_list[i].grad)
              for i in live]
        if self._grad_clip is not None and not functional:
            pg = self._grad_clip(pg)
        self._apply_updates(live, pg, functional, with_params)

    def _apply_updates(self, live, pg, functional: bool,
                       with_params: bool) -> None:
        """The rule over ``pg``, the (tensor, gradient) pairs of the
        parameters at ``live`` (indices into the parameter list): each
        tensor is the parameter or, under ZeRO, a view of this rank's
        shard of it, whose accumulators take its shape."""
        lr = self.get_lr()
        groups: Dict[tuple, list] = {}
        for i, (p, g) in zip(live, pg):
            name = self._names[i]
            st = self._accumulators.get(name)
            if st is None:
                with lazy.eager():
                    st = self._accumulators[name] = self._init_accums(p)
                lazy.note_persistent(*st.values())
            if g.dtype != p.dtype:
                g = g.to(p.dtype)
            if functional and not with_params:
                wd, scale = 1.0, 1.0
            else:
                wd = self._gate(i)
                scale = float(getattr(self._parameter_list[i],
                                      "optimize_attr", {}).get(
                    "learning_rate", 1.0))
            key = (p.device, p.dtype, wd, scale)
            groups.setdefault(key, []).append((p, g, st))
        for (_, _, wd, scale), items in groups.items():
            ps = [p for p, _, _ in items]
            gs = self._regularized(ps, [g for _, g, _ in items])
            # the reference's f32 lr times the scale, in f32
            p_lr = (lr if scale == 1.0
                    else float(np.float32(lr) * np.float32(scale)))
            self._update(ps, gs, [st for _, _, st in items], p_lr,
                         self._step_count, wd)

    def clear_grad(self, set_to_zero: bool = True) -> None:
        """Drop every gradient (``p.grad = None``), whatever ``set_to_zero``
        says, as the reference does: the next backward writes fresh
        gradients instead of adding to zeroed ones."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        out = {f"{name}.{k}": v for name in self._names
               for k, v in self._accumulators.get(name, {}).items()}
        out["@step"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state_dict: dict) -> None:
        self._step_count = int(state_dict.get("@step", 0))
        if "LR_Scheduler" in state_dict and isinstance(self._learning_rate,
                                                       LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        for name, p in zip(self._names, self._parameter_list):
            prefix = f"{name}."
            # a tensor keeps its dtype (Lamb's moments may differ from the
            # parameter's); arrays take the parameter's
            st = {k[len(prefix):]: (
                v.to(p.device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(v).to(p.device, p.dtype))
                for k, v in state_dict.items()
                if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[name] = st
                lazy.note_persistent(*st.values())

    load_state_dict = set_state_dict


class SGD(Optimizer):
    _elementwise_rule = True

    def _update(self, ps, gs, states, lr, t, wd):
        self._lr_step(ps, gs, lr)


class Momentum(Optimizer):
    _elementwise_rule = True

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_accums(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        mom = _rounded(self._momentum, dt)
        vs = [st["velocity"] for st in states]
        torch._foreach_mul_(vs, mom)
        torch._foreach_add_(vs, gs)
        step = torch._foreach_add(gs, vs, alpha=mom) if self._use_nesterov \
            else vs
        self._lr_step(ps, step, lr)


class Adam(Optimizer):
    _elementwise_rule = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_accums(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _lr_t(self, lr: float, t: int) -> float:
        """lr * sqrt(1 - beta2^t) / (1 - beta1^t) in f32, as the reference."""
        f = np.float32
        bc1 = f(1) - np.power(f(self._beta1), f(t))
        bc2 = f(1) - np.power(f(self._beta2), f(t))
        return float(f(lr) * np.sqrt(bc2) / bc1)

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        b1, b2 = self._beta1, self._beta2
        ms = [st["moment1"] for st in states]
        vs = [st["moment2"] for st in states]
        torch._foreach_mul_(ms, _rounded(b1, dt))
        torch._foreach_add_(ms, gs, alpha=_rounded(1 - b1, dt))
        torch._foreach_mul_(vs, _rounded(b2, dt))
        torch._foreach_addcmul_(vs, gs, gs, value=_rounded(1 - b2, dt))
        neg_lr_t, = _scalars(ps[0], -self._lr_t(lr, t))
        eps = _rounded(self._epsilon, dt)
        # by chunks of parameters, so the two temporaries (the denominator,
        # and the numerator with -lr_t folded in: addcdiv multiplies it
        # first) stay small beside the parameters
        for p_c, m_c, v_c in _chunks(ps, ms, vs):
            denom = torch._foreach_sqrt(v_c)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(p_c, torch._foreach_mul(m_c, neg_lr_t),
                                    denom)


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * wd)`` before the Adam update,
    on every parameter unless ``apply_decay_param_fun(name)`` is false."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = (weight_decay.coeff
                    if isinstance(weight_decay, (L1Decay, L2Decay))
                    else float(weight_decay))
        self._apply_decay_param_fun = apply_decay_param_fun

    def _wd_on(self, name):
        fun = self._apply_decay_param_fun
        return 0.0 if fun is not None and not fun(name) else 1.0

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype

        def c(x):
            return torch.tensor(x, dtype=dt)

        # 1 - lr * wd * gate, each product rounded to the parameter's dtype
        # (on the host); a factor of 1.0 (lr 0, or any lr in bf16) skips
        # the pass, which changes the ops only where it starts or stops
        with lazy.suspended():
            factor = float(1 - c(_rounded(lr, dt)) * c(self._wd) * c(wd))
        if factor != 1.0:
            f, = _scalars(ps[0], factor)
            torch._foreach_mul_(ps, f)
        super()._update(ps, gs, states, lr, t, wd)


def _f32_pow(base: float, t: int) -> np.float32:
    """``jnp.power(base, t)`` with the reference's f32 step ``t``."""
    return np.power(np.float32(base), np.float32(t))


class Adamax(Optimizer):
    _elementwise_rule = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_accums(self, p):
        return {"moment": torch.zeros_like(p), "inf_norm": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        b1, b2 = self._beta1, self._beta2
        ms = [st["moment"] for st in states]
        us = [st["inf_norm"] for st in states]
        torch._foreach_mul_(ms, _rounded(b1, dt))
        torch._foreach_add_(ms, torch._foreach_mul(gs, _rounded(1 - b1, dt)))
        torch._foreach_mul_(us, _rounded(b2, dt))
        torch._foreach_maximum_(us, torch._foreach_abs(gs))
        # lr / (1 - b1^t) in f32, then cast to the parameter's dtype
        lr_t = np.float32(lr) / (np.float32(1) - _f32_pow(b1, t))
        lr_t, = _scalars(ps[0], float(lr_t))
        step = torch._foreach_mul(ms, lr_t)
        torch._foreach_div_(step, torch._foreach_add(us, _rounded(
            self._epsilon, dt)))
        torch._foreach_sub_(ps, step)


class RMSProp(Optimizer):
    """``centered`` divides by the variance (mean square less the squared
    mean gradient); the uncentered rule leaves ``mean_grad`` as it is."""

    _elementwise_rule = True

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-06, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_accums(self, p):
        return {"mean_square": torch.zeros_like(p),
                "momentum": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        rho = self._rho
        mss = [st["mean_square"] for st in states]
        moms = [st["momentum"] for st in states]
        torch._foreach_mul_(mss, _rounded(rho, dt))
        torch._foreach_add_(mss, torch._foreach_mul(
            torch._foreach_mul(gs, gs), _rounded(1 - rho, dt)))
        denom = mss
        if self._centered:
            mgs = [st["mean_grad"] for st in states]
            torch._foreach_mul_(mgs, _rounded(rho, dt))
            torch._foreach_add_(mgs, torch._foreach_mul(gs, _rounded(1 - rho,
                                                                     dt)))
            denom = torch._foreach_sub(mss, torch._foreach_mul(mgs, mgs))
        denom = torch._foreach_sqrt(torch._foreach_add(denom, _rounded(
            self._epsilon, dt)))
        lr_p, = _scalars(ps[0], lr)
        step = torch._foreach_mul(gs, lr_p)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(moms, _rounded(self._momentum, dt))
        torch._foreach_add_(moms, step)
        torch._foreach_sub_(ps, moms)


class Adagrad(Optimizer):
    _elementwise_rule = True

    def __init__(self, learning_rate, epsilon=1e-06, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_accums(self, p):
        return {"moment": torch.full_like(p, self._init_acc)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        ms = [st["moment"] for st in states]
        torch._foreach_add_(ms, torch._foreach_mul(gs, gs))
        denom = torch._foreach_sqrt(ms)
        torch._foreach_add_(denom, _rounded(self._epsilon, dt))
        lr_p, = _scalars(ps[0], lr)
        step = torch._foreach_mul(gs, lr_p)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(ps, step)


class Adadelta(Optimizer):
    """The update reads the accumulated squared update of the step before
    (``avg_squared_update`` is refreshed after it)."""

    _elementwise_rule = True

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_accums(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        rho, eps = _rounded(self._rho, dt), _rounded(self._epsilon, dt)
        one_rho = _rounded(1 - self._rho, dt)
        asgs = [st["avg_squared_grad"] for st in states]
        asus = [st["avg_squared_update"] for st in states]
        torch._foreach_mul_(asgs, rho)
        torch._foreach_add_(asgs, torch._foreach_mul(
            torch._foreach_mul(gs, gs), one_rho))
        upd = torch._foreach_sqrt(torch._foreach_add(asus, eps))
        torch._foreach_div_(upd, torch._foreach_sqrt(
            torch._foreach_add(asgs, eps)))
        torch._foreach_mul_(upd, gs)
        torch._foreach_mul_(asus, rho)
        torch._foreach_add_(asus, torch._foreach_mul(
            torch._foreach_mul(upd, upd), one_rho))
        lr_p, = _scalars(ps[0], lr)
        torch._foreach_sub_(ps, torch._foreach_mul(upd, lr_p))


def _weak_mul(x: float, t: torch.Tensor, out=None) -> torch.Tensor:
    """A Python scalar times a tensor, the scalar rounded to the tensor's
    dtype first (JAX's weak typing). ``out=torch.float32`` is a bf16 product
    that the reference's XLA program promotes at once: XLA keeps it in f32
    (the bf16 rounding between the product and the conversion is elided),
    so it is taken in f32 with the bf16-rounded scalar."""
    c = _rounded(x, t.dtype)
    return t.float() * c if out == torch.float32 and t.dtype != out \
        else t * c


def _f32_norms(p, *ts):
    """The reference's f32 norms of ``ts``, summed in f64 and rounded to
    f32 so they do not hang on the device's order of summation (torch's f32
    sum on the CPU is 1.9e-3 off for a 30.7M-element embedding). When an
    mp layer shards ``p`` (``mp_distributed``), ``ts`` are its rank's
    slices and the norms are the logical tensors': the squares are summed
    over its ``mp_group`` in one all-reduce, and so over its ZeRO-3 group
    when ``ts`` are its ZeRO-3 slices."""
    from ..nn.clip import mp_split, zero3_split

    norms = [torch.linalg.vector_norm(t, dtype=torch.float64) for t in ts]
    groups = [g for g in (mp_split(p), zero3_split(p)) if g is not None]
    if not groups:
        return [n.float() for n in norms]
    from ..distributed import collective as C

    sq = torch.stack(norms) ** 2
    for group in groups:
        sq = C.all_reduce(sq, group=group)
    return list(torch.sqrt(sq).float())


class Lamb(Optimizer):
    """Adam's moments with a layer-wise trust ratio ``||p|| / ||r||`` (f32
    norms). ``exclude_from_weight_decay_fn(p)`` receives the parameter, as
    the reference's does, and a true result turns the decay off for it.

    The bias corrections are the reference's f32 arrays, so ``m_hat``,
    ``v_hat``, the update and the new parameter are f32 whatever the
    parameter's dtype: a bf16 parameter is rebound to a float32 one, with
    its moments still bf16 until the next step promotes them too. Where a
    bf16 product meets an f32 operand (the decay term, the moments of a
    promoted parameter, ``lr * trust``), the reference's compiled rule keeps
    the product in f32, and so does the port."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-06, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _gate(self, i):
        fun = self._exclude_fn
        return 0.0 if fun is not None and fun(self._parameter_list[i]) \
            else 1.0

    def _init_accums(self, p):
        return {"moment1": torch.zeros_like(p), "moment2": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        b1, b2 = self._beta1, self._beta2
        bc1, bc2 = _scalars(ps[0], np.float32(1) - _f32_pow(b1, t),
                            np.float32(1) - _f32_pow(b2, t),
                            dtype=torch.float32)
        eps = _rounded(self._epsilon, torch.float32)
        for p, g, st in zip(ps, gs, states):
            dt = p.dtype
            lr_p, = _scalars(p, lr)
            m0, v0 = st["moment1"], st["moment2"]
            mt = torch.promote_types(m0.dtype, dt)
            m = _weak_mul(b1, m0, mt) + _weak_mul(1 - b1, g, mt)
            v = _weak_mul(b2, v0, mt) + _weak_mul(1 - b2, g * g, mt)
            r = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + eps)
            r = r + _weak_mul(self._wd * wd, p, torch.float32)
            w_norm, r_norm = _f32_norms(p, p, r)
            trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                                1.0).to(dt)
            new_p = p - (trust.float() * lr_p) * r
            st["moment1"], st["moment2"] = m, v
            if new_p.dtype == dt:
                p.copy_(new_p)
            else:
                p.data = new_p


class LarsMomentum(Optimizer):
    """LARS: momentum with a layer-wise local lr ``coeff * ||p|| / (||g|| +
    wd * ||p|| + 1e-12)`` from f32 norms, or 1 where either norm is 0."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _init_accums(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        lwd, coeff = self._lars_wd, self._lars_coeff
        lr32, = _scalars(ps[0], lr, dtype=torch.float32)
        for p, g, st in zip(ps, gs, states):
            dt = p.dtype
            w_norm, g_norm = _f32_norms(p, p, g)
            local = torch.where((w_norm > 0) & (g_norm > 0),
                                coeff * w_norm / (g_norm + lwd * w_norm
                                                  + 1e-12),
                                1.0)
            g = g + _weak_mul(lwd, p)
            v = _weak_mul(self._momentum, st["velocity"]) \
                + (local * lr32).to(dt) * g
            st["velocity"].copy_(v)
            p.sub_(v)
