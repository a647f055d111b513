"""Optimizers (port of ``paddle_tpu/optimizer/__init__.py``: ``L2Decay``,
``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``).

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

Parameters are given as tensors or as ``(name, tensor)`` pairs (e.g.
``model.named_parameters()``); names key ``state_dict()`` and are what
``apply_decay_param_fun`` sees. Unnamed parameters are ``param_<i>``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["L2Decay", "Optimizer", "SGD", "Momentum", "Adam", "AdamW"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _rounded(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype``, as JAX's weak typing does."""
    return float(torch.tensor(x, dtype=dtype))


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None):
        if parameters is None:
            raise ValueError("parameters are required")
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip needs nn/clip.py, which is not ported yet "
                "(ROADMAP queue A)")
        if not isinstance(learning_rate, (int, float)):
            raise TypeError("learning_rate must be a number: optimizer/lr.py "
                            "(LR schedulers) is not ported yet (ROADMAP queue A)")
        self._names: List[str] = []
        self._parameter_list: List[torch.Tensor] = []
        for i, p in enumerate(parameters):
            name, p = p if isinstance(p, tuple) else (f"param_{i}", p)
            self._names.append(name)
            self._parameter_list.append(p)
        self._learning_rate = float(learning_rate)
        self.regularization = (L2Decay(weight_decay)
                               if isinstance(weight_decay, (int, float))
                               else weight_decay)
        self._accumulators: Dict[str, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value) -> None:
        self._learning_rate = float(value)

    # -- rule (subclasses) --------------------------------------------------
    def _init_accums(self, p) -> Dict[str, torch.Tensor]:
        return {}

    def _wd_on(self, name: str) -> float:
        return 1.0

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
        return gs

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        self._step_count += 1
        groups: Dict[tuple, list] = {}
        for name, p in zip(self._names, self._parameter_list):
            if not p.requires_grad or p.grad is None:
                continue
            st = self._accumulators.get(name)
            if st is None:
                st = self._accumulators[name] = self._init_accums(p)
            g = p.grad if p.grad.dtype == p.dtype else p.grad.to(p.dtype)
            key = (p.device, p.dtype, self._wd_on(name))
            groups.setdefault(key, []).append((p, g, st))
        for (_, _, wd), items in groups.items():
            ps = [p for p, _, _ in items]
            gs = self._regularized(ps, [g for _, g, _ in items])
            self._update(ps, gs, [st for _, _, st in items],
                         self.get_lr(), self._step_count, wd)

    def clear_grad(self, set_to_zero: bool = True) -> None:
        """Zero every gradient in place, or drop it (``set_to_zero=False``:
        the next backward then writes fresh gradients instead of adding)."""
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    # -- state ---------------------------------------------------------------
    def state_dict(self) -> dict:
        out = {f"{name}.{k}": v for name in self._names
               for k, v in self._accumulators.get(name, {}).items()}
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state_dict: dict) -> None:
        self._step_count = int(state_dict.get("@step", 0))
        for name, p in zip(self._names, self._parameter_list):
            prefix = f"{name}."
            st = {k[len(prefix):]: torch.as_tensor(v).to(p.device, p.dtype)
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[name] = st


class SGD(Optimizer):
    def _update(self, ps, gs, states, lr, t, wd):
        torch._foreach_add_(ps, gs, alpha=-_rounded(lr, ps[0].dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_accums(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, ps, gs, states, lr, t, wd):
        dt = ps[0].dtype
        mom, lr_p = _rounded(self._momentum, dt), _rounded(lr, dt)
        vs = [st["velocity"] for st in states]
        torch._foreach_mul_(vs, mom)
        torch._foreach_add_(vs, gs)
        step = torch._foreach_add(gs, vs, alpha=mom) if self._use_nesterov \
            else vs
        torch._foreach_add_(ps, step, alpha=-lr_p)


class Adam(Optimizer):
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
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, _rounded(self._epsilon, dt))
        torch._foreach_addcdiv_(ps, ms, denom,
                                value=-_rounded(self._lr_t(lr, t), dt))


class AdamW(Adam):
    """Decoupled weight decay: ``p * (1 - lr * wd)`` before the Adam update,
    on every parameter unless ``apply_decay_param_fun(name)`` is false."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None,
                 grad_clip=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = (weight_decay.coeff if isinstance(weight_decay, L2Decay)
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
        factor = float(1 - c(_rounded(lr, dt)) * c(self._wd) * c(wd))
        if factor != 1.0:
            torch._foreach_mul_(ps, factor)
        super()._update(ps, gs, states, lr, t, wd)
