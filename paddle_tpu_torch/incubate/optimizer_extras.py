"""Incubate optimizers: LookAhead and ModelAverage (port of
``paddle_tpu/incubate/optimizer_extras.py``).

Reference ``python/paddle/incubate/optimizer/lookahead.py`` (Zhang et al.
2019: the fast weights advance k steps, the slow weights interpolate toward
them) and ``modelaverage.py`` (parameter averaging over a sliding window,
with ``apply()``/``restore()``). Both wrap any inner optimizer and keep
their statistics on the parameters' device.

The reference's arrays are immutable, so it may keep a parameter's array
as its slow weight, its backup or a state entry. PyTorch's optimizers
update the parameters in place, so every such copy here is a ``clone()``:
an aliased one would move with the next step.
"""
from __future__ import annotations

import torch

__all__ = ["LookAhead", "ModelAverage"]


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _tensor_on(v, p) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return t.detach().to(p.device).clone()


class LookAhead:
    """lookahead.py:35: ``slow += alpha * (fast - slow)`` every k steps,
    then the fast weights are set to the slow weights."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        if not 0.0 <= float(alpha) <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        if int(k) < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._parameter_list = list(getattr(inner_optimizer,
                                            "_parameter_list", []))
        # seeded from the BUILD-time parameters (reference lookahead.py), so
        # the first k-step sync interpolates back toward the initial point
        self._slow = {p.name: p.detach().clone()
                      for p in self._parameter_list}
        self._step_count = 0

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def set_lr(self, lr):
        self.inner_optimizer.set_lr(lr)

    @torch.no_grad()
    def step(self):
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k:
            return
        for p in self._parameter_list:
            fast = p.detach()
            slow = self._slow.get(p.name)
            if slow is None:  # a parameter added after construction
                slow = fast.clone()
            slow = slow + _scalar(fast, self.alpha) * (fast - slow)
            self._slow[p.name] = slow
            p.copy_(slow)

    def clear_grad(self, set_to_zero=True):
        self.inner_optimizer.clear_grad(set_to_zero)

    def state_dict(self):
        out = {f"slow@{k}": v.clone() for k, v in self._slow.items()}
        out["@lookahead_step"] = self._step_count
        out["inner"] = self.inner_optimizer.state_dict()
        return out

    def set_state_dict(self, state):
        self._step_count = int(state.get("@lookahead_step", 0))
        by_name = {p.name: p for p in self._parameter_list}
        slow = {k[len("slow@"):]: v for k, v in state.items()
                if isinstance(k, str) and k.startswith("slow@")}
        # a key matching no parameter would silently restart interpolation
        # from the start: fail loudly instead
        stale = set(slow) - set(by_name)
        if stale:
            raise ValueError(
                f"LookAhead slow-weight keys {sorted(stale)} match no "
                f"parameter of this optimizer (have {sorted(by_name)})")
        self._slow = {k: _tensor_on(v, by_name[k]) for k, v in slow.items()}
        if "inner" in state:
            self.inner_optimizer.set_state_dict(state["inner"])

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, None


class ModelAverage:
    """modelaverage.py:33: running parameter sums over a sliding window;
    ``apply()`` swaps the averaged weights in for evaluation, ``restore()``
    swaps the training weights back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self.rate = float(average_window_rate)
        self.min_w = int(min_average_window)
        self.max_w = int(max_average_window)
        self._parameter_list = list(parameters) if parameters is not None \
            else []
        # per parameter a float32 sum, halved with the count when the window
        # is passed (a bounded window without storing history); the count is
        # a float so the halving keeps sum and divisor consistent
        self._sum = {}
        self._num = 0.0
        self._backup = None

    @torch.no_grad()
    def step(self):
        """Accumulate the current weights (call after optimizer.step())."""
        self._num += 1.0
        window = max(self.min_w,
                     min(self.max_w, int(self._num * self.rate) or 1))
        for p in self._parameter_list:
            cur = p.detach().to(torch.float32)
            s = self._sum.get(p.name)
            self._sum[p.name] = cur.clone() if s is None else s + cur
        if self._num > window:
            for k in self._sum:
                self._sum[k] = self._sum[k] * 0.5
            self._num = self._num * 0.5

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._num == 0:
            return
        if self._backup is not None:
            raise RuntimeError(
                "ModelAverage.apply() called twice without restore(): the "
                "training weights would be overwritten by averaged ones")
        self._backup = {p.name: p.detach().clone()
                        for p in self._parameter_list}
        for p in self._parameter_list:
            s = self._sum[p.name]
            p.copy_((s / _scalar(s, self._num)).to(p.dtype))
        if not need_restore:
            self._backup = None

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._parameter_list:
            p.copy_(self._backup[p.name])
        self._backup = None

    def state_dict(self):
        out = {f"sum@{k}": v.clone() for k, v in self._sum.items()}
        out["@ma_num"] = self._num
        return out

    def set_state_dict(self, state):
        self._num = float(state.get("@ma_num", 0.0))
        by_name = {p.name: p for p in self._parameter_list}
        sums = {k[len("sum@"):]: v for k, v in state.items()
                if isinstance(k, str) and k.startswith("sum@")}
        stale = set(sums) - set(by_name)
        if stale:
            raise ValueError(
                f"ModelAverage sum keys {sorted(stale)} match no parameter "
                f"of this optimizer (have {sorted(by_name)})")
        self._sum = {k: _tensor_on(v, by_name[k]).float()
                     for k, v in sums.items()}
