"""Grad mode (port of the API of ``paddle_tpu/core/engine.py:27–70``).

The reference's tape engine is torch's autograd here; these are Paddle's
names over torch's thread-local grad mode.
"""
from __future__ import annotations

import functools

import torch


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(mode: bool) -> None:
    torch.set_grad_enabled(bool(mode))


class _GradMode:
    _mode = True

    def __enter__(self):
        self._prev = torch.is_grad_enabled()
        torch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with type(self)():
                return fn(*args, **kwargs)

        return wrapper


class no_grad(_GradMode):
    """Context manager and decorator that stops recording gradients."""

    _mode = False


class enable_grad(_GradMode):
    """Context manager and decorator that records gradients."""

    _mode = True


__all__ = ["grad_enabled", "set_grad_enabled", "no_grad", "enable_grad"]
