"""Fault tolerance: deterministic fault injection (``inject``) and the
device-memory exhaustion classifier with its pressure-relief registry
(``memory``), the parts of ``paddle_tpu/fault`` the serving engine and its
supervisor consult."""
from __future__ import annotations

from . import inject, memory  # noqa: F401  (inject arms from the environment)
from .inject import InjectedFault  # noqa: F401
from .memory import HbmExhausted, classify, is_oom  # noqa: F401

__all__ = ["inject", "memory", "InjectedFault", "HbmExhausted", "classify",
           "is_oom"]
