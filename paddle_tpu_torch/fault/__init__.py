"""Fault tolerance (port of ``paddle_tpu/fault``): deterministic fault
injection (``inject``), the device-memory exhaustion classifier with its
pressure-relief registry (``memory``), retry with backoff (``retry``), the
preemption drain (``preemption``: ``PreemptionGuard``) and the training
stability sentinel (``sentinel``: ``StabilitySentinel``)."""
from __future__ import annotations

from . import inject, memory, retry  # noqa: F401  (inject arms from the environment)
from .inject import InjectedFault  # noqa: F401
from .memory import HbmExhausted, classify, is_oom  # noqa: F401
from .preemption import RESUMABLE_EXIT_CODE, PreemptionGuard  # noqa: F401
from .retry import retry_call, retrying  # noqa: F401
from .sentinel import (QuarantineLog, StabilityError,  # noqa: F401
                       StabilitySentinel, StabilityVerdict)

__all__ = ["inject", "memory", "retry", "InjectedFault", "HbmExhausted",
           "classify", "is_oom", "PreemptionGuard", "RESUMABLE_EXIT_CODE",
           "retry_call", "retrying", "QuarantineLog", "StabilityError",
           "StabilitySentinel", "StabilityVerdict"]
