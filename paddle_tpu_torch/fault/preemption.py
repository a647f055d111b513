"""Preemption drain: survive SIGTERM with a resumable exit (port of
``paddle_tpu/fault/preemption.py``).

A scheduler sends SIGTERM before it reclaims a node. ``PreemptionGuard``'s
handler only sets a flag; at the next step boundary ``check`` waits for the
card to finish the queued work (``torch.cuda.synchronize()``, where the
reference flushes its lazy graph), writes a flight-recorder dump and a
final synchronous checkpoint, and exits with :data:`RESUMABLE_EXIT_CODE`,
which a launcher treats as a clean restart rather than a failure.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Callable, Optional

import torch

from .retry import _counter

# EX_TEMPFAIL: "temporary failure, retry later". Workers that drained cleanly
# exit with this; supervisors relaunch without consuming the failure budget.
RESUMABLE_EXIT_CODE = 75


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers; drain, checkpoint, resumable exit.

    Usage::

        with PreemptionGuard(checkpoint=ckpt) as guard:
            for step in range(start, steps):
                loss = train_step(...)
                guard.check(step, state)   # drains and exits if preempted

    ``checkpoint`` is any object with ``save_now(step, state, sync=True)``
    (``distributed.checkpoint.AutoCheckpoint`` or
    ``CoordinatedCheckpoint``). All real work happens in ``check()``, at a
    step boundary where the state is consistent.
    """

    def __init__(self, checkpoint=None, signals=(signal.SIGTERM, signal.SIGINT),
                 exit_code: int = RESUMABLE_EXIT_CODE,
                 exit_fn: Callable[[int], None] = sys.exit):
        self.checkpoint = checkpoint
        self.signals = tuple(signals)
        self.exit_code = int(exit_code)
        self.exit_fn = exit_fn
        self._preempted = False
        self._signum: Optional[int] = None
        self._prev_handlers: dict = {}
        self._installed = False

    # -- signal plumbing ---------------------------------------------------
    def _handler(self, signum, frame):
        self._preempted = True
        self._signum = signum

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            # signal.signal raises off the main thread: a guard without
            # handlers (check() still works after preempt())
            return self
        for s in self.signals:
            try:
                self._prev_handlers[s] = signal.signal(s, self._handler)
            except (ValueError, OSError):
                pass
        self._installed = True
        return self

    def uninstall(self) -> None:
        for s, h in self._prev_handlers.items():
            try:
                signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- step-boundary API -------------------------------------------------
    @property
    def preempted(self) -> bool:
        return self._preempted

    def preempt(self) -> None:
        """Mark the guard preempted without a real signal (tests, schedulers
        with their own notification channel)."""
        self._preempted = True

    def check(self, step: int, state_dict=None) -> bool:
        """Call once per completed step ``step``. Fires the
        ``preempt.sigterm`` injection point, and if a preemption arrived:
        drains, writes a final synchronous checkpoint of ``state_dict`` at
        ``step`` and exits with the resumable code."""
        from . import inject

        if inject._armed and inject.should_fire("preempt.sigterm", step=step):
            signal.raise_signal(signal.SIGTERM)  # runs our handler inline
        if not self._preempted:
            return False
        self.drain(step, state_dict)
        self.exit_fn(self.exit_code)
        return True  # only reached when exit_fn returns (tests)

    def drain(self, step: Optional[int] = None, state_dict=None) -> None:
        """Publish a ``preempt_drain`` progress record to the distributed
        watchdog (peers and the launcher's report see this rank leave
        through a drain, not silently stop stepping), wait for the card's
        queued work, write a flight-recorder dump (the preempted worker's
        last spans and counters survive the exit), and force a final
        synchronous checkpoint."""
        try:
            from ..distributed import watchdog

            watchdog.publish(step=step, phase="preempt_drain", force=True)
        except Exception:
            pass
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _counter("preemption_drains")
        try:
            from ..profiler import flight

            flight.dump("preemption",
                        extra={"step": step, "signum": self._signum})
        except Exception:
            pass
        if self.checkpoint is not None and state_dict is not None \
                and step is not None and step >= 0:
            self.checkpoint.save_now(step, state_dict, sync=True)


__all__ = ["PreemptionGuard", "RESUMABLE_EXIT_CODE"]
