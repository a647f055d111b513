"""Retry with exponential backoff (port of ``paddle_tpu/fault/retry.py``),
for every transient-I/O seam: a flaky store round-trip or checkpoint write
is retried instead of promoted to a dead worker or a lost checkpoint. Each
performed retry bumps the profiler counter ``retry_attempts``.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, Type

# Transient-looking errors. InjectedFault subclasses OSError, so injected
# failures exercise exactly this path.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    OSError, ConnectionError, TimeoutError,
)


def _counter(name: str, n: int = 1):
    try:
        from .. import profiler

        profiler.counter_inc(name, n)
    except Exception:
        pass


def retry_call(
    fn: Callable,
    *args,
    retries: int = 3,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    exceptions: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
    on_retry: Callable = None,
    sleep: Callable = time.sleep,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``; on a retryable error, back off
    exponentially (``base_delay * 2**attempt``, capped at ``max_delay``) and
    try again up to ``retries`` more times. The final failure re-raises."""
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except exceptions as e:
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            attempt += 1
            _counter("retry_attempts")
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)


def retrying(**retry_kwargs):
    """Decorator form of :func:`retry_call`."""

    def deco(fn):
        def wrapped(*args, **kwargs):
            return retry_call(fn, *args, **retry_kwargs, **kwargs)

        wrapped.__name__ = getattr(fn, "__name__", "retrying")
        wrapped.__doc__ = fn.__doc__
        return wrapped

    return deco


__all__ = ["retry_call", "retrying", "DEFAULT_RETRYABLE"]
