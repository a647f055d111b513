"""Process-wide counters and a minimal ``span`` context manager.

``counter_inc``/``counters`` back the ``serve_*`` counters that
``serving.Engine`` bumps. ``span`` keeps the reference's call shape
(``with span(name, **attrs) as sp: sp.set(...)``) but records nothing yet.
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict

_lock = threading.Lock()
_counters = defaultdict(int)  # guarded_by: _lock


def counter_inc(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += int(n)


def counters() -> dict:
    with _lock:
        return dict(_counters)


class _Span:
    __slots__ = ("name", "attrs")

    def __init__(self, name, attrs):
        self.name = name
        self.attrs = attrs

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)


@contextlib.contextmanager
def span(name: str, **attrs):
    yield _Span(name, attrs)


__all__ = ["counter_inc", "counters", "span"]
