"""Opt-in runtime ownership assertions (``FLAGS_thread_checks``; port of
``paddle_tpu/analysis/thread_checks.py``).

The static lock checker proves LEXICAL discipline: every mutation of an
annotated structure sits inside ``with <lock>:``. It cannot prove dynamic
discipline — a helper called with the lock already held, a structure handed
to a thread it was never meant for. This module closes that gap: with
``FLAGS_thread_checks=1`` (off by default; chaos/async suites turn it on)
annotated structures (the watchdog's ``_guards`` and ``_local``, the
``DevicePrefetcher``'s resume anchor) are wrapped in proxies that make a
racy mutation fail DETERMINISTICALLY at the mutation site, instead of as a
corrupted table three steps later:

* :func:`guarded` — mutations assert the guarding lock is currently held
  (``lock.locked()`` for a ``Lock``, owner check for an ``RLock``);
* :func:`owned` — mutations assert they happen on the structure's owner
  thread (bound at wrap time or first mutation);
* :func:`requires_lock` — the decorator counterpart of the static checker's
  escape hatch: the wrapped function asserts its lock is held on entry.

All three are identity/no-op when the flag is off, so production pays one
flag probe at WRAP time (not per mutation).
"""
from __future__ import annotations

import threading
from typing import Optional

__all__ = [
    "enabled", "guarded", "owned", "requires_lock", "GuardedDict",
    "OwnershipError",
]

# named mutating methods routed through __getattr__; the mutating SPECIAL
# methods (item store/delete, += , |=) are real methods on the proxy below —
# implicit special-method lookup never consults __getattr__
_MUTATORS = (
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse", "rotate", "move_to_end",
)


class OwnershipError(AssertionError):
    """A thread mutated a checked structure without holding its lock /
    without being its owner. An AssertionError subclass: this is a bug in
    the calling code, never a recoverable runtime condition."""


def enabled() -> bool:
    from ..framework import flags

    return bool(flags.flag("FLAGS_thread_checks", False))


def _lock_held(lock) -> bool:
    # RLock exposes ownership — guard shared structures with an RLock so an
    # unguarded mutation that merely OVERLAPS another thread's locked region
    # is still caught. A plain Lock only answers "is locked by somebody":
    # every mutation with the lock free still fails deterministically, but a
    # concurrent holder masks the check for that window.
    owned_fn = getattr(lock, "_is_owned", None)
    if owned_fn is not None:
        try:
            return bool(owned_fn())
        except Exception:
            pass
    try:
        return bool(lock.locked())
    except Exception:
        return True  # unknown lock type: don't turn diagnostics into crashes


class _CheckedProxy:
    """Wraps a container; every known-mutating method first runs ``check``.
    Reads pass through untouched. Not a subclass: isinstance checks on the
    wrapped type are intentionally broken under the flag so tests notice
    they're running checked."""

    __slots__ = ("_obj", "_check", "_name")

    def __init__(self, obj, check, name):
        self._obj = obj
        self._check = check
        self._name = name

    def __getattr__(self, attr):
        val = getattr(self._obj, attr)
        if attr in _MUTATORS and callable(val):
            check = self._check

            def checked(*a, _val=val, **k):
                check()
                return _val(*a, **k)

            return checked
        return val

    def __getitem__(self, k):
        return self._obj[k]

    def __setitem__(self, k, v):
        self._check()
        self._obj[k] = v

    def __delitem__(self, k):
        self._check()
        del self._obj[k]

    def __iadd__(self, other):
        self._check()
        self._obj += other
        return self  # the holder's name stays bound to the checked proxy

    def __ior__(self, other):
        self._check()
        self._obj |= other
        return self

    def __contains__(self, k):
        return k in self._obj

    def __iter__(self):
        return iter(self._obj)

    def __len__(self):
        return len(self._obj)

    def __bool__(self):
        return bool(self._obj)

    def __eq__(self, other):
        return self._obj == (other._obj if isinstance(other, _CheckedProxy) else other)

    def __repr__(self):
        return f"checked({self._name}: {self._obj!r})"


GuardedDict = _CheckedProxy  # the common instantiation, re-exported by name


def guarded(obj, lock, name: str = "structure"):
    """Wrap ``obj`` so every mutation asserts ``lock`` is held. Identity
    when ``FLAGS_thread_checks`` is off (and when ``obj`` is already
    wrapped — re-wrapping on reconfigure must not stack proxies)."""
    if not enabled():
        return obj
    if isinstance(obj, _CheckedProxy):
        return obj

    def check():
        if not _lock_held(lock):
            raise OwnershipError(
                f"unguarded mutation of {name} on thread "
                f"{threading.current_thread().name!r}: its guarded_by lock "
                "is not held"
            )

    return _CheckedProxy(obj, check, name)


def owned(obj, name: str = "structure",
          owner: Optional[threading.Thread] = None):
    """Wrap ``obj`` so every mutation asserts it runs on the owner thread
    (default: the thread performing the first mutation). Identity when the
    flag is off."""
    if not enabled():
        return obj
    if isinstance(obj, _CheckedProxy):
        return obj
    box = [owner]

    def check():
        cur = threading.current_thread()
        if box[0] is None:
            box[0] = cur
            return
        if box[0] is not cur:
            raise OwnershipError(
                f"{name} is owned by thread {box[0].name!r} but was mutated "
                f"from {cur.name!r}"
            )

    return _CheckedProxy(obj, check, name)


def unwrap(obj):
    """The raw container behind a checked proxy (identity otherwise)."""
    return obj._obj if isinstance(obj, _CheckedProxy) else obj


def requires_lock(lock, name: Optional[str] = None):
    """Decorator: the static checker accepts mutations inside the decorated
    function as guarded; under ``FLAGS_thread_checks`` the assumption is
    verified on every call. ``lock`` may also be a string naming an
    attribute on the first positional arg (``@requires_lock("_lock")`` on a
    method resolves ``self._lock`` at call time)."""

    def wrap(fn):
        if isinstance(lock, str):
            def wrapped(*a, **k):
                if enabled():
                    lk = getattr(a[0], lock, None) if a else None
                    if lk is None:
                        import sys

                        lk = getattr(sys.modules.get(fn.__module__), lock, None)
                    if lk is not None and not _lock_held(lk):
                        raise OwnershipError(
                            f"{fn.__qualname__} requires {lock} held"
                        )
                return fn(*a, **k)
        else:
            def wrapped(*a, **k):
                if enabled() and not _lock_held(lock):
                    raise OwnershipError(
                        f"{fn.__qualname__} requires "
                        f"{name or 'its lock'} held"
                    )
                return fn(*a, **k)
        wrapped.__name__ = fn.__name__
        wrapped.__qualname__ = fn.__qualname__
        wrapped.__doc__ = fn.__doc__
        wrapped.__wrapped__ = fn
        return wrapped

    return wrap
