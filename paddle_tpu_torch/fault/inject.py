"""Deterministic fault injection (port of the serving, memory-pressure,
preemption and training-stability points of ``paddle_tpu/fault/inject.py``).

Every injection point has a stable name (:data:`POINTS`) and is consulted
only while injection is armed, so the hot path pays one module-attribute
probe (``_armed``). Points are armed from the environment
(``PADDLE_FAULT_INJECT``) or with :func:`arm`.

Spec grammar (the environment variable or :func:`arm`'s string form)::

    point[:k=v[,k=v...]][;point2:...]

    PADDLE_FAULT_INJECT="serve.slow_step:at=1,ms=500;serve.crash:step=24"

Keys (all optional; values are ints except ``op``):

* ``at=N``    — fire on the Nth matching call of this point (1-based).
* ``from=N``  — fire on every matching call from the Nth on.
* ``step=K``  — fire when the call carries ``step == K``.
* ``op=NAME`` — only calls that carry ``op == NAME`` match.
* ``rank=R``  — only calls that carry ``rank == R`` match.
* ``call=N``  — with ``op=``: the Nth call of that op (alias of ``at``).
* ``times=M`` — fire at most M times in all (default: unlimited).
* ``ms=N``    — ``serve.slow_step``/``serve.wedge`` payload: the delay.
* ``bytes=N`` — ``hbm.pressure`` payload: synthetic live-byte pressure.
* ``blocks=N`` — ``hbm.pressure`` payload: serving KV blocks parked when
  the point fires at a scheduler step.
* ``scale=N`` — ``loss.spike``/``grad.spike`` payload: the multiplier
  (default 1000); ``nonfinite=1`` makes it ``inf``.
* ``exit=N``  — ``rank.kill`` payload: the exit code (default 137).

The serving points are consulted by the engine's scheduler thread at every
step boundary; ``serve.snapshot_corrupt`` fires inside ``Engine.snapshot``
and tears the captured pool bookkeeping, so ``Engine.adopt`` must reject
the capture and fall back whole to re-prefill. ``hbm.oom`` synthesizes a
device out-of-memory error at a named site (:func:`maybe_hbm_oom`; ``op=``
selects the site, ``serve.step`` for the engine). ``preempt.sigterm``
raises SIGTERM inside ``PreemptionGuard.check`` at ``step=K``;
``loss.spike``/``grad.spike`` are read at the train step boundary through
:func:`spike` (``StabilitySentinel.maybe_spike``). The failure-type points
``store.op``, ``ckpt.write``, ``ckpt.serialize``, ``ckpt.ack`` and
``ckpt.commit`` raise :class:`InjectedFault` through :func:`check`; the
chaos points ``rank.kill``/``rank.hang``/``rank.slow`` act in
``watchdog.publish`` (:func:`chaos`) and ``collective.drop`` in
``watchdog.guard`` (:func:`chaos_drop`). ``tensor.nan`` is consulted by
``core/dispatch.py``'s nan/inf scan, op by op, while ``FLAGS_check_nan_inf``
is set: it writes a NaN into the named op's output
(:func:`poison_first_nan`) before the scan checks it.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

import torch

# Registered injection point names -> where they are threaded.
POINTS: Dict[str, str] = {
    "serve.crash": "serving engine loop — raise inside the scheduler step",
    "serve.wedge": ("serving engine loop — wedge the scheduler thread "
                    "(ms=N bounds it)"),
    "serve.slow_step": ("serving engine loop — per-step straggler delay "
                        "(ms=N, default 100)"),
    "serve.pool_corrupt": ("serving engine loop — break PagePool "
                           "conservation (next free raises)"),
    "serve.snapshot_corrupt": ("Engine.snapshot — tear the pool capture so "
                               "adopt() must reject it and fall back whole"),
    "tensor.nan": ("core/dispatch.py's nan/inf scan (while "
                   "FLAGS_check_nan_inf is set) — NaN into a named op's "
                   "output (op=aten name, e.g. aten::mul.Tensor)"),
    "hbm.oom": ("named sites (op=serve.step) — synthesize a device "
                "out-of-memory error there"),
    "hbm.pressure": ("memory pressure: bytes=N is read by pressure_bytes() "
                     "while armed; blocks=N parks serving pool blocks at "
                     "the scheduler step boundary"),
    "preempt.sigterm": "PreemptionGuard.check(step=k) — SIGTERM at step k",
    "loss.spike": ("train step boundary — scale the step's loss "
                   "(scale=/nonfinite= payload)"),
    "grad.spike": ("train step boundary — scale the step's gradients "
                   "(scale=/nonfinite= payload)"),
    "store.op": "store operations in fleet/elastic (set/get/add)",
    "ckpt.write": "distributed/checkpoint.py save_state_dict write path",
    "ckpt.serialize": "coordinated save — crash during state serialization",
    "ckpt.ack": "coordinated save — crash after durable write, before the ack",
    "ckpt.commit": ("coordinated save — crash between full acks and the "
                    "commit record"),
    "rank.kill": ("watchdog.publish — hard-kill this rank (os._exit, "
                  "default 137)"),
    "rank.hang": "watchdog.publish — wedge this rank in a sleep loop forever",
    "rank.slow": "watchdog.publish — straggler delay (ms=N, default 1000)",
    "collective.drop": ("watchdog.guard enter — this rank never joins the "
                        "collective"),
}


class InjectedFault(OSError):
    """Raised by failure-type injection points (:func:`check`). An OSError,
    so retry helpers treat it as transient (``times=`` bounds it)."""

    def __init__(self, point: str, ctx: Optional[dict] = None):
        super().__init__(f"injected fault at '{point}' (ctx={ctx or {}})")
        self.point = point
        self.ctx = dict(ctx or {})


_lock = threading.Lock()
_armed = False
_active: Dict[str, dict] = {}  # guarded_by: _lock
_calls: Dict[str, int] = {}  # guarded_by: _lock
_fired: Dict[str, int] = {}  # guarded_by: _lock
_exercised: set = set()  # every point that ever fired in this process


def _parse_spec(spec: str) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        point, _, raw = part.partition(":")
        point = point.strip()
        cfg: dict = {}
        for kv in raw.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, _, v = kv.partition("=")
            k = k.strip()
            cfg[k] = v.strip() if k == "op" else int(v)
        out[point] = cfg
    return out


def arm(spec) -> None:
    """Arm injection. ``spec`` is the string grammar above or a dict
    ``{point: {key: value}}``. Unknown point names raise KeyError (a typo in
    a fault spec must not silently disable the fault)."""
    global _armed
    cfgs = _parse_spec(spec) if isinstance(spec, str) else {
        k: dict(v) for k, v in spec.items()}
    for point in cfgs:
        if point not in POINTS:
            import difflib

            hint = difflib.get_close_matches(point, POINTS, n=1)
            raise KeyError(
                f"unknown injection point {point!r}"
                + (f"; did you mean {hint[0]!r}?" if hint
                   else f"; known: {sorted(POINTS)}"))
    with _lock:
        _active.clear()
        _active.update(cfgs)
        _calls.clear()
        _fired.clear()
        _armed = bool(_active)


def disarm() -> None:
    """Disarm every injection point (counters reset)."""
    global _armed
    with _lock:
        _active.clear()
        _calls.clear()
        _fired.clear()
        _armed = False


def armed() -> bool:
    return _armed


def should_fire(point: str, step: Optional[int] = None,
                op: Optional[str] = None, rank: Optional[int] = None) -> bool:
    """Decide whether ``point`` fires for this call. Only calls that pass
    the ``op=``/``rank=`` filters are counted, so ``at=N`` means the Nth
    call of that op or rank whatever else runs."""
    if point not in POINTS:
        raise KeyError(f"unknown injection point {point!r}; "
                       f"known: {sorted(POINTS)}")
    if not _armed:
        return False
    with _lock:
        cfg = _active.get(point)
        if cfg is None:
            return False
        if "op" in cfg and op != cfg["op"]:
            return False
        if "rank" in cfg and (rank is None or int(rank) != cfg["rank"]):
            return False
        n = _calls.get(point, 0) + 1
        _calls[point] = n
        at = cfg.get("at", cfg.get("call"))
        if "step" in cfg:
            fire = step is not None and int(step) == cfg["step"]
        elif at is not None:
            fire = n == at
        elif "from" in cfg:
            fire = n >= cfg["from"]
        else:
            fire = True
        if fire:
            times = cfg.get("times")
            if times is not None and _fired.get(point, 0) >= times:
                return False
            _fired[point] = _fired.get(point, 0) + 1
            _exercised.add(point)
        return fire


def check(point: str, **ctx) -> None:
    """Raise :class:`InjectedFault` when ``point`` fires."""
    if should_fire(point, step=ctx.get("step"), op=ctx.get("op"),
                   rank=ctx.get("rank")):
        raise InjectedFault(point, ctx)


def fired_counts() -> Dict[str, int]:
    """How many times each armed point fired since it was armed."""
    with _lock:
        return dict(_fired)


def point_cfg(point: str) -> dict:
    """The armed config of ``point`` ({} when not armed): payload keys such
    as ``ms=`` or ``blocks=``."""
    with _lock:
        return dict(_active.get(point) or {})


def _hang(point: str) -> None:
    """Wedge the calling thread: announces on stderr, then sleeps forever."""
    import sys as _sys
    import time as _time

    _sys.stderr.write(f"paddle_tpu_torch.fault.inject: '{point}' fired — "
                      "thread wedged\n")
    _sys.stderr.flush()
    while True:
        _time.sleep(3600)


def chaos(step: Optional[int] = None, rank: Optional[int] = None,
          phase: Optional[str] = None) -> None:
    """The ``rank.*`` chaos points (``watchdog.publish``): ``rank.slow``
    sleeps ``ms=`` (default 1000), ``rank.hang`` wedges forever,
    ``rank.kill`` exits at once with ``exit=`` (default 137, not
    resumable: the launcher sees a real failure)."""
    import time as _time

    if not _armed:
        return
    if should_fire("rank.slow", step=step, rank=rank):
        _time.sleep(point_cfg("rank.slow").get("ms", 1000) / 1000.0)
    if should_fire("rank.hang", step=step, rank=rank):
        _hang("rank.hang")
    if should_fire("rank.kill", step=step, rank=rank):
        import sys as _sys

        code = point_cfg("rank.kill").get("exit", 137)
        _sys.stderr.write("paddle_tpu_torch.fault.inject: 'rank.kill' fired "
                          f"— exit {code}\n")
        _sys.stderr.flush()
        os._exit(code)


def chaos_drop(rank: Optional[int] = None, step: Optional[int] = None) -> None:
    """``collective.drop``: wedge this rank right before it would enter a
    guarded collective, so its peers wait until their watchdog deadline."""
    if _armed and should_fire("collective.drop", step=step, rank=rank):
        _hang("collective.drop")


def exercised() -> set:
    """Point names that have fired at least once in this process."""
    return set(_exercised)


def hbm_oom_error(where: str) -> torch.OutOfMemoryError:
    """The error a device out-of-memory raises (``torch.OutOfMemoryError``,
    which ``torch.cuda.OutOfMemoryError`` names), carrying the reference's
    ``RESOURCE_EXHAUSTED`` text, so ``fault.memory.is_oom`` classifies it
    as it classifies the real one."""
    return torch.OutOfMemoryError(
        f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        f"1073741824 bytes (injected hbm.oom at '{where}')")


def maybe_hbm_oom(where: str, step: Optional[int] = None,
                  rank: Optional[int] = None) -> None:
    """Consult ``hbm.oom`` at the site ``where`` (matched against ``op=``)
    and raise :func:`hbm_oom_error` from there when it fires."""
    if _armed and should_fire("hbm.oom", step=step, op=where, rank=rank):
        raise hbm_oom_error(where)


def spike(point: str, step: Optional[int] = None,
          rank: Optional[int] = None) -> Optional[float]:
    """Consult ``loss.spike`` or ``grad.spike`` at the step boundary: the
    multiplier for the step's loss or gradients (``scale=``, default 1000,
    or ``inf`` with ``nonfinite=1``), or None when the point does not
    fire."""
    if point not in ("loss.spike", "grad.spike"):
        raise KeyError(f"not a spike point: {point!r}")
    if not _armed or not should_fire(point, step=step, rank=rank):
        return None
    cfg = point_cfg(point)
    if cfg.get("nonfinite"):
        return float("inf")
    return float(cfg.get("scale", 1000))


def poison_first_nan(res) -> bool:
    """Overwrite the first element of the first floating-point tensor of an
    op's result (a tensor or a sequence of them) with NaN, in place and
    unrecorded; False when there is none."""
    ts = res if isinstance(res, (list, tuple)) else [res]
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and t.numel():
            with torch.no_grad():
                t[(0,) * t.dim()] = float("nan")
            return True
    return False


def pressure_bytes() -> int:
    """Synthetic live-byte pressure (``hbm.pressure:bytes=N``), read while
    armed without consuming a ``should_fire`` count (pressure is a level,
    not an event); 0 when unarmed or without ``bytes=``."""
    if not _armed:
        return 0
    cfg = point_cfg("hbm.pressure")
    b = int(cfg.get("bytes", 0)) if cfg else 0
    if b:
        _exercised.add("hbm.pressure")
    return b


def _arm_from_env() -> None:
    """Arm the points of ``PADDLE_FAULT_INJECT`` that this module has; the
    variable is shared with the reference package, whose other points
    (store, checkpoint, collective, rank chaos) have no call site here."""
    spec = os.environ.get("PADDLE_FAULT_INJECT", "").strip()
    ours = {k: v for k, v in _parse_spec(spec).items() if k in POINTS}
    if ours:
        arm(ours)


_arm_from_env()

__all__ = ["POINTS", "InjectedFault", "arm", "disarm", "armed",
           "should_fire", "check", "point_cfg", "exercised", "fired_counts",
           "hbm_oom_error", "maybe_hbm_oom", "spike", "pressure_bytes",
           "poison_first_nan"]
