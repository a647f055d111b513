"""Training stability sentinel: anomaly detection, batch quarantine and
rollback (port of ``paddle_tpu/fault/sentinel.py``).

A loss spike or a gradient explosion is finite: the nan/inf scan never
trips on it, and the run burns card hours on poisoned weights. The sentinel
watches each step's signals and escalates:

* **Signals**, one device computation a step, read back once as four
  floats: ``loss``, ``grad_norm`` (the global L2 over every gradient, from
  ``torch._foreach_norm`` in float32), ``nonfinite`` (the share of
  non-finite gradient elements, or 1 for a non-finite loss) and
  ``upd_ratio`` (``lr·‖g‖/‖p‖``). The exact non-finite count costs a second
  pass, taken only when the gradient norm is not finite (it is 0
  otherwise).
* **Robust statistics**: per signal a median/MAD over a bounded window with
  a warm-up; a sample is anomalous when its one-sided robust z-score
  exceeds ``zmax``; a non-finite signal always is. Anomalous samples are
  never folded into the statistics.
* **Policy ladder** on a trip: (1) **skip**, the caller withholds the
  step's update and the batch is quarantined; (2) **rollback** to the
  newest anchor checkpoint strictly older than the poisoned step; (3)
  **halt**, a :class:`StabilityError` after a flight-recorder dump.

Detection is synchronous, as the reference's with ``FLAGS_lazy_async=0``:
``observe`` judges the step before the caller applies its update, and the
skip rung is always possible. ``committed=True`` (an update that was
already applied) defers the judgment to the next ``observe``/``poll``,
which can only roll back; while a sentinel is active, the lazy engine's
drain points (``core/lazy.py``: each flush, each materialization,
``sync()``) tap it, and a committed step whose signal pack the card has
already finished is read there without waiting, so the later judgment
finds its four floats in hand. ``rollback`` works against any anchor with ``resume(state,
max_step)``, ``invalidate``, ``protect`` and ``release``:
``distributed.checkpoint.AutoCheckpoint`` (which ``from_flags`` builds in
``FLAGS_stability_ckpt_dir``) or ``CoordinatedCheckpoint``.
:class:`VerdictBarrier` gives every rank the world's most severe verdict
through ``coord.CommitBarrier`` rounds, and ``for_engine`` wires a
sentinel to a ``distributed.HybridParallelEngine``: its anchors hold
``engine_state_dict`` and a rollback restores through
``engine_apply_state``, while ``attach_sentinel`` feeds it each step's loss
as a committed observation. The ``hapi.Model.fit`` hook comes with
ROADMAP A12.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "SIGNALS", "StabilityError", "StabilityVerdict", "QuarantineLog",
    "StabilitySentinel", "VerdictBarrier", "last_signals",
]

SIGNALS = ("loss", "grad_norm", "nonfinite", "upd_ratio")
# robust z denominator: 1.4826·MAD (normal-consistent) + a 2%-of-median
# relative floor so a converged, nearly-constant signal doesn't trip on
# numerical wobble while a 100x spike still scores in the thousands
_MAD_SCALE = 1.4826
_REL_FLOOR = 0.02


class StabilityError(RuntimeError):
    """The sentinel exhausted its policy ladder (or had no rollback anchor).
    Carries the tripping signal, its value/z-score and the recent history."""

    def __init__(self, message: str, verdict: "StabilityVerdict" = None,
                 history: Optional[list] = None):
        super().__init__(message)
        self.verdict = verdict
        self.history = list(history or ())


class StabilityVerdict:
    """One anomaly decision. ``action`` is ``"skip"``/``"rollback"``/
    ``"halt"``; ``late`` means the flagged step's update had already
    committed when it was judged; ``origin_rank`` names the rank whose
    detector tripped when the verdict came from another rank (None =
    local)."""

    __slots__ = ("action", "step", "pos", "signal", "value", "zscore",
                 "late", "signals", "origin_rank")

    def __init__(self, action, step, pos, signal, value, zscore, late, signals,
                 origin_rank=None):
        self.action = action
        self.step = int(step)
        self.pos = pos
        self.signal = signal
        self.value = float(value)
        self.zscore = float(zscore)
        self.late = bool(late)
        self.signals = dict(signals)
        self.origin_rank = origin_rank

    def to_dict(self) -> dict:
        return {
            "action": self.action, "step": self.step, "pos": self.pos,
            "signal": self.signal, "value": self.value, "zscore": self.zscore,
            "late": self.late, "signals": self.signals,
            "origin_rank": self.origin_rank,
        }

    def __repr__(self):
        return (f"StabilityVerdict({self.action}, step={self.step}, "
                f"signal={self.signal}, value={self.value:.4g}, "
                f"z={self.zscore:.1f}, late={self.late})")


class QuarantineLog:
    """Bounded in-memory record (plus optional JSONL file) of quarantined
    batches: step, loader position, sample indices and the signal values
    that condemned them. The training loop consults :meth:`is_quarantined`
    during replay so a rolled-back run skips the bad batch window at the
    index level."""

    def __init__(self, path: Optional[str] = None, capacity: int = 1024):
        self._path = path
        self._entries: "collections.deque" = collections.deque(maxlen=capacity)
        self._steps: set = set()
        self._positions: set = set()

    def add(self, step: int, pos=None, sample_indices=None,
            signals: Optional[dict] = None, action: str = "skip") -> dict:
        if len(self._entries) == self._entries.maxlen:
            # keep the membership index in lockstep with the bounded ring:
            # drop the evicted record's keys unless a surviving entry still
            # claims them (rare; the scan is per-eviction, not per-lookup)
            old = self._entries[0]
            if not any(e["step"] == old["step"] for e in list(self._entries)[1:]):
                self._steps.discard(old["step"])
            if old["pos"] is not None and not any(
                e["pos"] == old["pos"] for e in list(self._entries)[1:]
            ):
                self._positions.discard(tuple(old["pos"]))
        rec = {
            "step": int(step),
            "pos": list(pos) if pos is not None else None,
            "sample_indices": (
                [int(i) for i in sample_indices]
                if sample_indices is not None else None
            ),
            "signals": dict(signals or {}),
            "action": action,
        }
        self._entries.append(rec)
        self._steps.add(int(step))
        if pos is not None:
            self._positions.add(tuple(pos))
        if self._path:
            try:
                with open(self._path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass  # the quarantine decision must not die with its log line
        return rec

    def is_quarantined(self, pos=None, step: Optional[int] = None) -> bool:
        if pos is not None and tuple(pos) in self._positions:
            return True
        return step is not None and int(step) in self._steps

    def entries(self) -> List[dict]:
        return list(self._entries)

    def __len__(self):
        return len(self._entries)


# -- device-side signal pack --------------------------------------------------
_SEVERITY = {"skip": 1, "rollback": 2, "halt": 3}


class VerdictBarrier:
    """Store-mediated cross-rank verdict agreement.

    With all-reduced gradients a spike trips every rank's detector in the
    same step, so coordinated rollback falls out of determinism. A
    rank-LOCAL anomaly — host memory corrupting one rank's batch, a bad
    DataLoader worker — trips ONE detector, and without coordination that
    rank rolls back alone while its peers march on: the world diverges.
    This barrier reuses :class:`~paddle_tpu_torch.distributed.coord.CommitBarrier`
    rounds so every rank leaves each step boundary with the SAME verdict:

    1. each rank publishes its local verdict (if any) for the round, then
       acks the round's two-phase barrier — after rank 0's commit record no
       rank can still be writing;
    2. every rank reads every peer's verdict and adopts the most severe one
       posted anywhere (ties broken by z-score, then rank);
    3. ranks whose own detector stayed silent fold the adopted verdict into
       their sentinel (:meth:`StabilitySentinel.adopt`): same quarantine
       entry, same ladder rung — the subsequent ``rollback`` then resolves
       one anchor world-wide through the existing store-mediated resume
       agreement.

    ``exchange`` must be called once per step attempt on EVERY rank, in
    lockstep (rounds are monotonic and never reused, so no ``reset`` litter
    race exists). A barrier timeout degrades to the local verdict — a dead
    peer is the watchdog's jurisdiction, and stalling recovery on it would
    hang the healthy ranks.
    """

    def __init__(self, store, world_size: int, rank: int, sentinel=None,
                 prefix: str = "stability", timeout_s: float = 60.0):
        from ..distributed.coord import CommitBarrier

        self.store = store
        self.world_size = int(world_size)
        self.rank = int(rank)
        self.prefix = prefix
        self.timeout_s = float(timeout_s)
        self._bar = CommitBarrier(store, world_size, rank,
                                  prefix=f"{prefix}/bar")
        self._sentinel = weakref.ref(sentinel) if sentinel is not None else None
        self._round = 0

    def exchange(self, verdict: Optional[StabilityVerdict]
                 ) -> Optional[StabilityVerdict]:
        """One coordination round: publish this rank's ``verdict`` (or
        None), synchronize, return the world-agreed verdict (or None)."""
        from .. import profiler as _prof

        tag = self._round
        self._round += 1
        if verdict is not None:
            self.store.set(
                f"{self.prefix}/v/{tag}/r{self.rank}",
                json.dumps(verdict.to_dict()),
            )
        try:
            self._bar.ack(tag)
            self._bar.commit(tag, self.timeout_s)
        except Exception:
            _prof.counter_inc("stability_barrier_timeouts")
            return verdict
        # bounded store footprint: round N's commit proves every rank left
        # round N-1 long ago, so its barrier keys and this rank's verdict
        # key can go — one live round instead of one key pair per step
        if tag:
            self._bar.reset(tag - 1)
            self.store.delete_key(f"{self.prefix}/v/{tag - 1}/r{self.rank}")
        # most severe verdict posted anywhere, ties broken by z-score then
        # LOWEST rank — the full key is identical on every rank, so equal
        # (severity, z) verdicts (e.g. two rank-local nonfinite trips, both
        # z=inf) still resolve to ONE world-wide choice
        cands = [(self.rank, verdict)] if verdict is not None else []
        for r in range(self.world_size):
            if r == self.rank:
                continue
            raw = self.store.get(f"{self.prefix}/v/{tag}/r{r}")
            if not raw:
                continue
            d = json.loads(raw)
            cands.append((r, StabilityVerdict(
                d["action"], d["step"],
                tuple(d["pos"]) if d.get("pos") else None,
                d["signal"], d["value"], d["zscore"], True,
                d.get("signals") or {}, origin_rank=r,
            )))
        if not cands:
            return None
        _, best = max(
            cands,
            key=lambda rv: (_SEVERITY.get(rv[1].action, 0), rv[1].zscore, -rv[0]),
        )
        if best.origin_rank is not None and verdict is None:
            # a remote detector tripped and the LOCAL one stayed silent:
            # fold the verdict into the local sentinel so quarantine +
            # ladder state stay world-consistent. A rank whose own verdict
            # was merely OUTRANKED already consumed its rung (and
            # quarantined the same world-shared batch) in _judge — adopting
            # on top would double-count the incident budget and desync the
            # ladders across ranks.
            s = self._sentinel() if self._sentinel is not None else None
            if s is not None:
                s.adopt(best)
        return best


def _pack(loss, lr, grads, params) -> torch.Tensor:
    """``[loss, grad_norm, probe, upd_ratio]`` as one float32 device tensor.
    ``probe`` is 1 when the gradient norm is not finite (the exact
    non-finite share is then counted at the readback), else 0."""
    f32 = torch.float32
    dev = grads[0].device if grads else loss.device
    zero = torch.zeros((), dtype=f32, device=dev)
    loss_v = (loss.detach().to(dev, f32).mean() if loss is not None
              else zero)
    if grads:
        gnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads, 2, dtype=f32)))
        probe = (~torch.isfinite(gnorm)).to(f32)
    else:
        gnorm = probe = zero
    if params and lr is not None and grads:
        pnorm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(params, 2, dtype=f32)))
        upd = float(np.float32(lr)) * gnorm / (pnorm + 1e-12)
    else:
        upd = zero
    return torch.stack([loss_v, gnorm, probe, upd])


def _nonfinite_share(loss, grads) -> float:
    """The reference's ``nonfinite``: the share of non-finite gradient
    elements, or 1 when the loss is not finite."""
    share = 0.0
    if grads:
        bad = sum(int((~torch.isfinite(g)).sum()) for g in grads)
        share = bad / float(sum(g.numel() for g in grads))
    if loss is not None and not bool(torch.isfinite(
            loss.detach().float().mean())):
        share = max(share, 1.0)
    return share


# -- active sentinels (the flight recorder's "stability" context) -----------
_active: "weakref.WeakSet" = weakref.WeakSet()
_last_signals: Dict[str, float] = {}  # most recent judged signals (any sentinel)


def last_signals() -> Dict[str, float]:
    """The most recently judged signal values across all sentinels (plus
    ``loss_ema``)."""
    return dict(_last_signals)


def _tap_all() -> None:
    """The lazy engine's drain tap while a sentinel is active: a
    non-blocking sweep that reads the committed steps whose signal pack is
    finished. Never raises and never flushes."""
    for s in list(_active):
        try:
            s._tap()
        except Exception:  # lint: ok(oom-handler) — a readiness sweep; the judgment reads again
            pass


def _register(s: "StabilitySentinel") -> None:
    from ..core import lazy
    from ..profiler import flight as _flight

    _active.add(s)
    _flight.add_context_provider("stability", _flight_context)
    lazy._stability_tap = _tap_all


def _unregister(s: "StabilitySentinel") -> None:
    _active.discard(s)
    if not _active:
        from ..core import lazy
        from ..profiler import flight as _flight

        _flight.remove_context_provider("stability")
        lazy._stability_tap = None


def _flight_context() -> dict:
    return {"sentinels": [s._context() for s in list(_active)],
            "last_signals": dict(_last_signals)}


class _SignalStats:
    """Median/MAD over a bounded window, with warmup. Anomalous samples are
    reported but NOT folded in (a quarantined spike must not shift the
    baseline it was judged against)."""

    __slots__ = ("window", "warmup", "zmax", "_ring")

    def __init__(self, window: int, warmup: int, zmax: float):
        self.window = int(window)
        # warmup > window would keep the detector in warmup FOREVER (the
        # ring can never outgrow its maxlen) — clamp so the configuration
        # degrades to "full-window warmup" instead of a silently dead check
        self.warmup = min(int(warmup), self.window)
        self.zmax = float(zmax)
        self._ring: "collections.deque" = collections.deque(maxlen=self.window)

    def score(self, x: float) -> Tuple[bool, float]:
        """(anomalous, robust_z) — does NOT fold ``x`` in. One-sided: only
        UPWARD deviations count; a loss/grad-norm falling faster than its
        history is convergence, not instability."""
        if not math.isfinite(x):
            return True, float("inf")
        if len(self._ring) < self.warmup:
            return False, 0.0
        ring = np.asarray(self._ring, np.float64)
        med = float(np.median(ring))
        mad = float(np.median(np.abs(ring - med)))
        denom = _MAD_SCALE * mad + _REL_FLOOR * abs(med) + 1e-9
        z = (x - med) / denom
        return z > self.zmax, z

    def fold(self, x: float) -> None:
        if math.isfinite(x):
            self._ring.append(x)

    def judge(self, x: float) -> Tuple[bool, float]:
        """(anomalous, robust_z). Folds ``x`` in iff it is not anomalous.
        The sentinel itself uses score()/fold() separately so that NO
        signal of an anomalous step — not even the ones below threshold —
        contaminates the baselines."""
        bad, z = self.score(x)
        if not bad:
            self.fold(x)
        return bad, z


class StabilitySentinel:
    """Watches per-step training signals and escalates anomalies through the
    skip → rollback → halt ladder; :meth:`observe` is the one per-step entry
    point. Creates no threads; the pending queue, the verdict stash and the
    history are lock-guarded, so two training threads may share one."""

    def __init__(
        self,
        window: Optional[int] = None,
        warmup: Optional[int] = None,
        zmax: Optional[float] = None,
        max_skips: Optional[int] = None,
        max_rollbacks: Optional[int] = None,
        cooldown: Optional[int] = None,
        anchor=None,
        state: Optional[dict] = None,
        state_fn: Optional[Callable[[], dict]] = None,
        post_restore: Optional[Callable[[dict], None]] = None,
        quarantine: Optional[QuarantineLog] = None,
        name: str = "sentinel",
    ):
        from ..framework import flags as _flags

        def _f(v, flag, cast):
            return cast(_flags.flag(flag)) if v is None else cast(v)

        self.name = name
        self.window = _f(window, "FLAGS_stability_window", int)
        self.warmup = _f(warmup, "FLAGS_stability_warmup", int)
        self.zmax = _f(zmax, "FLAGS_stability_zmax", float)
        self.max_skips = _f(max_skips, "FLAGS_stability_max_skips", int)
        self.max_rollbacks = _f(max_rollbacks,
                                "FLAGS_stability_max_rollbacks", int)
        self.cooldown = _f(cooldown, "FLAGS_stability_cooldown", int)
        self.anchor = anchor
        self._state = state
        self._state_fn = state_fn
        self._post_restore = post_restore
        qdir = _flags.flag("FLAGS_stability_quarantine_dir", "") or ""
        qpath = None
        if quarantine is None and qdir:
            os.makedirs(qdir, exist_ok=True)
            qpath = os.path.join(qdir,
                                 f"quarantine_{os.getpid()}_{name}.jsonl")
        self.quarantine = (quarantine if quarantine is not None
                           else QuarantineLog(qpath))
        self._lock = threading.Lock()
        # committed observations awaiting their judgment, oldest first
        self._pending: List[dict] = []  # guarded_by: _lock
        self._stash: List[StabilityVerdict] = []  # guarded_by: _lock
        self._history: "collections.deque" = collections.deque(maxlen=128)  # guarded_by: _lock
        # stats per statistical signal; `nonfinite` is judged absolutely
        self._stats = {k: _SignalStats(self.window, self.warmup, self.zmax)
                       for k in ("loss", "grad_norm", "upd_ratio")}
        self._loss_ema: Optional[float] = None
        # incident ladder state (training thread only)
        self._skips_used = 0
        self._rollbacks_used = 0
        self._clean_streak = 0
        # anchor-pin protocol
        self._anchor_steps: List[int] = []
        self._pinned: Optional[int] = None
        self._last_clean_step = -1
        self._next_note: Optional[tuple] = None  # (pos, indices, indices_fn)
        self._closed = False
        _register(self)

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """Unregister the flight provider and release a pinned anchor.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.anchor is not None and self._pinned is not None:
            try:
                self.anchor.release(self._pinned)
            except Exception:
                pass
        _unregister(self)

    @classmethod
    def from_flags(cls, anchor=None, **kw) -> "StabilitySentinel":
        """Built from the ``FLAGS_stability_*`` registry; an anchor
        directory in ``FLAGS_stability_ckpt_dir`` gives the rollback
        checkpoint (an ``AutoCheckpoint`` saving every
        ``FLAGS_stability_anchor_interval`` steps, keeping 2)."""
        from ..framework import flags as _flags

        if anchor is None:
            d = _flags.flag("FLAGS_stability_ckpt_dir", "") or ""
            if d:
                from ..distributed.checkpoint import AutoCheckpoint

                anchor = AutoCheckpoint(
                    d, interval_steps=int(_flags.flag(
                        "FLAGS_stability_anchor_interval")),
                    keep_last=2)
        return cls(anchor=anchor, **kw)

    @classmethod
    def for_engine(cls, engine, anchor, extras: Optional[dict] = None, **kw
                   ) -> "StabilitySentinel":
        """A sentinel wired to a ``HybridParallelEngine``: its anchors hold
        the engine's parameters and optimizer state (``engine_state_dict``,
        which syncs the sharded update's moments back first), a rollback
        restores them through ``engine_apply_state`` (the sharded update
        then repacks from the restored moments), and the engine feeds it
        each step (``attach_sentinel``). ``extras`` (a loader, an RNG
        state, ...) join the checkpoint tree."""
        from ..distributed.checkpoint import (engine_apply_state,
                                              engine_state_dict)

        extras = dict(extras or {})

        def state_fn():
            st = engine_state_dict(engine)
            st.update(extras)
            return st

        s = cls(anchor=anchor, state_fn=state_fn,
                post_restore=lambda st: engine_apply_state(engine, st), **kw)
        engine.attach_sentinel(s)
        return s

    # -- per-step entry points --------------------------------------------
    def observe(self, step: int, loss=None, grads: Sequence = (),
                params: Sequence = (), lr: Optional[float] = None, pos=None,
                sample_indices=None,
                indices_fn: Optional[Callable[[], Optional[list]]] = None,
                committed: bool = False, stash: bool = False
                ) -> Optional[StabilityVerdict]:
        """Feed one step's signals, after the backward and before the
        update. Returns a verdict for this step (a ``skip`` means: do not
        apply the update), a late one for an older committed step, or None.

        ``committed=True`` marks a step whose update was already applied:
        it is judged at the next ``observe``/``poll`` and can only roll
        back (its gradients stay referenced until then, for the exact
        non-finite count). ``stash=True`` also parks the verdict for
        :meth:`take_verdict`."""
        from .. import profiler as _prof

        _prof.counter_inc("stability_observed")
        # 1) judge the committed steps still pending
        verdict = self._drain(before_step=step)
        # 2) this step's signal pack
        grads = [g for g in grads if g is not None]
        params = [p for p in params if p is not None]
        if loss is not None and not isinstance(loss, torch.Tensor):
            loss = torch.as_tensor(np.asarray(loss, np.float32))
        if loss is not None or grads:
            if pos is None and self._next_note is not None:
                pos, noted_indices, noted_fn = self._next_note
                sample_indices = sample_indices or noted_indices
                indices_fn = indices_fn or noted_fn
            self._next_note = None
            has_lr = lr is not None and params and grads
            entry = {
                "step": int(step),
                "pos": tuple(pos) if pos is not None else None,
                "indices": (list(sample_indices)
                            if sample_indices is not None else None),
                "indices_fn": indices_fn,
                "handle": _pack(loss, lr if has_lr else None, grads,
                                params if has_lr else []),
                "loss": loss, "grads": grads, "committed": bool(committed),
            }
            if committed:
                with self._lock:
                    self._pending.append(entry)
            else:
                v = self._judge(entry, self._read(entry), late=False)
                verdict = verdict or v
        if verdict is not None and stash:
            with self._lock:
                self._stash.append(verdict)
        return verdict

    def take_verdict(self) -> Optional[StabilityVerdict]:
        """Pop a verdict staged by a ``stash=True`` observe."""
        with self._lock:
            return self._stash.pop(0) if self._stash else None

    def poll(self) -> Optional[StabilityVerdict]:
        """Judge everything still pending (end of epoch, loop exit)."""
        return self._drain(before_step=None)

    def is_quarantined(self, pos=None, step: Optional[int] = None) -> bool:
        return self.quarantine.is_quarantined(pos=pos, step=step)

    def note_batch(self, pos, sample_indices=None,
                   indices_fn: Optional[Callable[[], Optional[list]]] = None
                   ) -> None:
        """Associate the next observation with a loader position and sample
        indices, for a loop that does not pass them to ``observe``; the
        chaos spikes then target the batch ordinal (stable across a replay)
        instead of the step count."""
        self._next_note = (tuple(pos) if pos is not None else None,
                           sample_indices, indices_fn)

    def note_anchor(self, step: int) -> None:
        """Record that an anchor checkpoint committed at ``step``."""
        self._anchor_steps.append(int(step))
        del self._anchor_steps[:-32]
        self._advance_pin()

    def maybe_anchor(self, step: int, state: Optional[dict] = None) -> bool:
        """Periodic anchor save through the anchor's ``maybe_save``; True
        when a checkpoint committed at ``step``."""
        if self.anchor is None:
            return False
        st = self._state_tree(state)
        if st is None:
            return False
        if self.anchor.maybe_save(step, st):
            self.note_anchor(step)
            return True
        return False

    # -- chaos spikes ------------------------------------------------------
    def maybe_spike(self, arrays, step=None, rank=None):
        """Consult the ``loss.spike``/``grad.spike`` injection points and,
        when one fires, scale every floating tensor of ``arrays`` (a batch,
        or the step's gradients) on its device."""
        from . import inject as _inject

        if not _inject.armed():
            return arrays
        note = self._next_note
        if note is not None and note[0] is not None:
            # spikes target batches: the noted loader position is stable
            # across a replay, the step count is not
            step = note[0][1]
        scale = None
        for point in ("loss.spike", "grad.spike"):
            s = _inject.spike(point, step=step, rank=rank)
            if s is not None:
                scale = s if scale is None else scale * s
        if scale is None:
            return arrays
        out = [a * scale if isinstance(a, torch.Tensor)
               and a.is_floating_point() else a for a in arrays]
        return tuple(out) if isinstance(arrays, tuple) else out

    # -- rollback / halt ---------------------------------------------------
    def rollback(self, verdict: StabilityVerdict,
                 state: Optional[dict] = None) -> int:
        """Restore the newest anchor strictly older than the poisoned step
        into ``state`` (``anchor.resume(state, max_step=step - 1)``) and
        return its step, which the caller replays from. Halts (raises
        :class:`StabilityError`) when there is no anchor or no eligible
        step."""
        from .. import profiler as _prof
        from ..profiler import flight as _flight
        from ..profiler import spans as _spans

        st = self._state_tree(state)
        if self.anchor is None or st is None:
            self.halt(verdict,
                      reason="rollback requested but no anchor configured")
        with _spans.span("stability_rollback", step=verdict.step,
                         signal=verdict.signal) as sp:
            # the poisoned timeline's pending judgments are stale
            with self._lock:
                del self._pending[:]
                del self._stash[:]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()  # no restore under queued work
            anchor_step = self.anchor.resume(st, max_step=verdict.step - 1)
            if anchor_step < 0:
                self.halt(verdict, reason=("no verified anchor older than "
                                           f"step {verdict.step}"))
            # anchors saved inside the detection window may carry the
            # poisoned update, and a quarantined step is never saved again
            for a in list(self._anchor_steps):
                if anchor_step < a <= verdict.step:
                    try:
                        self.anchor.invalidate(a)
                    except Exception:
                        pass
                    self._anchor_steps.remove(a)
            # keep the anchor being replayed from until a newer clean one
            self._pin(anchor_step)
            self._last_clean_step = min(self._last_clean_step, anchor_step)
            if self._post_restore is not None:
                self._post_restore(st)
            sp.set(anchor_step=anchor_step)
        _prof.counter_inc("stability_rollbacks")
        _flight.dump("stability_rollback", extra={
            "verdict": verdict.to_dict(), "anchor_step": anchor_step})
        return anchor_step

    def adopt(self, verdict: StabilityVerdict) -> StabilityVerdict:
        """Fold a verdict another rank reached into this sentinel: the same
        quarantine entry and the same ladder rung."""
        from .. import profiler as _prof

        _prof.counter_inc("stability_coordinated_trips")
        self._clean_streak = 0
        if verdict.action == "rollback":
            self._rollbacks_used += 1
        elif verdict.action == "skip":
            self._skips_used += 1
        if verdict.action in ("skip", "rollback"):
            self.quarantine.add(verdict.step, pos=verdict.pos,
                                signals=verdict.signals,
                                action=verdict.action)
        with self._lock:
            self._history.append({
                "step": verdict.step, **verdict.signals,
                "anomaly": verdict.signal,
                "adopted_from_rank": verdict.origin_rank,
            })
        return verdict

    def halt(self, verdict: StabilityVerdict, reason: str = "") -> None:
        """Terminal rung: a flight dump naming the tripping signal, then a
        :class:`StabilityError`."""
        from .. import profiler as _prof
        from ..profiler import flight as _flight

        _prof.counter_inc("stability_halts")
        with self._lock:
            history = list(self._history)
        _flight.dump("stability_halt", extra={
            "verdict": verdict.to_dict(), "signal": verdict.signal,
            "reason": reason or "policy ladder exhausted",
            "history": history[-32:]})
        raise StabilityError(
            f"training stability sentinel halt: signal {verdict.signal!r} "
            f"value {verdict.value:.6g} (robust z={verdict.zscore:.1f}) at "
            f"step {verdict.step}" + (f" — {reason}" if reason else ""),
            verdict=verdict, history=history)

    # -- internals ---------------------------------------------------------
    def _state_tree(self, state: Optional[dict]) -> Optional[dict]:
        if state is not None:
            return state
        if self._state_fn is not None:
            return self._state_fn()
        return self._state

    def _tap(self) -> None:
        """Stage the four floats of the committed steps whose signal pack
        is computed (not pending in a lazy graph, its card work done)."""
        from ..core import lazy

        with self._lock:
            pending = [e for e in self._pending if "values" not in e]
        for e in pending:
            h = e["handle"]
            if lazy.is_lazy(h):
                if h._concrete is None:
                    return  # its flush has not run yet
                h = h._concrete
            if h.device.type == "cuda" and not torch.cuda.current_stream(
                    h.device).query():
                return
            with lazy.suspended():
                v = np.asarray(h.tolist(), np.float64)  # lint: ok(host-sync) — the work is done
            if v[2] == 0.0 and math.isfinite(v[0]):
                e["values"] = v  # a non-finite step is counted at _read

    def _read(self, entry) -> np.ndarray:
        """The step's one readback (four floats); a non-finite gradient
        norm adds the exact non-finite count."""
        from .. import profiler as _prof

        if "values" in entry:
            _prof.counter_inc("stability_readbacks")
            return entry["values"]
        v = np.asarray(entry["handle"].tolist(), np.float64)
        _prof.counter_inc("stability_readbacks")
        if v[2] > 0.0 or not math.isfinite(v[0]):
            v[2] = _nonfinite_share(entry["loss"], entry["grads"])
        return v

    def _drain(self, before_step: Optional[int]
               ) -> Optional[StabilityVerdict]:
        verdict = None
        while True:
            with self._lock:
                if not self._pending:
                    break
                nxt = self._pending[0]
                if before_step is not None and nxt["step"] >= before_step:
                    break
                self._pending.pop(0)
            v = self._judge(nxt, self._read(nxt), late=True)
            verdict = verdict or v
        if verdict is None:
            with self._lock:
                if self._stash:
                    verdict = self._stash.pop(0)
        return verdict

    def _judge(self, entry, values: np.ndarray, late: bool
               ) -> Optional[StabilityVerdict]:
        """Update statistics with one step's signal vector and escalate on
        anomaly. ``late`` (committed) entries can only roll back."""
        from .. import profiler as _prof

        sig = {k: float(values[i]) for i, k in enumerate(SIGNALS)}
        worst: Optional[Tuple[str, float, float]] = None
        if sig["nonfinite"] > 0.0 or not all(math.isfinite(v) for v in sig.values()):
            worst = ("nonfinite", sig["nonfinite"], float("inf"))
        else:
            # score first, fold only if the WHOLE step is clean: on an
            # anomalous step even the below-threshold signals are suspect
            # (a spiked batch inflates all of them) and must not walk the
            # baselines upward
            scores = {
                k: self._stats[k].score(sig[k])
                for k in ("grad_norm", "loss", "upd_ratio")
            }
            for k, (bad, z) in scores.items():
                if bad and (worst is None or z > worst[2]):
                    worst = (k, sig[k], z)
            if worst is None:
                for k in scores:
                    self._stats[k].fold(sig[k])
        if math.isfinite(sig["loss"]):
            self._loss_ema = (
                sig["loss"] if self._loss_ema is None
                else 0.98 * self._loss_ema + 0.02 * sig["loss"]
            )
        rec = {"step": entry["step"], **sig, "anomaly": worst[0] if worst else None}
        with self._lock:
            self._history.append(rec)
        _last_signals.update(sig)
        _last_signals["loss_ema"] = self._loss_ema if self._loss_ema is not None else sig["loss"]
        if worst is None:
            self._clean_streak += 1
            if self._clean_streak >= self.cooldown:
                self._skips_used = 0
                self._rollbacks_used = 0
            self._last_clean_step = max(self._last_clean_step, entry["step"])
            self._advance_pin()
            return None
        # -- anomaly: escalate through the ladder --------------------------
        _prof.counter_inc("stability_trips")
        self._clean_streak = 0
        late = late or entry["committed"]
        if not late and self._skips_used < self.max_skips:
            action = "skip"
            self._skips_used += 1
        elif self.anchor is not None and self._rollbacks_used < self.max_rollbacks:
            action = "rollback"
            self._rollbacks_used += 1
        else:
            action = "halt"
        verdict = StabilityVerdict(
            action, entry["step"], entry["pos"], worst[0], worst[1], worst[2],
            late, sig,
        )
        if action in ("skip", "rollback"):
            indices = entry["indices"]
            if indices is None and entry["indices_fn"] is not None:
                try:
                    indices = entry["indices_fn"]()
                except Exception:
                    indices = None
            self.quarantine.add(
                entry["step"], pos=entry["pos"], sample_indices=indices,
                signals=sig, action=action,
            )
            if action == "skip":
                _prof.counter_inc("stability_skips")
        from ..profiler import spans as _spans

        with _spans.span("stability_trip", step=entry["step"], signal=worst[0],
                         action=action, late=late):
            pass
        return verdict

    # -- anchor pinning ----------------------------------------------------
    def _pin(self, step: int) -> None:
        if self.anchor is None or step == self._pinned:
            return
        try:
            self.anchor.protect(step)
            if self._pinned is not None:
                self.anchor.release(self._pinned)
        except Exception:
            pass
        self._pinned = step

    def _advance_pin(self) -> None:
        """Pin the newest anchor whose step is JUDGED CLEAN — an anchor saved
        in the detection window may hold the poisoned update, so the pin
        trails the judgment horizon by design."""
        if self.anchor is None:
            return
        safe = [a for a in self._anchor_steps if a <= self._last_clean_step]
        if safe:
            self._pin(max(safe))

    def _context(self) -> dict:
        with self._lock:
            hist = list(self._history)[-16:]
        return {
            "name": self.name,
            "recent_signals": hist,
            "incident": {
                "skips_used": self._skips_used,
                "rollbacks_used": self._rollbacks_used,
                "clean_streak": self._clean_streak,
            },
            "quarantined": len(self.quarantine),
            "pinned_anchor": self._pinned,
            "pending": len(self._pending),
        }
