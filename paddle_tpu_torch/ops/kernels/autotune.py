"""Measured-timing autotuner for registered kernels (port of
``paddle_tpu/ops/kernels/autotune.py``).

``resolve`` (the only entry the registry calls) checks the in-process memo,
then the on-disk tuning DB, then, in ``search`` mode, runs a real search:

- candidates are the cartesian product of the kernel's declared config
  space, filtered by the spec's validity predicate and ORDERED by
  ``cost_model.CostModel.kernel_estimate``, so plausible configs are visited
  first under the per-kernel time budget (``FLAGS_kernel_tune_budget_s``, a
  monotonic-clock deadline). The budget starts once the runner has built
  its inputs: at a serving pool's size that takes seconds of host time
  (the reference starts it before), and it would leave no time to measure;
- each candidate is timed as the median of ``FLAGS_kernel_tune_samples``
  host-clock samples, each one call followed by ``torch.cuda.synchronize()``
  when its output is on the card; the FIRST call is excluded, since it may
  build the kernel's library. The default, measured first, runs its steps
  for ``_WARM_S`` before its samples: the runner's set-up leaves the card
  idle for seconds, and a card coming out of idle read the default 8–10 µs
  slow on a ~0.1 ms paged launch, so the same launch measured later
  "won";
- a candidate can only win if :func:`verify` accepts its output against the
  DEFAULT config's output (dtype-scaled allclose and the same finite mask).
  The default is always measured first, so the result is a verified faster
  winner or the defaults themselves; a search never swaps a kernel for its
  plain version.

Winners persist via ``db.store`` (atomic write); a later process resolves
them from disk with no search (``kernel_tune_hits``).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ...cost_model import CostModel, device_sync, leaves
from ...framework import flags
from ...profiler import counter_inc
from ...profiler.spans import span
from . import db

__all__ = ["resolve", "search", "candidates", "verify", "clear_cache"]

# in-process memo of resolved configs: (kernel, key) -> config. One disk
# probe (and at most one search) per shape bucket per process.
_MEM: Dict[tuple, dict] = {}
_WARM_S = 0.2  # seconds of the default's steps before its samples


def clear_cache():
    _MEM.clear()


def _config_in_space(spec, config: dict) -> bool:
    """A DB entry is only trusted if every field names a declared axis with
    a declared choice (defaults count): a schema-drifted or hand-edited
    config is rejected, never launched."""
    for k, v in config.items():
        if k in spec.defaults and v == spec.defaults[k]:
            continue
        if k not in spec.space or v not in spec.space[k]:
            return False
    return set(config) == set(spec.defaults)


def resolve(spec, key: tuple, mode: str) -> dict:
    memo_key = (spec.name, key)
    cached = _MEM.get(memo_key)
    if cached is not None:
        return dict(cached)
    config = db.lookup(spec.name, key)
    if config is not None and not _config_in_space(spec, config):
        counter_inc("kernel_tune_db_rejects")
        db.delete(spec.name, key)
        config = None
    if config is not None:
        counter_inc("kernel_tune_hits")
        _MEM[memo_key] = dict(config)
        return dict(config)
    counter_inc("kernel_tune_misses")
    if mode == "search" and spec.runner is not None:
        config, best_ms, default_ms, searched = search(spec, key)
        if searched:
            db.store(spec.name, key, config, best_ms, default_ms)
        _MEM[memo_key] = dict(config)
        return dict(config)
    # ondemand miss (or a kernel without a runner): the pinned defaults
    _MEM[memo_key] = dict(spec.defaults)
    return dict(spec.defaults)


def candidates(spec, key: tuple):
    """Non-default configs in cost-model order (cheapest estimate first)."""
    names = sorted(spec.space)
    cands = []
    for combo in itertools.product(*(spec.space[n] for n in names)):
        cfg = dict(spec.defaults)
        cfg.update(zip(names, combo))
        if cfg == dict(spec.defaults):
            continue
        if spec.valid is not None and not spec.valid(cfg, key):
            continue
        if cfg not in cands:
            cands.append(cfg)
    cm = CostModel()
    cands.sort(key=lambda c: cm.kernel_estimate(spec.name, key, c))
    return cands


def _arrays(out):
    """(dtype name, item size, numpy array) of each tensor of ``out`` (or of
    ``out`` itself when it holds no tensor)."""
    ts = leaves(out)
    if not ts:
        a = np.asarray(out)
        return [(str(a.dtype), a.dtype.itemsize, a)]
    return [(str(t.dtype), t.dtype.itemsize,
             # numpy has no bf16; every 16-bit float is exact in f32
             t.detach().float().cpu().numpy() if t.dtype.is_floating_point
             else t.detach().cpu().numpy()) for t in ts]


def verify(out, ref) -> bool:
    """Accept a candidate's output only if it matches the default config's
    output: the same tensors (a tensor, or tuples and lists of them) with
    the same shapes and dtypes, the same finite mask, and values within a
    dtype-scaled tolerance (another block or split reorders float sums by a
    few ulps; anything beyond the tolerance is a broken config)."""
    la, lb = _arrays(out), _arrays(ref)
    if len(la) != len(lb):
        return False
    for (da, size, a), (db_, _, b) in zip(la, lb):
        if a.shape != b.shape or da != db_:
            return False
        af, bf = a.astype(np.float64), b.astype(np.float64)
        if not np.array_equal(np.isfinite(af), np.isfinite(bf)):
            return False
        tol = 2e-2 if size <= 2 else 1e-5
        fin = np.isfinite(bf)
        if not np.allclose(af[fin], bf[fin], rtol=tol, atol=tol):
            return False
    return True


def _measure(make: Callable[[dict], Callable[[], Any]], config: dict,
             samples: int, warm_s: float = 0.0
             ) -> Tuple[Optional[Any], Optional[float]]:
    """(output, median ms over ``samples`` runs); the first call is
    excluded (it may build the kernel's library), and so are the steps of
    the first ``warm_s`` seconds after it."""
    step = make(dict(config))
    out = step()
    device_sync(out)
    warm_end = time.monotonic() + warm_s
    while time.monotonic() < warm_end:
        device_sync(step())
    times = []
    for _ in range(max(int(samples), 1)):
        t0 = time.monotonic()
        o = step()
        device_sync(o)
        times.append(time.monotonic() - t0)
    times.sort()
    return out, times[len(times) // 2] * 1e3


def search(spec, key: tuple):
    """Returns ``(config, best_ms, default_ms, searched)``. ``searched`` is
    False when even the default config failed to run (nothing to persist)."""
    budget_s = float(flags.flag("FLAGS_kernel_tune_budget_s", 20.0))
    samples = int(flags.flag("FLAGS_kernel_tune_samples", 5))
    make = spec.runner(key)
    deadline = time.monotonic() + budget_s
    counter_inc("kernel_tune_searches")
    cm = CostModel()
    with span("kernel_tune", kernel=spec.name) as sp:
        try:
            ref_out, default_ms = _measure(make, spec.defaults, samples,
                                           _WARM_S)
        except Exception:
            # a broken runner degrades to the pinned defaults; it must never
            # take the call site down
            counter_inc("kernel_tune_candidate_errors")
            sp.set(result="default_failed")
            return dict(spec.defaults), None, None, False
        best_cfg, best_ms = dict(spec.defaults), default_ms
        # cost-model drift: (estimate, measured ms) of each config that ran;
        # the model's job here is ORDERING the visits, so its drift sample
        # is the discordant-pair fraction of the two rankings
        measured = [(cm.kernel_estimate(spec.name, key, dict(spec.defaults)),
                     default_ms)]
        tried = 0
        for cfg in candidates(spec, key):
            if time.monotonic() >= deadline:
                counter_inc("kernel_tune_budget_stops")
                break
            tried += 1
            counter_inc("kernel_tune_candidates")
            try:
                out, ms = _measure(make, cfg, samples)
            except Exception:
                # a config that fails to run is disqualified
                counter_inc("kernel_tune_candidate_errors")
                continue
            measured.append((cm.kernel_estimate(spec.name, key, cfg), ms))
            if not verify(out, ref_out):
                counter_inc("kernel_tune_verify_fails")
                continue
            if ms < best_ms:
                best_cfg, best_ms = dict(cfg), ms
        sp.set(candidates=tried, default_ms=default_ms, best_ms=best_ms,
               tuned=best_cfg != dict(spec.defaults))
        if len(measured) >= 2:
            disc = tot = 0
            for i in range(len(measured)):
                for j in range(i + 1, len(measured)):
                    (ei, mi), (ej, mj) = measured[i], measured[j]
                    if ei == ej or mi == mj:
                        continue
                    tot += 1
                    if (ei < ej) != (mi < mj):
                        disc += 1
            if tot:
                frac = disc / tot
                sp.set(cost_drift=round(frac, 6))
                try:
                    from ...serving import observe as _observe

                    _observe.drift_value(
                        "kernel_estimate", frac, pairs=tot,
                        measured=len(measured))
                except Exception:
                    # drift accounting must never take a tuning search down
                    pass
    return best_cfg, best_ms, default_ms, True
