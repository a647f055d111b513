"""On-disk kernel tuning DB (port of ``paddle_tpu/ops/kernels/db.py``):
verified autotune winners that survive restarts.

Layout: one JSON file per entry under ``~/.cache/paddle_tpu_torch/tune/``
(override: ``FLAGS_kernel_tune_dir``), named ``<kernel>-<sha1[:16] of the
canonical key>.json``. An entry is keyed on the kernel, its shape bucket,
the device (``torch.cuda.get_device_name`` or ``"cpu"``) and its compute
capability, ``torch.__version__`` and ``torch.version.cuda``, and the digest
of the kernel's ``csrc`` source (``_build.source_digest``, the one in the
built library's name). So an entry tuned on one card, toolkit or build of a
kernel is never used on another: the port's counterpart of the reference's
platform and jax-version key.

Durability: every write goes through ``framework.io.atomic_open`` (tmp,
fsync, ``os.replace``), and every read re-derives the sha1 over the entry's
body and re-checks every key field. A torn, truncated, hand-edited or
stale-keyed entry is a *structured reject*: counted
(``kernel_tune_db_rejects``), the file removed, and the lookup reported as a
miss, so ``search`` re-tunes and ``ondemand`` falls back to the pinned
defaults. A wrong config is never returned; deleting the DB directory is
always safe.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import torch

from ...framework import flags
from ...framework.io import atomic_open
from ...profiler import counter_inc
from . import _build, registry

__all__ = ["tune_dir", "entry_path", "store", "lookup", "delete"]

_SCHEMA = 1


def tune_dir() -> str:
    d = flags.flag("FLAGS_kernel_tune_dir", "") or ""
    return d or os.path.join(os.path.expanduser("~"), ".cache",
                             "paddle_tpu_torch", "tune")


def _device() -> dict:
    if not torch.cuda.is_available():
        return {"device": "cpu", "capability": None}
    idx = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(idx)
    return {"device": torch.cuda.get_device_name(idx),
            "capability": f"{major}.{minor}"}


def _source(name: str) -> Optional[str]:
    spec = registry._REGISTRY.get(name)
    return None if spec is None or spec.source is None \
        else _build.source_digest(spec.source)


def _canon_key(key: tuple):
    # JSON round-trip canonicalization: tuples become lists, so a stored key
    # compares equal to a live one after one encode/decode
    return json.loads(json.dumps(list(key)))


def _body(name: str, key: tuple) -> dict:
    return {"schema": _SCHEMA, "kernel": name, "key": _canon_key(key),
            **_device(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "source": _source(name)}


def _digest(body: dict) -> str:
    return hashlib.sha1(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def entry_path(name: str, key: tuple) -> str:
    tag = _digest(_body(name, key))[:16]
    safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in name)
    return os.path.join(tune_dir(), f"{safe}-{tag}.json")


def store(name: str, key: tuple, config: dict, best_ms: Optional[float],
          default_ms: Optional[float]) -> str:
    body = _body(name, key)
    body.update(config=dict(config), best_ms=best_ms, default_ms=default_ms)
    payload = dict(body, checksum=_digest(body))
    path = entry_path(name, key)
    os.makedirs(tune_dir(), exist_ok=True)
    with atomic_open(path, "w") as f:
        json.dump(payload, f, sort_keys=True, indent=1)
    return path


def lookup(name: str, key: tuple) -> Optional[dict]:
    """The winner config for ``key``, or None on a miss OR a rejected
    (torn/corrupt/mismatched) entry: a wrong config is never returned."""
    path = entry_path(name, key)
    try:
        with open(path) as f:
            raw = f.read()
    except OSError:
        return None  # plain miss
    try:
        payload = json.loads(raw)
        checksum = payload.pop("checksum")
        if checksum != _digest(payload):
            raise ValueError("checksum mismatch")
        for field, want in _body(name, key).items():
            if payload.get(field) != want:
                raise ValueError(f"key field {field!r} mismatch")
        config = payload["config"]
        if not isinstance(config, dict):
            raise ValueError("config is not a dict")
        return config
    except (ValueError, KeyError, TypeError, AttributeError):
        # torn/truncated/hand-edited/stale entry: structured reject (count,
        # drop the bad file, report a miss)
        counter_inc("kernel_tune_db_rejects")
        delete(name, key)
        return None


def delete(name: str, key: tuple) -> None:
    try:
        os.remove(entry_path(name, key))
    except OSError:
        pass
