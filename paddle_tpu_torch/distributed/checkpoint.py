"""Sharded, asynchronous checkpointing with crash-safe resume (port of
``paddle_tpu/distributed/checkpoint.py``).

The reference writes with orbax. The port writes its own files: a
checkpoint ``path`` is a directory holding one raw file a leaf
(``leaf_<i>.bin``, the leaf's bytes in C order) and ``index.json``, which
names each leaf's flat key, file, shape and dtype. Every process writes
only what it holds (its rank's shards), so nothing is gathered. The
directory is written under a temporary name and renamed into place once
every file is fsync'd.

Crash safety is the reference's protocol, unchanged: every checkpoint
carries a MANIFEST (``<path>.manifest.json``, written by tmp + ``fsync`` +
``os.replace`` only after the data is durable) with the flat tree, each
leaf's shape, dtype and CRC32 and a commit marker. The manifest is the
source of truth for resume: ``AutoCheckpoint.resume`` walks back to the
newest checkpoint whose manifest verifies (including the ``.old`` backup
parked aside by an in-place re-save) instead of trusting ``latest.json``,
and GC never deletes the last verified-good copy nor a ``protect``ed
anchor. A save that dies at any point leaves either the previous manifest
and directory intact or an uncommitted directory that resume skips.

The manifest is the reference's, key for key: a leaf's ``crc32`` is
``zlib.crc32`` of its host bytes (a bf16 leaf's two bytes an element, read
through an integer view, since numpy has no bf16) and its ``dtype`` is the
reference's dtype name (``"bfloat16"``, ``"float32"``, ``"int64"``).

An asynchronous save copies each leaf into pinned host memory on a side
stream and records an event (the caller's stream waits on it, so the next
step cannot overwrite a leaf before it is copied); a background thread then
computes the CRCs and writes the files, and ``wait_until_finished`` commits
the manifest. A restored leaf is read into a freshly allocated tensor and
copied into the live one, so nothing restored aliases a staging buffer a
later save reuses (the lesson of the reference's ``_own_leaves``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework import flags as _flags

MANIFEST_SUFFIX = ".manifest.json"
_MANIFEST_FORMAT = 1
_INDEX = "index.json"


class CheckpointError(RuntimeError):
    """A checkpoint failed verification (missing manifest, checksum
    mismatch, or tree mismatch under strict loading)."""


def _prof():
    from .. import profiler

    return profiler


def _has_state_dict(v) -> bool:
    """Model- and optimizer-like tree nodes: anything with ``state_dict()``
    (a ``Layer``, an ``Optimizer``, an ``LRScheduler``). They take part as
    nested dicts and restore through ``set_state_dict``."""
    return (not isinstance(v, (torch.Tensor, dict))
            and callable(getattr(v, "state_dict", None)))


def _to_arrays(state: Dict[str, Any]):
    """The state tree with every leaf a tensor (scalars become 0-d tensors
    of numpy's dtype for them, as the reference's ``np.asarray``)."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
        elif isinstance(v, dict):
            out[k] = _to_arrays(v)
        elif _has_state_dict(v):
            out[k] = _to_arrays(dict(v.state_dict()))
        else:
            a = np.asarray(v)
            if a.dtype == object:
                raise TypeError(f"checkpoint leaf {k!r}: {type(v).__name__} "
                                "has no array form")
            out[k] = torch.from_numpy(a.copy())
    return out


def _apply_arrays(state: Dict[str, Any], arrays: Dict[str, Any]):
    for k, v in state.items():
        a = arrays.get(k)
        if a is None:
            continue
        if isinstance(v, torch.Tensor):
            with torch.no_grad():
                v.copy_(a)
        elif isinstance(v, dict) and isinstance(a, dict):
            _apply_arrays(v, a)
        elif _has_state_dict(v) and isinstance(a, dict):
            if callable(getattr(v, "set_state_dict", None)):
                v.set_state_dict(a)
            else:
                _apply_arrays(dict(v.state_dict()), a)


def _flat_keys(tree: Dict[str, Any], prefix: str = ""):
    """Yield (flat_key, leaf) for every non-dict leaf, '/'-joined."""
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat_keys(v, key)
        else:
            yield key, v


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _tree_keys(state: Dict[str, Any]):
    """Flat key sets of a STATE tree for strict comparison: exact keys for
    tensor and plain leaves, root prefixes for state_dict-bearing objects
    (their inner key set is owned by ``set_state_dict``: a fresh optimizer
    has no accumulators until its first step, yet takes them on restore)."""
    exact, objroots = set(), set()

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            elif _has_state_dict(v):
                objroots.add(key)
            else:
                exact.add(key)

    walk(state, "")
    return exact, objroots


def _dtype_name(dtype) -> str:
    """The reference's (numpy/JAX) name of a torch dtype: ``"bfloat16"``,
    ``"float32"``, ``"int64"``, ``"bool"``."""
    return str(dtype).replace("torch.", "")


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes in C order, as a uint8 array (no copy for a
    contiguous tensor; bf16 goes through the byte view numpy lacks)."""
    t = t.contiguous().reshape(-1)
    return t.view(torch.uint8).numpy()


def _leaf_crc(b: np.ndarray) -> int:
    return zlib.crc32(memoryview(b)) & 0xFFFFFFFF


# -- manifest ----------------------------------------------------------------
def _manifest_path(path: str) -> str:
    return path + MANIFEST_SUFFIX


def _build_manifest(entries: Dict[str, dict], step: Optional[int] = None
                    ) -> dict:
    man = {"format": _MANIFEST_FORMAT, "ts": time.time(), "committed": True,
           "tree": entries}
    if step is not None:
        man["step"] = int(step)
    return man


def _write_manifest(man: dict, ckpt_path: str) -> None:
    """Atomic commit marker: the manifest lands via tmp + os.replace only
    after the checkpoint data is durable, so its presence IS the commit."""
    mp = _manifest_path(ckpt_path)
    tmp = mp + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mp)


def read_manifest(ckpt_path: str) -> Optional[dict]:
    """The checkpoint's manifest, or None (legacy/uncommitted checkpoint)."""
    mp = _manifest_path(ckpt_path)
    try:
        with open(mp) as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    return man if isinstance(man, dict) else None


def _move_manifest(src_ckpt: str, dst_ckpt: str) -> None:
    mp = _manifest_path(src_ckpt)
    if os.path.exists(mp):
        os.replace(mp, _manifest_path(dst_ckpt))


def _remove_manifest(ckpt_path: str) -> None:
    try:
        os.remove(_manifest_path(ckpt_path))
    except OSError:
        pass


# -- the files ---------------------------------------------------------------
def _stage(arrays: Dict[str, Any]):
    """Each leaf's host copy, in flat-key order, and the event after the
    copies (None when nothing was on the card). Card leaves are copied into
    pinned memory on a side stream that first waits for the caller's
    stream; the caller's stream then waits on the event, so a later
    in-place update cannot race the copy. Host leaves are cloned."""
    flat = list(_flat_keys(arrays))
    cuda = [t for _, t in flat if t.is_cuda]
    if not cuda:
        return [(k, t.contiguous().clone()) for k, t in flat], None
    dev = cuda[0].device
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    out = []
    with torch.cuda.stream(side):
        for k, t in flat:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(side)
            else:
                h = t.contiguous().clone()
            out.append((k, h))
        event = torch.cuda.Event()
        event.record(side)
    cur.wait_event(event)
    return out, event


def _write_leaves(staged, event, path: str) -> Dict[str, dict]:
    """Write the staged leaves under ``path`` (a temporary directory renamed
    into place once every file is durable) and return the manifest's tree
    entries (shape, dtype, crc32)."""
    if event is not None:
        event.synchronize()
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    entries, index = {}, []
    try:
        for i, (key, h) in enumerate(staged):
            b = _host_bytes(h)
            fname = f"leaf_{i}.bin"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(memoryview(b))
                f.flush()
                os.fsync(f.fileno())
            shape = list(h.shape)
            dtype = _dtype_name(h.dtype)
            entries[key] = {"crc32": _leaf_crc(b), "shape": shape,
                            "dtype": dtype}
            index.append({"key": key, "file": fname, "shape": shape,
                          "dtype": dtype})
        with open(os.path.join(tmp, _INDEX), "w") as f:
            json.dump({"leaves": index}, f)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return entries


def _read_leaves(path: str, man: Optional[dict] = None
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf of the checkpoint at ``path`` as a fresh host tensor.
    With ``man`` each leaf's CRC32 is checked against it as the leaf is
    read (after the manifest's keys were found in the index): the first
    mismatch raises, naming its key, before the rest is read."""
    with open(os.path.join(path, _INDEX)) as f:
        index = json.load(f)["leaves"]
    tree = (man or {}).get("tree", {})
    if man is not None:
        missing = sorted(set(tree) - {e["key"] for e in index})
        if missing:
            raise CheckpointError(
                f"checkpoint {path}: manifest lists keys absent from the "
                f"restored tree: {missing}")
    out = {}
    for e in index:
        t = torch.empty(e["shape"], dtype=getattr(torch, e["dtype"]))
        b = _host_bytes(t)
        with open(os.path.join(path, e["file"]), "rb") as f:
            n = f.readinto(memoryview(b))
        if n != b.nbytes:
            raise CheckpointError(
                f"checkpoint {path}: leaf '{e['key']}' is truncated "
                f"({n} of {b.nbytes} bytes)")
        want = tree.get(e["key"], {}).get("crc32")
        if want is not None:
            got = _leaf_crc(b)
            if got != want:
                raise CheckpointError(
                    f"checkpoint {path}: checksum mismatch for '{e['key']}' "
                    f"(manifest crc32={want}, restored crc32={got})")
        out[e["key"]] = t
    return out


class _PendingSave:
    """Handle of an async save: ``wait_until_finished`` joins the
    background write and THEN commits the manifest, so a crash before the
    wait leaves the checkpoint uncommitted and resume walks past it."""

    def __init__(self, staged, event, path: str, step, manifest: bool,
                 old: Optional[str]):
        self._path = path
        self._old = old
        self._step = step
        self._manifest = manifest
        self._entries = None
        self._error: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(
            target=self._run, args=(staged, event), daemon=True,
            name="ckpt-async-write")
        self._thread.start()

    def _run(self, staged, event):
        try:
            self._entries = _write_leaves(staged, event, self._path)
        except BaseException as e:  # surfaced at wait_until_finished
            self._error = e

    def wait_until_finished(self):
        if self._done:
            return
        from ..profiler import spans as _spans

        self._done = True
        with _spans.span("ckpt_commit", path=self._path, async_save=True):
            self._thread.join()
            if self._error is not None:
                err, self._error = self._error, None
                if self._old and not os.path.exists(self._path):
                    os.rename(self._old, self._path)
                    _move_manifest(self._old, self._path)
                raise err
            if self._manifest:
                _write_manifest(_build_manifest(self._entries, self._step),
                                self._path)
        _prof().counter_inc("ckpt_saves")


def save_state_dict(
    state_dict: Dict[str, Any],
    path: str,
    async_save: bool = False,
    step: Optional[int] = None,
    manifest: bool = True,
):
    """Save a state tree without gathering: every process writes what it
    holds. ``async_save`` returns a handle at once (the leaves staged on the
    host, the write running in the background; see the module docstring).

    The manifest (the commit marker) is written only after the data is
    durable: at once for a sync save, inside ``wait_until_finished()`` for
    an async one."""
    from ..profiler import spans as _spans

    with _spans.span("ckpt_save", step=step, async_save=async_save) as sp:
        with _spans.span("serialize"):
            arrays = _to_arrays(state_dict)
            path = os.path.abspath(path)
            staged, event = _stage(arrays)
        sp.set(leaves=len(staged), path=path)
        old = None
        if os.path.exists(path):
            # keep the previous checkpoint until the new one lands: parked
            # aside WITH its manifest, dropped only after a committed save
            # (resume treats a committed .old as a valid fallback)
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            _remove_manifest(old)
            os.rename(path, old)
            _move_manifest(path, old)
        try:
            from ..fault import inject as _inject

            _inject.check("ckpt.write", path=path)
            if async_save:
                return _PendingSave(staged, event, path, step, manifest, old)
            with _spans.span("write", async_save=False):
                entries = _write_leaves(staged, event, path)
        except Exception:
            if old and not os.path.exists(path):
                os.rename(old, path)
                _move_manifest(old, path)
            raise
        with _spans.span("commit"):
            if manifest:
                _write_manifest(_build_manifest(entries, step), path)
        _prof().counter_inc("ckpt_saves")
        if old:
            shutil.rmtree(old, ignore_errors=True)
            _remove_manifest(old)
        return None


def load_state_dict(
    state_dict: Dict[str, Any],
    path: str,
    strict: bool = True,
    verify: Optional[bool] = None,
):
    """Restore into ``state_dict`` in place (each tensor copied into the
    live one, on its device and in its dtype).

    ``strict`` (default): raise CheckpointError listing keys missing from the
    checkpoint and unexpected keys present only in the checkpoint, instead of
    silently skipping them. ``strict=False`` skips them.

    ``verify``: recompute each leaf's checksum against the manifest. Default
    (None): verify when a manifest exists and ``FLAGS_ckpt_verify_on_load``
    is set; manifest-less checkpoints load unverified."""
    path = os.path.abspath(path)
    man = read_manifest(path)
    if verify is None:
        verify = man is not None and bool(
            _flags.flag("FLAGS_ckpt_verify_on_load", True))
    if verify:
        if man is None:
            raise CheckpointError(f"checkpoint {path}: no manifest to verify against")
        if not man.get("committed"):
            raise CheckpointError(f"checkpoint {path}: manifest present but not committed")
    try:
        flat = _read_leaves(path, man if verify else None)
    except CheckpointError:
        raise
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointError(f"checkpoint {path}: unreadable ({e!r})") from e
    if strict:
        exact, objroots = _tree_keys(state_dict)
        have = set(flat)

        def under_obj(key):
            return any(key == r or key.startswith(r + "/") for r in objroots)

        missing = sorted(k for k in exact if k not in have)
        missing += sorted(
            r for r in objroots
            if not any(h == r or h.startswith(r + "/") for h in have)
        )
        unexpected = sorted(h for h in have if h not in exact and not under_obj(h))
        if missing or unexpected:
            raise CheckpointError(
                f"checkpoint {path}: state mismatch — missing keys "
                f"{missing or '[]'}, unexpected keys {unexpected or '[]'} "
                f"(pass strict=False to skip silently)"
            )
    _apply_arrays(state_dict, _unflatten(flat))
    return state_dict


class AutoCheckpoint:
    """Periodic checkpoint + automatic CRASH-SAFE resume (reference
    auto_checkpoint.py:71 ``train_epoch_range``): call ``maybe_save`` each
    step; on restart, ``resume`` returns the last completed step whose
    checkpoint verifies (or -1). A failed periodic save is retried with
    backoff, then logged and skipped — training outlives transient
    checkpoint I/O errors, and resume falls back to the previous good copy."""

    def __init__(
        self,
        save_dir: str,
        interval_steps: int = 100,
        keep_last: int = 2,
        async_save: bool = False,
        save_retries: int = 2,
    ):
        self.save_dir = os.path.abspath(save_dir)
        self.interval = int(interval_steps)
        self.keep_last = keep_last
        self.async_save = async_save
        self.save_retries = int(save_retries)
        self._pending = None
        # rollback-anchor pins (fault/sentinel.py): steps GC must never drop,
        # whatever keep_last says — the active rollback anchor may be older
        # than the retention window
        self._protected: set = set()
        os.makedirs(self.save_dir, exist_ok=True)

    # -- rollback anchor protocol ------------------------------------------
    def protect(self, step: int) -> None:
        """Pin ``step``: GC keeps it (and its ``.old`` backup) until
        :meth:`release`. The stability sentinel pins its active rollback
        anchor so keep_last can never collect the one checkpoint a rollback
        needs."""
        self._protected.add(int(step))

    def release(self, step: int) -> None:
        self._protected.discard(int(step))

    def protected(self) -> set:
        return set(self._protected)

    def invalidate(self, step: int) -> None:
        """Drop ``step``'s checkpoint (primary + backup + manifests) — the
        sentinel invalidates anchors saved inside a poisoned window after a
        rollback (a quarantined step is never replayed, so the bad copy
        would otherwise shadow future rollbacks). Pinned steps refuse."""
        step = int(step)
        if step in self._protected:
            raise ValueError(f"step {step} is a protected rollback anchor")
        for path in (self._step_path(step), self._step_path(step) + ".old"):
            shutil.rmtree(path, ignore_errors=True)
            _remove_manifest(path)

    def _meta_path(self):
        return os.path.join(self.save_dir, "latest.json")

    def _step_path(self, step):
        return os.path.join(self.save_dir, f"step_{step}")

    @staticmethod
    def _parse_step_dir(d: str) -> Optional[Tuple[int, bool]]:
        """``step_7`` -> (7, True); ``step_7.old`` -> (7, False); a write's
        temporary directory and anything else -> None."""
        if not d.startswith("step_"):
            return None
        rest = d[len("step_"):]
        if rest.isdigit():
            return int(rest), True
        if rest.endswith(".old") and rest[: -len(".old")].isdigit():
            return int(rest[: -len(".old")]), False
        return None

    def _candidates(self) -> List[Tuple[int, bool, str]]:
        """(step, is_primary, path) for every step dir incl. .old backups,
        newest first, primary before backup at the same step."""
        out = []
        for d in os.listdir(self.save_dir):
            parsed = self._parse_step_dir(d)
            if parsed is not None and os.path.isdir(os.path.join(self.save_dir, d)):
                step, primary = parsed
                out.append((step, primary, os.path.join(self.save_dir, d)))
        out.sort(key=lambda t: (t[0], t[1]), reverse=True)
        return out

    def _is_committed(self, path: str) -> bool:
        man = read_manifest(path)
        return bool(man and man.get("committed"))

    def _step_committed(self, step: int) -> bool:
        """Either the primary dir or its parked .old backup is committed —
        resume can use both, so GC must protect both."""
        return (
            self._is_committed(self._step_path(step))
            or self._is_committed(self._step_path(step) + ".old")
        )

    def maybe_save(self, step: int, state_dict: Dict[str, Any]) -> bool:
        if step == 0 or step % self.interval:
            # step 0 is the untrained state — saving it would also age out a
            # useful checkpoint one interval earlier under keep_last
            return False
        return self.save_now(step, state_dict)

    def save_now(self, step: int, state_dict: Dict[str, Any], sync: bool = False) -> bool:
        """Save unconditionally (``sync=True`` forces a synchronous save even
        in async mode — the preemption-drain path). Retries transient I/O
        failures with backoff; a save that still fails is logged and skipped
        (resume falls back to the previous verified checkpoint)."""
        from ..fault.retry import retry_call

        from ..profiler import flight as _flight

        try:
            # a failed async background write from the PREVIOUS save surfaces
            # here — log it like any other lost save instead of killing the
            # training loop (resume falls back to the last committed copy)
            self.wait()
        except Exception as e:
            _prof().counter_inc("ckpt_save_failures")
            _flight.dump(
                "ckpt_save_failure",
                extra={"step": step, "phase": "async_commit", "error": repr(e)},
            )
            warnings.warn(f"previous async checkpoint save failed (skipped): {e!r}")
        try:
            pend = retry_call(
                save_state_dict,
                state_dict,
                self._step_path(step),
                async_save=self.async_save and not sync,
                step=step,
                retries=self.save_retries,
                base_delay=0.05,
            )
        except Exception as e:
            _prof().counter_inc("ckpt_save_failures")
            _flight.dump(
                "ckpt_save_failure",
                extra={"step": step, "phase": "write", "error": repr(e)},
            )
            warnings.warn(f"checkpoint save at step {step} failed (skipped): {e!r}")
            return False
        self._pending = pend
        # legacy pointer only — resume verifies manifests instead; still
        # written atomically so a kill here can't leave torn JSON for any
        # legacy reader of latest.json
        from ..framework.io import atomic_open

        with atomic_open(self._meta_path(), "w") as f:
            json.dump({"step": step, "ts": time.time()}, f)
        self._gc()
        return True

    def _gc(self):
        """Drop old checkpoints, but NEVER the newest verified-good copy —
        if the last ``keep_last`` saves all turn out corrupt, the verified
        one is the only resumable state left."""
        steps = sorted({s for s, _primary, _ in self._candidates()})
        # keep_last=0 historically meant "keep everything" (old GC sliced
        # steps[:-0] == [])
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        committed = [s for s in steps if self._step_committed(s)]
        if committed:
            keep.add(committed[-1])
        keep |= self._protected  # pinned rollback anchors survive any window
        for s in steps:
            if s in keep:
                continue
            for path in (self._step_path(s), self._step_path(s) + ".old"):
                shutil.rmtree(path, ignore_errors=True)
                _remove_manifest(path)

    def resume(self, state_dict: Dict[str, Any], max_step: Optional[int] = None) -> int:
        """Load the newest VERIFIED checkpoint into state_dict; returns its
        step or -1. Walks candidates newest-first — primary dirs then their
        ``.old`` backups — skipping uncommitted (mid-write crash), corrupt
        (checksum mismatch) and unreadable checkpoints. Does NOT trust
        latest.json: the pointer can be ahead of the async finalize.

        ``max_step`` bounds the walk (rollback anchor protocol): checkpoints
        saved at later steps are skipped outright — a stability rollback
        must land STRICTLY BEFORE the poisoned step, and an anchor saved
        inside the detection window may already carry the bad update."""
        if not os.path.isdir(self.save_dir):
            return -1
        fell_back = 0
        for step, _primary, path in self._candidates():
            if max_step is not None and step > max_step:
                continue
            man = read_manifest(path)
            if man is not None and not man.get("committed"):
                fell_back += 1
                continue
            try:
                # legacy checkpoints (no manifest) load unverified; manifest
                # checkpoints verify checksums end-to-end. strict=False: a
                # tree mismatch here means the USER's model changed — every
                # older checkpoint shares the tree, so walking back would
                # only silently discard all progress instead of restoring
                # what still matches (the pre-manifest behavior).
                load_state_dict(state_dict, path, strict=False, verify=man is not None)
            except Exception:
                fell_back += 1
                continue
            if fell_back:
                _prof().counter_inc("ckpt_resume_fallbacks", fell_back)
            return step
        if fell_back:
            _prof().counter_inc("ckpt_resume_fallbacks", fell_back)
        return -1

    def wait(self):
        if self._pending is not None:
            try:
                self._pending.wait_until_finished()
            finally:
                # even on failure, drop the handle: re-raising the same error
                # from every later save would wedge the loop permanently
                self._pending = None


class CoordinatedCheckpoint:
    """Multi-rank checkpointing with a store-mediated TWO-PHASE commit, so a
    resume can never mix steps across ranks (ZeRO-1's engine-resident sharded
    optimizer state makes a torn multi-rank checkpoint unreconstructable, not
    merely stale).

    Layout: ``<dir>/step_K/rank_R`` — each rank's shard saved through
    :func:`save_state_dict` (per-rank manifest = that rank's durability
    marker). Phase 1: every rank serializes + CRCs + writes, then acks on the
    shared store. Phase 2: rank 0 waits for ``world_size`` acks, writes the
    durable step commit marker (``<dir>/step_K/COMMITTED.json``, tmp +
    ``os.replace``) and publishes the store commit record that releases the
    waiting ranks. A crash at ANY point before the marker lands leaves the
    step uncommitted on EVERY rank; resume walks past it.

    Resume: newest-first over step dirs; a dir is eligible only when the
    commit marker is present and every rank's manifest is committed. A dir
    whose rank manifests disagree on the step they were written at is
    corrupt-by-construction and rejected loudly (cross-rank manifest
    agreement check), naming the disagreeing steps. When a store is bound,
    ranks additionally publish the step they resolved and verify the whole
    world agreed before loading.

    ``async_save=True`` (the port's addition) stages this rank's shard on
    the host and writes it in the background: ``save_now`` returns once
    the write started, and :meth:`wait` (or the next save) runs phase 1
    after the data is durable and then phase 2, so the protocol is the
    synchronous one, later.
    """

    COMMIT_MARKER = "COMMITTED.json"

    def __init__(
        self,
        save_dir: str,
        world_size: Optional[int] = None,
        rank: Optional[int] = None,
        store=None,
        interval_steps: int = 100,
        keep_last: int = 2,
        commit_timeout_s: Optional[float] = None,
        save_retries: int = 2,
        async_save: bool = False,
    ):
        from .coord import CommitBarrier, store_from_env

        self.save_dir = os.path.abspath(save_dir)
        self.world_size = int(
            world_size if world_size is not None
            else os.environ.get("PADDLE_TRAINERS_NUM", "1")
        )
        self.rank = int(
            rank if rank is not None else os.environ.get("PADDLE_TRAINER_ID", "0")
        )
        self.store = store if store is not None else store_from_env()
        self.interval = int(interval_steps)
        self.keep_last = keep_last
        self.save_retries = int(save_retries)
        self._commit_timeout_s = commit_timeout_s
        self.barrier = (
            CommitBarrier(self.store, self.world_size, self.rank, prefix="ckpt")
            if self.store is not None else None
        )
        self._protected: set = set()  # rollback-anchor pins (rank-local)
        self.async_save = bool(async_save)
        self._pending = None  # (step, the async write's handle)
        os.makedirs(self.save_dir, exist_ok=True)

    # -- rollback anchor protocol (same contract as AutoCheckpoint) --------
    def protect(self, step: int) -> None:
        self._protected.add(int(step))

    def release(self, step: int) -> None:
        self._protected.discard(int(step))

    def invalidate(self, step: int) -> None:
        """Drop ``step``'s whole step dir (rank 0 only; other ranks no-op so
        a world-wide sentinel rollback deletes each dir exactly once)."""
        step = int(step)
        if step in self._protected:
            raise ValueError(f"step {step} is a protected rollback anchor")
        if self.rank == 0:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # -- paths -------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.save_dir, f"step_{int(step)}")

    def _rank_path(self, step: int, rank: Optional[int] = None) -> str:
        return os.path.join(
            self._step_dir(step), f"rank_{self.rank if rank is None else rank}"
        )

    def _marker_path(self, step: int) -> str:
        return os.path.join(self._step_dir(step), self.COMMIT_MARKER)

    def commit_timeout_s(self) -> float:
        """Deadline for the commit barrier: explicit > watchdog flag > 60s.
        A dead peer must fail the SAVE (uncommitted, training's caller
        decides), never hang it."""
        if self._commit_timeout_s is not None:
            return float(self._commit_timeout_s)
        from . import watchdog

        t = watchdog.timeout_s()
        return t if t > 0 else 60.0

    # -- save --------------------------------------------------------------
    def maybe_save(self, step: int, state_dict: Dict[str, Any]) -> bool:
        if step == 0 or step % self.interval:
            return False
        return self.save_now(step, state_dict)

    def save_now(self, step: int, state_dict: Dict[str, Any],
                 sync: Optional[bool] = None) -> bool:
        """Run this rank's side of the coordinated save. Returns True when
        the step COMMITTED (every rank acked and the marker landed); False
        when the save failed or the barrier timed out — the step stays
        invisible to resume, and the previous committed step remains the
        recovery point.

        With ``async_save=True`` (and ``sync`` not True: the drain of
        ``PreemptionGuard`` passes ``sync=True``) this rank's shard is
        staged on the host and written in the background; the call returns
        True once the write started, and phase 1 (the ack, after the data
        is durable) and phase 2 run in :meth:`wait`, which returns whether
        the step committed. A later save waits for the pending one
        first."""
        from ..fault import inject as _inject
        from ..fault.retry import retry_call
        from . import watchdog

        self.wait()
        watchdog.publish(step=step, phase="ckpt_save")
        step = int(step)
        background = self.async_save and not sync

        def begin():
            if self.barrier is not None and self.rank == 0:
                # a crashed earlier attempt at THIS step (relaunch replayed
                # to it) may have left acks/commit litter on the store;
                # counting those would let the marker land before every rank
                # of this attempt wrote durably — a torn-but-committed step
                self.barrier.reset(step)
            _inject.check("ckpt.serialize", step=step, rank=self.rank)
            os.makedirs(self._step_dir(step), exist_ok=True)
            return retry_call(
                save_state_dict,
                state_dict,
                self._rank_path(step),
                async_save=background,
                step=step,
                retries=self.save_retries,
                base_delay=0.05,
            )

        if not background:
            return self._guarded(step, lambda: (begin(), self._commit(step)))
        pend = []
        if not self._guarded(step, lambda: pend.append(begin()),
                             commits=False):
            return False
        self._pending = (step, pend[0])
        return True

    def wait(self) -> Optional[bool]:
        """Finish a pending async save: the background write, then the two
        phases. Returns whether that step committed (None: nothing was
        pending)."""
        if self._pending is None:
            return None
        step, pend = self._pending
        self._pending = None
        return self._guarded(step, lambda: (pend.wait_until_finished(),
                                            self._commit(step)))

    def _commit(self, step: int) -> None:
        """Phase 1 (this rank's ack: its shard is durable) and phase 2 (rank
        0's marker and commit record once every rank acked)."""
        from ..fault import inject as _inject
        from .coord import wait_for

        _inject.check("ckpt.ack", step=step, rank=self.rank)
        if self.barrier is not None:
            self.barrier.ack(step)
            _inject.check("ckpt.commit", step=step, rank=self.rank)
            if self.rank == 0:
                wait_for(
                    lambda: self.barrier.acks(step) >= self.world_size,
                    f"coordinated ckpt acks (step {step})",
                    self.commit_timeout_s(),
                )
                self._write_marker(step)
                self.barrier.commit(step, timeout_s=0.0)  # acks already in
            else:
                wait_for(
                    lambda: self.barrier.committed(step)
                    or os.path.exists(self._marker_path(step)),
                    f"coordinated ckpt commit marker (step {step})",
                    self.commit_timeout_s(),
                )
        else:
            # single-rank session (world 1, no store): the marker is the
            # whole protocol
            _inject.check("ckpt.commit", step=step, rank=self.rank)
            self._write_marker(step)

    def _guarded(self, step: int, fn, commits: bool = True) -> bool:
        """Run ``fn``; a failure or a missed deadline is a lost save (a
        counter, a flight dump, a warning and False), as the reference's
        ``save_now`` treats it. ``commits``: ``fn`` ran the commit, whose
        bookkeeping (the counter, the stale votes, GC) follows."""
        from ..profiler import flight as _flight
        from .coord import DeadlineExceeded

        try:
            fn()
        except DeadlineExceeded as e:
            _prof().counter_inc("ckpt_save_failures")
            _flight.dump(
                "coordinated_ckpt_timeout",
                extra={"step": step, "rank": self.rank, "error": str(e)},
            )
            warnings.warn(
                f"coordinated checkpoint at step {step} timed out "
                f"(uncommitted, skipped): {e}"
            )
            return False
        except Exception as e:
            _prof().counter_inc("ckpt_save_failures")
            _flight.dump(
                "ckpt_save_failure",
                extra={"step": step, "rank": self.rank, "phase": "coordinated",
                       "error": repr(e)},
            )
            warnings.warn(
                f"coordinated checkpoint at step {step} failed on rank "
                f"{self.rank} (uncommitted, skipped): {e!r}"
            )
            return False
        if not commits:
            return True
        _prof().counter_inc("ckpt_coordinated_commits")
        if self.rank == 0:
            # resume-agreement votes describe the PREVIOUS world state; left
            # behind, a later resume could read a peer's stale vote and
            # spuriously reject. A committed step supersedes them.
            if self.store is not None:
                for r in range(self.world_size):
                    try:
                        self.store.delete_key(f"ckpt/resume/{r}")
                    except Exception:
                        pass
            self._gc()
        return True

    def _write_marker(self, step: int) -> None:
        """The step's durable commit record — written by rank 0 only after
        every rank acked a durable, CRC'd shard."""
        rec = {
            "step": int(step), "ts": time.time(),
            "world_size": self.world_size, "committed": True,
        }
        tmp = self._marker_path(step) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._marker_path(step))

    # -- resume ------------------------------------------------------------
    def _steps_on_disk(self) -> List[int]:
        try:
            names = os.listdir(self.save_dir)
        except OSError:
            return []
        out = []
        for d in names:
            if d.startswith("step_") and d[len("step_"):].isdigit() \
                    and os.path.isdir(os.path.join(self.save_dir, d)):
                out.append(int(d[len("step_"):]))
        return sorted(out, reverse=True)

    def _rank_manifests(self, step: int) -> Dict[int, Optional[dict]]:
        return {
            r: read_manifest(self._rank_path(step, r))
            for r in range(self.world_size)
        }

    def check_manifest_agreement(self, step: int) -> None:
        """Cross-rank manifest agreement: every rank manifest present in the
        step dir must have been written at the SAME step. Disagreement means
        the directory mixes shards from different saves — unloadable by
        construction (ZeRO shards from different steps are not a state), so
        reject loudly instead of walking on."""
        seen: Dict[int, List[int]] = {}
        for r, man in self._rank_manifests(step).items():
            if man is None or "step" not in man:
                continue
            seen.setdefault(int(man["step"]), []).append(r)
        if len(seen) > 1:
            detail = ", ".join(
                f"step {s} (ranks {sorted(rs)})" for s, rs in sorted(seen.items())
            )
            raise CheckpointError(
                f"checkpoint dir {self._step_dir(step)}: rank manifests "
                f"disagree on the step they were written at — {detail}; "
                "the directory mixes shards from different saves and cannot "
                "be restored"
            )

    def _step_fully_committed(self, step: int) -> bool:
        marker = self._marker_path(step)
        try:
            with open(marker) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return False
        if not rec.get("committed"):
            return False
        mans = self._rank_manifests(step)
        return all(m is not None and m.get("committed") for m in mans.values())

    def resume(self, state_dict: Dict[str, Any], max_step: Optional[int] = None) -> int:
        """Load this rank's shard of the newest step EVERY rank committed;
        returns that step or -1. Walks back past uncommitted/partial steps
        (a crashed save); raises on a mixed-step directory (corruption the
        protocol can't produce). With a store bound, the world additionally
        agrees on the resolved step before anyone loads. ``max_step`` bounds
        the walk (stability-rollback anchor protocol — see
        ``AutoCheckpoint.resume``); every rank must pass the same bound or
        the agreement check rejects the resume."""
        fell_back = 0
        for step in self._steps_on_disk():
            if max_step is not None and step > max_step:
                continue
            self.check_manifest_agreement(step)
            if not self._step_fully_committed(step):
                fell_back += 1
                continue
            agreed = self._agree_on_resume_step(step)
            try:
                load_state_dict(
                    state_dict, self._rank_path(step), strict=False, verify=True
                )
            except Exception as e:
                if agreed:
                    # the world already settled on this step — peers are
                    # loading it NOW. Walking back here would silently mix
                    # steps across ranks (the exact state the protocol
                    # exists to prevent); fail loudly so the launcher
                    # restarts the whole world instead.
                    raise CheckpointError(
                        f"rank {self.rank}: the world agreed to resume from "
                        f"step {step} but this rank's shard failed to load "
                        f"({e!r}); refusing to fall back to an older step "
                        "while peers load the agreed one"
                    ) from e
                fell_back += 1
                continue
            if fell_back:
                _prof().counter_inc("ckpt_resume_fallbacks", fell_back)
            return step
        if fell_back:
            _prof().counter_inc("ckpt_resume_fallbacks", fell_back)
        return -1

    def _agree_on_resume_step(self, step: int) -> bool:
        """Store-mediated resume agreement: each rank publishes the step it
        resolved; disagreement (a rank seeing different fs state) raises
        naming both. Returns True only when a full, unanimous agreement ran
        — the caller then treats this step as BINDING (a local load failure
        must raise, not walk back, because peers are loading it). Advisory
        (False) when no store is bound or peers never showed up."""
        if self.store is None:
            return False
        from .coord import DeadlineExceeded, wait_for

        key = f"ckpt/resume/{self.rank}"
        self.store.set(key, str(int(step)))

        def all_published():
            return all(
                self.store.get(f"ckpt/resume/{r}") is not None
                for r in range(self.world_size)
            )

        try:
            wait_for(all_published, "resume-step agreement", self.commit_timeout_s())
        except DeadlineExceeded:
            warnings.warn(
                "resume-step agreement timed out (peers absent); proceeding "
                f"with locally-resolved step {step}"
            )
            return False
        votes = {
            r: int(self.store.get(f"ckpt/resume/{r}"))
            for r in range(self.world_size)
        }
        if len(set(votes.values())) > 1:
            raise CheckpointError(
                f"ranks disagree on the resume step: {votes} — refusing to "
                "mix steps across ranks"
            )
        return True

    # -- GC ----------------------------------------------------------------
    def _gc(self) -> None:
        """Rank 0 only: drop old step dirs, but never the newest fully
        committed one (the only recovery point if later saves turn out
        torn)."""
        steps = sorted(self._steps_on_disk())
        keep = set(steps[-self.keep_last:]) if self.keep_last else set(steps)
        committed = [s for s in steps if self._step_fully_committed(s)]
        if committed:
            keep.add(committed[-1])
        keep |= self._protected  # pinned rollback anchors survive any window
        for s in steps:
            if s in keep:
                continue
            shutil.rmtree(self._step_dir(s), ignore_errors=True)


def _engine_accums(engine):
    """Each engine parameter's optimizer name and accumulators (created
    with the rule's initial values when the optimizer has not stepped it
    yet, as the reference's ``_functional_state`` does)."""
    opt = engine.optimizer
    index = {id(p): i for i, p in enumerate(opt._parameter_list)}
    out = []
    for p in engine.params:
        name = opt._names[index[id(p)]]
        st = opt._accumulators.get(name)
        if st is None:
            st = opt._init_accums(p)
        out.append((name, st))
    return out


def engine_state_dict(engine) -> Dict[str, Any]:
    """Checkpointable view of a ``HybridParallelEngine``: its parameters
    (this rank's shards), the optimizer's accumulators and step count. For
    SAVING; restore with ``engine_load_state_dict`` or
    ``engine_apply_state`` (the accumulators of a parameter the optimizer
    has not stepped yet are fresh tensors the optimizer does not hold)."""
    state = {}
    sync = getattr(engine, "sync_optimizer_state", None)
    if sync is not None:
        sync()  # the sharded update keeps its moments in flat shards
    for i, p in enumerate(engine.params):
        state[f"param_{i}"] = p
    for i, (_, st) in enumerate(_engine_accums(engine)):
        for k, v in st.items():
            state[f"accum_{i}_{k}"] = v
    # the step count drives Adam/AdamW's bias correction: without it a
    # resume restarts the correction at t=1
    state["opt_step"] = torch.tensor(engine.optimizer._step_count,
                                     dtype=torch.int64)
    return state


def engine_apply_state(engine, state: Dict[str, Any]) -> None:
    """Push a RESTORED ``engine_state_dict`` tree into the engine: the
    parameters were restored in place; the accumulator tensors become the
    optimizer's, the step count is restored, and the sharded update's
    state is dropped so the next step repacks it. Shared by
    ``engine_load_state_dict`` and the stability sentinel's rollback."""
    opt = engine.optimizer
    step_t = state.get("opt_step")
    if step_t is not None:
        opt._step_count = int(step_t)
    for i, (name, st) in enumerate(_engine_accums(engine)):
        restored = {k: state[f"accum_{i}_{k}"] for k in st
                    if f"accum_{i}_{k}" in state}
        if restored:
            opt._accumulators[name] = dict(st, **restored)
    inval = getattr(engine, "invalidate_dp_state", None)
    if inval is not None:
        inval()


def engine_load_state_dict(engine, path) -> None:
    """Restore the parameters AND the optimizer state of a
    ``HybridParallelEngine`` from a checkpoint of ``engine_state_dict``."""
    state = engine_state_dict(engine)
    load_state_dict(state, path)
    engine_apply_state(engine, state)


__all__ = [
    "save_state_dict", "load_state_dict", "AutoCheckpoint", "CheckpointError",
    "CoordinatedCheckpoint", "read_manifest", "engine_state_dict",
    "engine_apply_state", "engine_load_state_dict",
]
