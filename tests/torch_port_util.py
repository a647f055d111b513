"""Shared helpers for the port's parity tests (tests/test_torch_*.py): the
JAX model's weights exported as numpy, the port model built from them, and
the serving tests' flag, chaos, wave, wait and drain helpers."""
import contextlib
import dataclasses
import time

import numpy as np

from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTForPretraining,
                                     LlamaConfig, LlamaForCausalLM,
                                     load_reference_state_dict)


@contextlib.contextmanager
def cpu_device():
    """``paddle_tpu_torch.set_device("cpu")`` for the block, then the
    thread's previous choice (or none) back."""
    from paddle_tpu_torch.core import place

    had = hasattr(place._state, "place")
    old = getattr(place._state, "place", None)
    place.set_device("cpu")
    try:
        yield
    finally:
        if had:
            place._state.place = old
        else:
            place._state.__dict__.pop("place", None)


def reference_state(jmodel):
    """The JAX model's ``state_dict()`` as float32 numpy arrays."""
    return {k: np.asarray(v, np.float32) for k, v in jmodel.state_dict().items()}


def port_of(jmodel, **config):
    """A CPU ``paddle_tpu_torch`` GPT (eval, no dropout) carrying the JAX
    GPT's weights, loaded by parameter name; ``config`` sets further
    ``GPTConfig`` fields."""
    cfg = GPTConfig(**{f: getattr(jmodel.config, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "max_position_embeddings")}, hidden_dropout=0.0,
        attention_dropout=0.0, **config)
    m = GPTForPretraining(cfg, device="cpu").eval()
    load_reference_state_dict(m, reference_state(jmodel))
    return m


def port_of_llama(jmodel):
    """A CPU ``paddle_tpu_torch`` Llama (eval) carrying the JAX Llama's
    weights, loaded by parameter name; its config copies the reference's."""
    cfg = LlamaConfig(**{f.name: getattr(jmodel.model.config, f.name)
                         for f in dataclasses.fields(LlamaConfig)})
    m = LlamaForCausalLM(cfg, device="cpu").eval()
    load_reference_state_dict(m, reference_state(jmodel))
    return m


def port_of_ernie(jmodel):
    """A CPU ``paddle_tpu_torch`` ERNIE carrying the JAX ERNIE's weights,
    loaded by parameter name; its config copies the reference's (set its
    dropouts to 0 there for a parity run)."""
    cfg = ErnieConfig(**{f.name: getattr(jmodel.config, f.name)
                         for f in dataclasses.fields(ErnieConfig)})
    m = ErnieForPretraining(cfg, device="cpu")
    load_reference_state_dict(m, reference_state(jmodel))
    return m


@contextlib.contextmanager
def serve_flags(**fl):
    """The same ``FLAGS_*`` values in the reference's and the port's
    registries for the block; both are restored after it."""
    from paddle_tpu.framework import flags as jflags
    from paddle_tpu_torch.framework import flags as tflags

    old_j = {k: jflags._FLAGS.get(k) for k in fl}
    old_t = tflags.get_flags(list(fl))
    jflags._FLAGS.update(fl)
    tflags.set_flags(fl)
    try:
        yield
    finally:
        jflags._FLAGS.update(old_j)
        tflags.set_flags(old_t)


def serve_waves(eng, waves, **submit_kw):
    """Outputs of each wave of prompts (the prompts of a wave are submitted
    at once, and the next wave waits for them)."""
    out = []
    for wave in waves:
        handles = [eng.submit(p, **submit_kw) for p in wave]
        out.append([h.result(timeout=300) for h in handles])
    return out


def drained(eng, timeout=30.0):
    """``eng.stats()`` once only the prefix index holds pages (or after
    ``timeout``), with the pool's conservation checked."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        st = eng.stats()
        if st["pages_used"] == st["pages_cached"]:
            break
        time.sleep(0.01)
    eng._pool.check()
    return eng.stats()


@contextlib.contextmanager
def chaos(spec):
    """The same fault-injection spec armed in the reference's and the port's
    ``fault.inject`` for the block; both are disarmed after it."""
    from paddle_tpu.fault import inject as jinject
    from paddle_tpu_torch.fault import inject as tinject

    jinject.arm(spec)
    tinject.arm(spec)
    try:
        yield
    finally:
        jinject.disarm()
        tinject.disarm()


def wait_for(cond, timeout, what):
    """Poll ``cond()`` every 5 ms until it holds; fails with ``what`` after
    ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout}s: {what}")
        time.sleep(0.005)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(worker, args, world, d, timeout_s, attempts=2):
    """Run ``python <worker> *args`` as ``world`` gloo ranks of one group on
    a free local port (each with ``OMP_NUM_THREADS=1``), wait at most
    ``timeout_s`` for all of them, and return what each wrote to
    ``<d>/rank<r>.pt``. A rank that fails stops the others at once. The
    port is picked free and released before the ranks bind it, so another
    process may take it first: a rendezvous that finds it taken is started
    again on a new port (``attempts`` in all). A rank that hangs, fails or
    reports an error fails the caller's fixture."""
    import os
    import subprocess
    import sys
    import tempfile
    import time
    from pathlib import Path

    import pytest
    import torch

    for attempt in range(attempts):
        port = free_port()
        procs, logs = [], []
        for r in range(world):
            env = dict(os.environ, PADDLE_TRAINERS_NUM=str(world),
                       PADDLE_TRAINER_ID=str(r),
                       PADDLE_TRAINER_ENDPOINTS=f"127.0.0.1:{port}",
                       OMP_NUM_THREADS="1",
                       PYTHONPATH=str(Path(worker).resolve().parents[1]))
            log = tempfile.TemporaryFile(mode="w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), *map(str, args)], env=env,
                stdout=log, stderr=subprocess.STDOUT, text=True))

        def text(r):
            logs[r].seek(0)
            return logs[r].read()[-4000:]

        deadline = time.monotonic() + timeout_s
        failed = None
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            failed = next((r for r, c in enumerate(codes)
                           if c not in (None, 0)), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if failed is None and any(p.returncode != 0 for p in procs):
            pytest.fail(f"a gloo rank did not finish in {timeout_s}s:\n"
                        + "\n".join(text(r) for r in range(world)))
        if failed is not None:
            out = text(failed)
            if "ddress already in use" in out and attempt + 1 < attempts:
                continue
            pytest.fail(f"rank {failed} exited {procs[failed].returncode}:"
                        f"\n{out}")
        break
    got = []
    for r in range(world):
        f = Path(d) / f"rank{r}.pt"
        assert f.exists(), f"rank {r} wrote nothing:\n{text(r)}"
        res = torch.load(f, weights_only=False)
        assert "error" not in res, f"rank {r}: {res['error']}"
        got.append(res)
    return got


def as_numpy(t):
    """(numpy value, dtype name) of a tensor of either package; bfloat16 as
    float32 values."""
    import torch

    from paddle_tpu.core.dtype import dtype_name as jname
    from paddle_tpu_torch.core.dtype import dtype_name as tname

    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        name = tname(t.dtype)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy(), name
    name = jname(t.dtype)
    return np.asarray(t.numpy(), np.float32 if name == "bfloat16" else None), \
        name


def assert_same(got, want, rtol=1e-5, atol=1e-6, what=""):
    """A port output held to the reference's: dtype by name, shape, float
    values within ``rtol``/``atol`` (NaN where NaN), complex values by
    absolute error ``atol``, integer and bool values exactly."""
    (gv, gn), (wv, wn) = as_numpy(got), as_numpy(want)
    assert gn == wn, (what, gn, wn)
    assert gv.shape == wv.shape, (what, gv.shape, wv.shape)
    if gv.dtype.kind == "f":
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=what)
    elif gv.dtype.kind == "c":
        assert np.abs(gv - wv).max(initial=0.0) <= atol + rtol * np.abs(
            wv).max(initial=0.0), what
    else:
        np.testing.assert_array_equal(gv, wv, err_msg=what)


def flat_outputs(out):
    """An op's outputs as a list (one tensor, or a tuple or list)."""
    return list(out) if isinstance(out, (list, tuple)) else [out]


def public_names(path):
    """The public names a module file defines at its top level (functions,
    classes and assignments not starting with ``_``), read from its source,
    so names it imports are left out."""
    import ast

    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}
