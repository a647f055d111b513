"""Port parity: the paged serving path of ``paddle_tpu_torch`` against JAX.

Same weights (the JAX tiny GPT's ``state_dict()`` loaded by name), same
numpy-made ids, tables, positions and pools in both packages, f32 on the
CPU. The JAX paged-attention kernel runs in Pallas interpret mode; the
port's wrappers run their plain versions. Logits and pools agree within
atol 1e-4 / 1e-5 (summation order); greedy tokens must be equal. The port
updates its pools in place, so it gets its own copies of the inputs.
"""
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu.models.generation as JG
from paddle_tpu.framework import flags as jflags
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import Engine, RequestCancelled
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import port_of

BS, MB = 8, 4


@pytest.fixture(scope="module")
def models():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


def _states(models):
    jm, tm = models
    _, jarch, jparams, _ = JG.gpt_decode_state(jm)
    _, tarch, tparams, _ = TG.gpt_decode_state(tm, "cpu")
    return jarch, jparams, tarch, tparams


def _pools(L, NB, KV, D, rng=None):
    shape = (L, NB, BS, KV, D)
    if rng is None:
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def test_paged_prefill_logits_and_pool_blocks(models):
    jarch, jparams, tarch, tparams = _states(models)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    B, T = 2, 16
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 211, (B, T)).astype(np.int32)
    lens = np.array([13, 5], np.int32)
    tables = np.zeros((B, 16), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :1] = [5]
    kp, vp = _pools(L, 12, KV, D)
    jk, jv, jl = jax.jit(JG.build_paged_prefill(jarch, B, T, BS, 16))(
        jparams, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(tables),
        jnp.asarray(kp), jnp.asarray(vp))
    with torch.inference_mode():
        tk, tv, tl = TG.build_paged_prefill(tarch, B, T, BS, 16)(
            tparams, *map(torch.from_numpy, (ids, lens, tables, kp.copy(),
                                             vp.copy())))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    live = [3, 7, 5]  # the trash block 0 takes the padding rows' writes
    np.testing.assert_allclose(tk.numpy()[:, live], np.asarray(jk)[:, live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy()[:, live], np.asarray(jv)[:, live],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
def test_paged_decode_steps_tokens_and_pools(models, kernel):
    jarch, jparams, tarch, tparams = _states(models)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    B, NB = 4, 24
    rng = np.random.RandomState(1)
    kp, vp = _pools(L, NB, KV, D, rng)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB) \
        .astype(np.int32)
    pos = np.array([3, 8, 17, 27], np.int32)
    toks = rng.randint(0, 211, (B,)).astype(np.int32)
    temps = np.zeros((B,), np.float32)
    jbuild = JG.build_paged_decode_kernel if kernel else JG.build_paged_decode
    tbuild = TG.build_paged_decode_kernel if kernel else TG.build_paged_decode
    jstep = jax.jit(jbuild(jarch, B, BS, MB))
    tstep = tbuild(tarch, B, BS, MB)
    jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jt = tt = toks
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        p = pos + step
        jk, jv, jn = jstep(jparams, jk, jv, jnp.asarray(tables),
                           jnp.asarray(p), jnp.asarray(jt), jnp.asarray(temps),
                           jax.random.PRNGKey(step))
        with torch.inference_mode():
            tk, tv, tn = tstep(tparams, tk, tv, torch.from_numpy(tables),
                               torch.from_numpy(p), torch.from_numpy(tt),
                               torch.from_numpy(temps), gen)
        jt, tt = np.asarray(jn), tn.numpy()
        assert tt.tolist() == jt.tolist(), step
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf", "int8"])
def test_engine_greedy_tokens_match_reference_engine(models, int8):
    jm, tm = models
    fl = {"FLAGS_serve_paged_kernel": True, "FLAGS_serve_int8_kernel": int8}
    old_j = {k: jflags._FLAGS.get(k) for k in fl}
    old_t = tflags.get_flags(list(fl))
    jflags._FLAGS.update(fl)
    tflags.set_flags(fl)
    prompts = make_prompts(4, np.random.RandomState(3))
    try:
        with JEngine(jm, int8=int8, **ENGINE_KW) as je:
            ref = [h.result(timeout=300) for h in
                   [je.submit(p, max_new_tokens=8) for p in prompts]]
        with Engine(tm, device="cpu", int8=int8, **ENGINE_KW) as te:
            out = [h.result(timeout=300) for h in
                   [te.submit(p, max_new_tokens=8) for p in prompts]]
            assert te.stats()["decode_steps"] > 0
    finally:
        jflags._FLAGS.update(old_j)
        tflags.set_flags(old_t)
    assert out == ref
    assert all(len(o) == len(p) + 8 for o, p in zip(out, prompts))


def test_engine_stream_cancel_drains_pages(models):
    _, tm = models
    with Engine(tm, device="cpu", **ENGINE_KW) as eng:
        other = eng.submit([5, 6, 7], max_new_tokens=6)
        h = eng.submit(list(range(10)), max_new_tokens=100, stream=True)
        got = []
        for tok in h:
            got.append(tok)
            if len(got) == 2:
                h.cancel()
        assert 2 <= len(got) < 100
        with pytest.raises(RequestCancelled):
            h.result(timeout=30)
        assert len(other.result(timeout=30)) == 3 + 6
        deadline = time.monotonic() + 30
        while eng.stats()["pages_used"] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.stats()["pages_used"] == 0
        eng._pool.check()
