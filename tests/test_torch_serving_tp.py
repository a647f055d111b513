"""Port parity: tensor-parallel serving in ``paddle_tpu_torch`` (the ``tp_*``
packing helpers and builders of ``models/generation.py`` and the engine at
``tp=2``) against the JAX reference.

The tiny GPT of ``serving_util`` and a tiny GQA Llama (``llama_tiny(
num_kv_heads=2)``: 4 query heads over 2 KV heads) are built in both packages
with the same weights (``load_reference_state_dict`` by name), f32 on the
CPU. The reference's tp programs run under ``shard_map`` over two of the
eight forced host devices (``tests/conftest.py``), its paged-attention kernel
in Pallas interpret mode; the port's shards are two trees on the CPU and its
kernel wrapper runs the plain paged read there. Against the reference, pools
and logits agree within 1e-6 of each tensor's largest magnitude (JAX and
torch sum in other orders; RoPE'd keys near 3 differ by up to 2.4e-6, as
the one-device builders do) and tokens exactly. Against the port's own
one-device builders, the tp builders' logits and gathered pools agree
within the same bound and their greedy tokens are equal, and so are the
engines' tokens at tp = 2 and tp = 1. Every gathered element is the product
one shard computed; the gather path's attention over a shard's KV heads can
still round apart from the whole pool's (its batched product has other
strides: 1.3e-7 on the CPU), so logits are not held bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import Engine as JEngine
from paddle_tpu.serving import int8 as jint8
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import flags as tflags
from paddle_tpu_torch.models import generation as TG
from paddle_tpu_torch.serving import (Engine, EngineConfig, ServingSupervisor,
                                      SnapshotError)
from paddle_tpu_torch.serving import int8 as tint8
from serving_util import ENGINE_KW, make_prompts, tiny_gpt
from torch_port_util import chaos, port_of, port_of_llama, serve_flags, \
    wait_for

BS, MB, TP = 8, 4, 2
CPU = torch.device("cpu")
KW = dict(ENGINE_KW, device="cpu")


def _close(got, want):
    """|got - want| <= 1e-6 x max(1, the largest |want|), elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def gpt():
    jm = tiny_gpt(seed=0)
    return jm, port_of(jm)


@pytest.fixture(scope="module")
def llama():
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_kv_heads=2))
    jm.eval()
    return jm, port_of_llama(jm)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:TP]), ("tp",))


def _states(models, kind):
    jm, tm = models
    if kind == "gpt":
        return JG.gpt_decode_state(jm), TG.gpt_decode_state(tm, "cpu")
    return JG.llama_decode_state(jm), TG.llama_decode_state(tm, "cpu")


def _model(kind, gpt, llama):
    return gpt if kind == "gpt" else llama


def _jpacked(jkey, jparams, mesh):
    packed, vocab = JG.tp_pack_params(jkey, jparams, TP)
    rep_s, shard_s = JG.tp_param_shardings(mesh)
    return {"rep": jax.device_put(packed["rep"], rep_s),
            "shard": jax.device_put(packed["shard"], shard_s)}, vocab


def _shards(pool):
    """A (L, NB, BS, KV, D) numpy pool as the port's two KV-head shards."""
    kvl = pool.shape[3] // TP
    return [torch.from_numpy(pool[..., d * kvl:(d + 1) * kvl, :].copy())
            for d in range(TP)]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict) and "__int8__" in tree:
        yield prefix + "/q", tree["__int8__"]
        yield prefix + "/scale", tree["scale"]
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ------------------------------------------------------------ packing helpers
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_pack_params_matches_reference_shards(gpt, llama, kind, int8):
    (jkey, _, jparams, _), (tkey, _, tparams, _) = _states(
        _model(kind, gpt, llama), kind)
    assert tkey == jkey
    if int8:
        jparams = jint8.quantize_params(jparams)
        tparams = tint8.quantize_params(tparams)
    jp, jvocab = JG.tp_pack_params(jkey, jparams, TP)
    tp_, tvocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    assert tvocab == jvocab
    jrep, trep = dict(_leaves(jp["rep"])), dict(_leaves(tp_["rep"]))
    assert set(trep) == set(jrep)
    for k, v in jrep.items():
        np.testing.assert_array_equal(trep[k].numpy(), np.asarray(v),
                                      err_msg=k)
    jsh = dict(_leaves(jp["shard"]))
    assert len(tp_["shard"]) == TP
    for d, tree in enumerate(tp_["shard"]):
        tsh = dict(_leaves(tree))
        assert set(tsh) == set(jsh)
        for k, v in jsh.items():
            t = tsh[k]
            # its own tensor, contiguous: the kernel and the views need it
            assert t.is_contiguous(), k
            np.testing.assert_array_equal(t.numpy(), np.asarray(v)[d],
                                          err_msg=f"shard {d} {k}")


def test_tp_pack_pads_the_vocab_to_a_tp_multiple(gpt):
    """211 (GPT's tiny vocab) over 2 shards: the head is zero-padded to 212
    rows, each shard holding 106; the padding is sliced off the logits."""
    (_, _, _, _), (tkey, _, tparams, _) = _states(gpt, "gpt")
    packed, vocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    heads = [s["head_w"] for s in packed["shard"]]
    assert vocab == 211 and [h.shape[0] for h in heads] == [106, 106]
    assert torch.equal(torch.cat(heads)[:211], tparams["wte"])
    assert not heads[1][-1].any()


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_collective_bytes_matches_reference(gpt, llama, kind, B):
    (jkey, _, jparams, _), (tkey, _, tparams, _) = _states(
        _model(kind, gpt, llama), kind)
    for tp in (2, 4):
        if tkey[2 if kind == "llama" else 1] % tp:
            continue
        assert TG.tp_collective_bytes(tkey, tparams, B, tp) \
            == JG.tp_collective_bytes(jkey, jparams, B, tp)


def test_tp_validate_names_what_does_not_divide(gpt, llama):
    (_, _, _, _), (tkey, _, tparams, _) = _states(gpt, "gpt")
    with pytest.raises(ValueError, match="attention heads"):
        TG.tp_validate(tkey, tparams, 4)  # H = 2
    (_, _, _, _), (lkey, _, lparams, _) = _states(llama, "llama")
    with pytest.raises(ValueError, match="kv heads"):
        TG.tp_validate(lkey, lparams, 4)  # KV = 2


# -------------------------------------------------------------- the builders
def _prefill_inputs(V):
    rng = np.random.RandomState(7)
    B, T = 2, 16
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    lens = np.array([13, 5], np.int32)
    tables = np.zeros((B, 16), np.int32)
    tables[0, :2] = [3, 7]
    tables[1, :1] = [5]
    return B, T, ids, lens, tables


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_prefill_matches_reference_and_one_device(gpt, llama, mesh, kind):
    (jkey, jarch, jparams, _), (tkey, tarch, tparams, _) = _states(
        _model(kind, gpt, llama), kind)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    V = tparams["wte"].shape[0]
    B, T, ids, lens, tables = _prefill_inputs(V)
    shape = (L, 12, BS, KV, D)
    kp, vp = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    jp, jvocab = _jpacked(jkey, jparams, mesh)
    pool_s = JG.tp_pool_sharding(mesh)
    jk, jv, jl = jax.jit(JG.build_tp_paged_prefill(
        jkey, B, T, BS, 16, mesh, jvocab, jnp.float32))(
            jp, jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(tables),
            jax.device_put(jnp.asarray(kp), pool_s),
            jax.device_put(jnp.asarray(vp), pool_s))
    packed, vocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    args = tuple(map(torch.from_numpy, (ids, lens, tables)))
    with torch.inference_mode():
        tk, tv, tl = TG.build_tp_paged_prefill(
            tkey, B, T, BS, 16, [CPU] * TP, vocab, torch.float32)(
                packed, *args, _shards(kp), _shards(vp))
        sk, sv, sl = TG.build_paged_prefill(tarch, B, T, BS, 16)(
            tparams, *args, torch.from_numpy(kp.copy()),
            torch.from_numpy(vp.copy()))
    assert tl.shape == (B, V) and isinstance(tk, list) and len(tk) == TP
    _close(tl.numpy(), np.asarray(jl))
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    live = [3, 7, 5]  # the trash block 0 takes the padding rows' writes
    for got, want in ((tk, jk), (tv, jv)):
        _close(torch.cat(got, 3).numpy()[:, live],
                                   np.asarray(want)[:, live])
    _close(tl.numpy(), sl.numpy())
    assert tl.argmax(-1).tolist() == sl.argmax(-1).tolist()
    _close(torch.cat(tk, 3).numpy(), sk.numpy())
    _close(torch.cat(tv, 3).numpy(), sv.numpy())


@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_tail_prefill_matches_reference_and_one_device(gpt, llama, mesh,
                                                          kind):
    """A 16-token tail at positions 8.. and 16.. over blocks already in the
    pool (a cached prefix, or earlier chunks)."""
    (jkey, jarch, jparams, _), (tkey, tarch, tparams, _) = _states(
        _model(kind, gpt, llama), kind)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    V = tparams["wte"].shape[0]
    rng = np.random.RandomState(11)
    B, T, NB = 2, 16, 24
    shape = (L, NB, BS, KV, D)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    ids = rng.randint(0, V, (B, T)).astype(np.int32)
    starts = np.array([8, 16], np.int32)
    lens = np.array([16, 9], np.int32)
    tables = rng.permutation(np.arange(1, NB))[:B * 6].reshape(B, 6) \
        .astype(np.int32)
    jp, jvocab = _jpacked(jkey, jparams, mesh)
    pool_s = JG.tp_pool_sharding(mesh)
    jk, jv, jl = jax.jit(JG.build_tp_paged_tail_prefill(
        jkey, B, T, BS, 6, mesh, jvocab, jnp.float32))(
            jp, *map(jnp.asarray, (ids, starts, lens, tables)),
            jax.device_put(jnp.asarray(kp), pool_s),
            jax.device_put(jnp.asarray(vp), pool_s))
    packed, vocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    args = tuple(map(torch.from_numpy, (ids, starts, lens, tables)))
    with torch.inference_mode():
        tk, tv, tl = TG.build_tp_paged_tail_prefill(
            tkey, B, T, BS, 6, [CPU] * TP, vocab, torch.float32)(
                packed, *args, _shards(kp), _shards(vp))
        sk, sv, sl = TG.build_paged_tail_prefill(tarch, B, T, BS, 6)(
            tparams, *args, torch.from_numpy(kp.copy()),
            torch.from_numpy(vp.copy()))
    _close(tl.numpy(), np.asarray(jl))
    assert tl.argmax(-1).tolist() == np.asarray(jl).argmax(-1).tolist()
    for got, want in ((tk, jk), (tv, jv)):
        _close(torch.cat(got, 3).numpy(),
                                   np.asarray(want))
    _close(tl.numpy(), sl.numpy())
    assert tl.argmax(-1).tolist() == sl.argmax(-1).tolist()
    _close(torch.cat(tk, 3).numpy(), sk.numpy())
    _close(torch.cat(tv, 3).numpy(), sv.numpy())


@pytest.mark.parametrize("kernel", [False, True], ids=["gather", "kernel"])
@pytest.mark.parametrize("kind", ["gpt", "llama"])
def test_tp_decode_matches_reference_and_one_device(gpt, llama, mesh, kind,
                                                    kernel):
    """Three greedy decode steps at per-row positions; the kernel path runs
    the port's plain paged read on the CPU and the reference's Pallas
    kernel in interpret mode."""
    (jkey, jarch, jparams, _), (tkey, tarch, tparams, _) = _states(
        _model(kind, gpt, llama), kind)
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    V = tparams["wte"].shape[0]
    B, NB = 4, 24
    rng = np.random.RandomState(1)
    shape = (L, NB, BS, KV, D)
    kp = rng.randn(*shape).astype(np.float32)
    vp = rng.randn(*shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB) \
        .astype(np.int32)
    pos = np.array([3, 8, 17, 27], np.int32)
    toks = rng.randint(0, V, (B,)).astype(np.int32)
    temps = np.zeros((B,), np.float32)
    jp, jvocab = _jpacked(jkey, jparams, mesh)
    pool_s = JG.tp_pool_sharding(mesh)
    jstep = jax.jit(JG.build_tp_paged_decode(
        jkey, B, BS, MB, mesh, jvocab, jnp.float32, use_kernel=kernel))
    packed, vocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    tstep = TG.build_tp_paged_decode(tkey, B, BS, MB, [CPU] * TP, vocab,
                                     torch.float32, use_kernel=kernel)
    one = (TG.build_paged_decode_kernel if kernel
           else TG.build_paged_decode)(tarch, B, BS, MB)
    jk = jax.device_put(jnp.asarray(kp), pool_s)
    jv = jax.device_put(jnp.asarray(vp), pool_s)
    tk, tv = _shards(kp), _shards(vp)
    sk, sv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    jt = tt = toks
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        p = torch.from_numpy(pos + step)
        args = (torch.from_numpy(tables), p, torch.from_numpy(tt))
        with torch.inference_mode():
            tl = tstep.logits(packed, tk, tv, *args)
            sl = one.logits(tparams, sk, sv, *args)
        _close(tl.numpy(), sl.numpy())
        assert tl.argmax(-1).tolist() == sl.argmax(-1).tolist(), step
        _close(torch.cat(tk, 3).numpy(), sk.numpy())
        jk, jv, jn = jstep(jp, jk, jv, jnp.asarray(tables),
                           jnp.asarray(pos + step), jnp.asarray(jt),
                           jnp.asarray(temps), jax.random.PRNGKey(step))
        jt, tt = np.asarray(jn), tl.argmax(-1).to(torch.int32).numpy()
        assert tt.tolist() == jt.tolist(), step
    for got, want in ((tk, jk), (tv, jv)):
        _close(torch.cat(got, 3).numpy(),
                                   np.asarray(want))
    # the full step (sampling included) returns the shards' pools
    with torch.inference_mode():
        rk, rv, nxt = tstep(packed, tk, tv, torch.from_numpy(tables),
                            torch.from_numpy(pos + 3),
                            torch.from_numpy(tt), torch.from_numpy(temps),
                            gen)
    assert rk is tk and rv is tv and nxt.dtype == torch.int32


def test_tp_int8_wire_gather_counts_its_bytes(gpt):
    """The int8 wire's bytes a decode step equal ``tp_collective_bytes``'s
    int8 figure at the step's batch, and the f32 wire's its f32 figure."""
    (_, _, _, _), (tkey, tarch, tparams, _) = _states(gpt, "gpt")
    L, KV, D = len(tparams["layers"]), tarch["kv_heads"], tarch["head_dim"]
    B, NB = 4, 24
    rng = np.random.RandomState(2)
    shape = (L, NB, BS, KV, D)
    kp = rng.randn(*shape).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB) \
        .astype(np.int32)
    args = tuple(map(torch.from_numpy, (
        tables, np.array([3, 8, 17, 27], np.int32),
        rng.randint(0, 211, (B,)).astype(np.int32))))
    packed, vocab = TG.tp_pack_params(tkey, tparams, TP, [CPU] * TP)
    want = TG.tp_collective_bytes(tkey, tparams, B, TP)
    for i, wire in enumerate((False, True)):
        step = TG.build_tp_paged_decode(tkey, B, BS, MB, [CPU] * TP, vocab,
                                        torch.float32, int8_wire=wire)
        c0 = profiler.counters().get("serve_tp_gather_bytes", 0)
        with torch.inference_mode():
            step.logits(packed, _shards(kp), _shards(kp), *args)
        got = profiler.counters()["serve_tp_gather_bytes"] - c0
        assert got == want[i], (wire, got, want)


# ---------------------------------------------------------------- the engine
def _run(model, prompts, max_new=8, **kw):
    with Engine(model, **dict(KW, **kw)) as eng:
        hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        return [h.result(timeout=120) for h in hs]


def _jrun(model, prompts, max_new=8, **kw):
    with JEngine(model, **dict(ENGINE_KW, **kw)) as eng:
        hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
        return [h.result(timeout=300) for h in hs]


@pytest.mark.parametrize("prefix, kernel", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["gather", "paged_kernel", "prefix-gather", "prefix-paged_kernel"])
def test_gpt_tp2_tokens_equal_tp1_and_reference(gpt, prefix, kernel):
    rng = np.random.RandomState(3)
    stem = rng.randint(0, 211, (16,)).tolist()
    prompts = make_prompts(4, rng) + [stem + make_prompts(1, rng)[0]
                                      for _ in range(2)]
    with serve_flags(FLAGS_serve_paged_kernel=kernel,
                     FLAGS_serve_prefix_cache=prefix):
        base = _run(gpt[1], prompts)
        assert _run(gpt[1], prompts, tp=TP) == base
        assert _jrun(gpt[0], prompts, tp=TP) == base


def test_gpt_tp2_chunked_prefill_equals_monolithic(gpt):
    rng = np.random.RandomState(13)
    prompts = [rng.randint(0, 211, (int(n),)).tolist() for n in (48, 9, 25)]
    base = _run(gpt[1], prompts)
    assert _run(gpt[1], prompts, tp=TP, prefill_chunk=8) == base
    with serve_flags(FLAGS_serve_prefix_cache=True):
        assert _run(gpt[1], prompts, tp=TP, prefill_chunk=16) == base


@pytest.mark.parametrize("kernel", [False, True],
                         ids=["gather", "paged_kernel"])
def test_llama_gqa_tp2_tokens_equal_tp1_and_reference(llama, kernel):
    prompts = make_prompts(4, np.random.RandomState(5))
    with serve_flags(FLAGS_serve_paged_kernel=kernel,
                     FLAGS_serve_prefix_cache=True):
        base = _run(llama[1], prompts)
        assert _run(llama[1], prompts, tp=TP) == base
        assert _jrun(llama[0], prompts, tp=TP) == base


def test_tp_composes_with_engine_int8(gpt):
    """The int8-tagged tree shards on its int8 bytes (per-tensor scales:
    slice-then-dequantize is dequantize-then-slice), so a quantized engine's
    tokens do not change with tp."""
    prompts = make_prompts(4, np.random.RandomState(6))
    assert _run(gpt[1], prompts, tp=TP, int8=True) \
        == _run(gpt[1], prompts, int8=True)


def test_tp_int8_wire_completes_every_stream(gpt):
    """The quantized wire is lossy: every stream completes at its length,
    with no bit-identity promise."""
    prompts = make_prompts(4, np.random.RandomState(4))
    outs = _run(gpt[1], prompts, tp=TP, tp_int8=True)
    assert [len(o) for o in outs] == [len(p) + 8 for p in prompts]
    assert [o[:len(p)] for o, p in zip(outs, prompts)] == prompts


def test_flag_routes_to_the_tp_builders(gpt, monkeypatch):
    calls = {"decode": 0, "prefill": 0}
    for name, kind in (("build_tp_paged_decode", "decode"),
                       ("build_tp_paged_prefill", "prefill")):
        real = getattr(TG, name)

        def spy(*a, _real=real, _kind=kind, **k):
            calls[_kind] += 1
            return _real(*a, **k)

        monkeypatch.setattr(TG, name, spy)
    prompts = make_prompts(3, np.random.RandomState(8))
    with serve_flags(FLAGS_serve_tp=TP):
        with Engine(gpt[1], **KW) as eng:
            assert eng._tp == TP and eng.config.tp == TP
            outs = [h.result(timeout=60) for h in
                    [eng.submit(p, max_new_tokens=6) for p in prompts]]
            assert isinstance(eng._kpool, list) and len(eng._kpool) == TP
            assert eng._flight_context()["tp"] == TP
    assert calls["decode"] >= 1 and calls["prefill"] >= 1
    assert outs == _run(gpt[1], prompts, max_new=6)


def test_unconfigured_engine_never_reaches_a_tp_builder(gpt, monkeypatch):
    def explode(*a, **k):
        raise AssertionError("tp builder reached by an unconfigured engine")

    for name in ("build_tp_paged_decode", "build_tp_paged_prefill",
                 "build_tp_paged_tail_prefill", "tp_pack_params",
                 "tp_collective_bytes"):
        monkeypatch.setattr(TG, name, explode)
    prompts = make_prompts(3, np.random.RandomState(9))
    with serve_flags(FLAGS_serve_prefix_cache=True):
        with Engine(gpt[1], **dict(KW, prefill_chunk=8)) as eng:
            outs = [h.result(timeout=60) for h in
                    [eng.submit(p, max_new_tokens=6) for p in prompts]]
            assert eng._tp == 0 and not isinstance(eng._kpool, list)
            assert eng._flight_context()["tp"] == 0
            assert eng._compat_key()[-2:] == (0, "replicated")
            assert eng._step_floor_s == 0.0
    assert all(len(o) == len(p) + 6 for o, p in zip(outs, prompts))


def test_tp_validation_messages(gpt, monkeypatch):
    with pytest.raises(ValueError, match="divide"):
        Engine(gpt[1], **dict(KW, tp=4))  # 4 does not divide H = 2
    with pytest.raises(ValueError, match="speculative"):
        Engine(gpt[1], **dict(KW, tp=TP, spec_k=2))
    with pytest.raises(ValueError, match="tp must be >= 0"):
        EngineConfig(tp=-1).resolve(128)
    with pytest.raises(ValueError, match="devices given"):
        Engine(gpt[1], **dict(KW, tp=TP, device=("cpu",)))
    # the default placement is the first tp CUDA devices: a card with one
    # device cannot take two shards (checked before any weight moves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds"):
        Engine(gpt[1], **dict(ENGINE_KW, tp=TP, device="cuda:0"))


def test_explicit_device_sequence_places_each_shard(gpt):
    prompts = make_prompts(3, np.random.RandomState(10))
    with Engine(gpt[1], **dict(KW, tp=TP, device=("cpu", "cpu"))) as eng:
        assert [p.device.type for p in eng._kpool] == ["cpu", "cpu"]
        assert all(p.is_contiguous() for p in eng._kpool + eng._vpool)
        assert eng._kpool[0].shape[3] == 1  # KV 2 over 2 shards
        outs = [h.result(timeout=60) for h in
                [eng.submit(p, max_new_tokens=6) for p in prompts]]
    assert outs == _run(gpt[1], prompts, max_new=6)


def test_step_floor_from_the_collective_bytes(gpt):
    from paddle_tpu_torch.cost_model import CostModel

    (_, _, _, _), (tkey, _, tparams, _) = _states(gpt, "gpt")
    for wire in (False, True):
        with Engine(gpt[1], **dict(KW, tp=TP, tp_int8=wire)) as eng:
            b = TG.tp_collective_bytes(tkey, tparams, eng.config.max_batch,
                                       TP)[int(wire)]
            want = CostModel("cpu").kernel_estimate(
                "tp_collective", (b, TP), {}) / 1e3
            assert eng._step_floor_s == pytest.approx(want) and want > 0


# --------------------------------------------------------------- durability
def _mid_decode(eng, steps=2):
    wait_for(lambda: eng.stats()["decode_steps"] >= steps, 30,
             "decode never started")


def test_snapshot_geometry_refuses_cross_tp_and_reattaches_same_tp(gpt):
    prompts = make_prompts(5, np.random.RandomState(30))
    want = _run(gpt[1], prompts, max_new=10)
    with chaos("serve.slow_step:at=1,ms=200"):
        old = Engine(gpt[1], **dict(KW, tp=TP))
        hs = [old.submit(p, max_new_tokens=10) for p in prompts]
        _mid_decode(old)
        snap = old.handoff()
    old.close()
    assert tuple(snap["compat"])[-2:] == (TP, "kv-shard/tp")
    # the tp = 1 engine's checksum of each block equals the shards' one
    one = TG.kv_block_checksums(torch.cat(snap["kpool"], 3),
                                torch.cat(snap["vpool"], 3),
                                snap["fingerprint"]["bids"])
    assert np.array_equal(one, snap["fingerprint"]["sums"])
    with Engine(gpt[1], **KW) as single:
        with pytest.raises(SnapshotError, match="geometry"):
            single.adopt(snap, fallback="raise")
    with Engine(gpt[1], **dict(KW, tp=TP)) as new:
        info = new.adopt(snap)
        assert info["mode"] == "reattach" and info["reprefill_tokens"] == 0
        assert new._kpool is snap["kpool"]
        outs = [h.result(timeout=60) for h in hs]
    assert outs == want


def test_cross_tp_adopt_falls_back_to_reprefill(gpt):
    prompts = make_prompts(4, np.random.RandomState(31))
    want = _run(gpt[1], prompts, max_new=10)
    with chaos("serve.slow_step:at=1,ms=200"):
        old = Engine(gpt[1], **KW)
        hs = [old.submit(p, max_new_tokens=10) for p in prompts]
        _mid_decode(old)
        snap = old.handoff()
    old.close()
    with Engine(gpt[1], **dict(KW, tp=TP)) as new:
        info = new.adopt(snap)
        assert info["mode"] == "reprefill" and "geometry" in \
            info["reject_reason"]
        outs = [h.result(timeout=60) for h in hs]
    assert outs == want


def test_supervised_restart_keeps_tp_and_placement(gpt):
    """A crash at a fixed decode step under a snapshotting supervisor: the
    restarted engine is built at the same tp over the same devices, the
    snapshot re-attaches, and the outputs are the uninterrupted run's."""
    prompts = make_prompts(5, np.random.RandomState(20))
    want = _run(gpt[1], prompts, max_new=10)
    spec = "serve.slow_step:at=1,ms=200;serve.crash:step=4,times=1"
    with chaos(spec):
        with ServingSupervisor(gpt[1], watchdog_s=4.0, snapshot=True,
                               **dict(KW, tp=TP)) as sup:
            first = sup._engine
            hs = [sup.submit(p, max_new_tokens=10) for p in prompts]
            outs = [h.result(timeout=120) for h in hs]
            assert sup.restarts == 1
            eng = sup._engine
            assert eng is not first and eng._tp == TP
            assert eng._tp_devices == first._tp_devices
            assert sup.health()["last_recovery"]["mode"] == "reattach"
    assert outs == want


def test_tp_debug_step_holds_the_shard_kernel_to_its_plain_form(gpt):
    """The engine's own kernel-against-plain step check at tp (on the CPU
    both run the plain paged read: the logits are equal)."""
    prompts = make_prompts(3, np.random.RandomState(12))
    with serve_flags(FLAGS_serve_paged_kernel=True):
        with Engine(gpt[1], **dict(KW, tp=TP)) as eng:
            kl, pl = eng._debug_step_logits(prompts)
    assert kl.shape == (3, 211) and np.array_equal(kl, pl)
