"""Port parity: ``paddle_tpu_torch.models.llama`` and the Llama serving
plug's numerics against the JAX Llama.

The JAX model's ``state_dict()`` is exported as numpy and loaded into the
port by name; both then see the same numpy-made token ids. Both configs run:
``llama_tiny()`` (4 heads, MHA) and ``llama_tiny(num_kv_heads=2)`` (GQA, rep
2). f32 on the CPU: logits within atol 1e-4 and the loss within 1e-5 (the
two frameworks sum in different orders), every gradient within rtol = atol
= 1e-4, and three compiled AdamW steps' losses within rtol 1e-4. The serving plug's RMS norm and
RoPE forms (``_rms``, ``_rope_at``, ``_rope_rows``) and the model's
``apply_rope`` agree with the reference's functions to 1e-6 in f32; in bf16
the serving forms agree bit for bit, and ``apply_rope`` (rotated in f32,
cast once) within one bf16 ulp with at least 99.9% of elements bit-equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.models.generation as JG
from paddle_tpu.models import llama as JL
from paddle_tpu_torch.models import (LlamaForCausalLM, apply_rope, llama_7b,
                                     llama_tiny)
from paddle_tpu_torch.models import generation as TG
from torch_port_util import port_of_llama

CONFIGS = {"mha": {}, "gqa": {"num_kv_heads": 2}}


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    paddle.seed(0)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(**CONFIGS[request.param]))
    jm.eval()
    return jm, port_of_llama(jm)


def _ids(V, seed, shape=(2, 19)):
    return np.random.RandomState(seed).randint(0, V, shape).astype(np.int32)


def test_parameter_names_and_shapes_match_reference(models):
    jm, tm = models
    ref = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} == ref
    kv = jm.model.config.kv_heads * 32
    assert ref["model.layers.0.self_attn.q_proj.weight"] == (128, 128)
    assert ref["model.layers.0.self_attn.k_proj.weight"] == (128, kv)
    assert ref["lm_head.weight"] == (128, 1024)
    # a fresh port model (its own random weights) has the same names
    fresh = LlamaForCausalLM(jm.model.config, device="cpu")
    assert {k: tuple(p.shape) for k, p in fresh.named_parameters()} == ref


def test_logits_match_reference(models):
    jm, tm = models
    ids = _ids(1024, 4)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    assert out.shape == ref.shape == (2, 19, 1024)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_loss_matches_reference(models):
    jm, tm = models
    ids, labels = _ids(1024, 5), _ids(1024, 6)
    ref = float(jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels)))
    with torch.no_grad():
        out = float(tm.loss(torch.from_numpy(ids).long(),
                            torch.from_numpy(labels).long()))
    assert abs(out - ref) <= 1e-5, (out, ref)


def test_gradients_match_reference(models):
    """Every parameter's gradient of the mean loss, GQA's K/V projections
    included (their gradient sums over each KV head's query heads), within
    rtol = atol = 1e-4."""
    jm, tm = models
    ids, labels = _ids(1024, 7), _ids(1024, 8)
    jm.clear_gradients()
    jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels)).backward()
    tm.zero_grad(set_to_none=True)
    tm.loss(torch.from_numpy(ids).long(),
            torch.from_numpy(labels).long()).backward()
    jg = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[n].numpy()),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("kv", [None, 2], ids=["mha", "gqa"])
def test_compiled_train_step_matches_reference(kv):
    """Three ``compile_train_step`` steps with AdamW(1e-3) from the same
    weights on one batch: the losses within rtol 1e-4 (the gradients'
    1e-4 carries into each update) and falling."""
    import paddle_tpu_torch as tp

    paddle.seed(1)
    jm = JL.LlamaForCausalLM(JL.llama_tiny(num_kv_heads=kv))
    tm = port_of_llama(jm).train()
    ids, labels = _ids(1024, 9), _ids(1024, 10)
    jstep = paddle.jit.compile_train_step(
        jm, lambda m, i, l: m.loss(i, l),
        paddle.optimizer.AdamW(1e-3, parameters=jm.parameters()))
    tstep = tp.jit.compile_train_step(
        tm, lambda m, i, l: m.loss(i, l),
        tp.optimizer.AdamW(1e-3, parameters=tm.named_parameters()))
    want = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels)))
            for _ in range(3)]
    got = [float(tstep(torch.from_numpy(ids).long(),
                       torch.from_numpy(labels).long())) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def _rope_input(dtype, shape, seed, scale=1.0):
    x = (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _same(dtype, out, ref, min_equal=1.0):
    """f32: within 1e-6 (abs and rel; the two libraries' pow, cos, sin and
    means differ by an ulp). bf16: at least ``min_equal`` of the elements
    bit for bit, the rest within one bf16 ulp of the reference."""
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    assert out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
        return
    equal = float((out == ref).mean())
    assert equal >= min_equal, equal
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert (np.abs(out - ref) <= ulp).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_matches_reference(dtype):
    jx, tx = _rope_input(dtype, (3, 7, 128), 1, scale=2.0)
    jw, tw = _rope_input(dtype, (128,), 2)
    _same(dtype, TG._rms(tx, tw, 1e-6), JG._rms(jx, jw, 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos0", [0.0, 37.0])
def test_rope_at_matches_reference(dtype, pos0):
    jx, tx = _rope_input(dtype, (2, 64, 4, 128), 3)
    _same(dtype, TG._rope_at(tx, pos0, 10000.0),
          JG._rope_at(jx, jnp.float32(pos0), 10000.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_rows_matches_reference(dtype):
    jx, tx = _rope_input(dtype, (6, 1, 4, 128), 4)
    pos = np.array([0, 1, 15, 16, 1000, 2047], np.int32)
    _same(dtype, TG._rope_rows(tx, torch.from_numpy(pos), 10000.0),
          JG._rope_rows(jx, jnp.asarray(pos), 10000.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    jq, tq = _rope_input(dtype, (2, 48, 4, 32), 5)
    jk, tk = _rope_input(dtype, (2, 48, 2, 32), 6)
    rq, rk = JL.apply_rope(paddle.Tensor(jq), paddle.Tensor(jk))
    oq, ok = apply_rope(tq, tk)
    assert oq.dtype == tq.dtype and ok.dtype == tk.dtype
    # rotated in f32 and cast once: an f32 ulp of cos/sin can move an
    # element across a bf16 rounding boundary (1 of 6144 q elements here)
    _same(dtype, oq, rq._data, min_equal=0.999)
    _same(dtype, ok, rk._data, min_equal=0.999)


def test_llama_7b_shape():
    cfg = llama_7b()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.kv_heads,
            cfg.ffn_size, cfg.vocab_size) == (4096, 32, 32, 32, 11008, 32000)
    ref = JL.llama_7b()
    assert (cfg.ffn_size, cfg.max_position_embeddings) == (
        ref.ffn_size, ref.max_position_embeddings)


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(llama_tiny())
