"""Port parity: ``paddle_tpu_torch.models.gpt`` against the JAX GPT.

The JAX model's ``state_dict()`` is exported as numpy and loaded into the
port by name (``load_reference_state_dict``); both then see the same token
ids, made with numpy. f32 on the CPU, logits within atol 1e-4 (the two
frameworks sum in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining,
                                     gpt_tiny, load_reference_state_dict)
from serving_util import tiny_gpt
from torch_port_util import port_of, reference_state


def _jax_gpt_tiny():
    paddle.seed(1)
    m = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0))
    m.eval()
    return m


@pytest.mark.parametrize("which", ["serving_tiny", "gpt_tiny"])
def test_logits_match_reference(which):
    jm = tiny_gpt(seed=0) if which == "serving_tiny" else _jax_gpt_tiny()
    tm = port_of(jm)
    V = jm.config.vocab_size
    ids = np.random.RandomState(4).randint(0, V, (2, 19)).astype(np.int32)
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids).long()).numpy()
    assert out.shape == ref.shape == (2, 19, V)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_parameter_names_and_shapes_match_reference():
    jm = _jax_gpt_tiny()
    tm = GPTForPretraining(gpt_tiny(), device="cpu")
    ref = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert {k: tuple(p.shape) for k, p in tm.named_parameters()} == ref
    assert ref["gpt.layers.0.attn.qkv.weight"] == (128, 384)
    assert ref["gpt.embeddings.word_embeddings.weight"] == (1024, 128)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_load_rejects_bad_state(fault):
    jm = tiny_gpt(seed=0)
    state = reference_state(jm)
    name = "gpt.layers.1.mlp.up.weight"
    if fault == "missing":
        del state[name]
    elif fault == "extra":
        state["gpt.layers.9.mlp.up.weight"] = state[name]
    elif fault == "shape":
        state[name] = state[name].T.copy()
    else:
        state[name] = state[name].astype(np.float64)
    tm = GPTForPretraining(GPTConfig(
        vocab_size=211, hidden_size=32, num_layers=2, num_heads=2,
        max_position_embeddings=128), device="cpu")
    before = tm.gpt.layers[0].attn.qkv.weight.detach().clone()
    with pytest.raises(ValueError, match="layers"):
        load_reference_state_dict(tm, state)
    # nothing was copied
    assert torch.equal(before, tm.gpt.layers[0].attn.qkv.weight)


def test_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForPretraining(gpt_tiny())
