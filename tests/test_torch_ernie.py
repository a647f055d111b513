"""Port parity: ``paddle_tpu_torch.models.ErnieForPretraining`` against the
reference's ``paddle_tpu.models.ernie.ErnieForPretraining``.

A tiny ERNIE (2 layers, hidden 32, 4 heads, vocab 97) with dropout 0 carries
the reference's weights by name (``tests/torch_port_util.port_of_ernie``);
the same ids, segment ids and labels (numpy, from a seed) go through both.
Tolerances, f32: MLM and NSP logits and the loss within rtol = atol = 1e-5,
every parameter's gradient within rtol = atol = 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.ernie import ErnieConfig as JConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JErnie
from paddle_tpu_torch.models import ErnieForPretraining, ernie_3_base
from torch_port_util import port_of_ernie

CFG = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, max_position_embeddings=64,
           hidden_dropout=0.0, attention_dropout=0.0)
B, T = 3, 12


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JErnie(JConfig(**CFG))
    return jm, port_of_ernie(jm)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (B, T)).astype(np.int64)
    types = rng.randint(0, 2, (B, T)).astype(np.int64)
    labels = np.full((B, T), -100, np.int64)
    pick = rng.rand(B, T) < 0.3
    labels[pick] = rng.randint(0, CFG["vocab_size"], pick.sum())
    nsp = rng.randint(0, 2, (B,)).astype(np.int64)
    return ids, types, labels, nsp


def test_forward_logits_match(models):
    jm, tm = models
    ids, types, _, _ = _batch()
    jmlm, jnsp = jm(paddle.to_tensor(ids), paddle.to_tensor(types))
    tmlm, tnsp = tm(torch.from_numpy(ids), torch.from_numpy(types))
    assert tuple(tmlm.shape) == (B, T, CFG["vocab_size"])
    assert tuple(tnsp.shape) == (B, 2)
    np.testing.assert_allclose(tmlm.detach().numpy(),
                               np.asarray(jmlm.numpy()), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tnsp.detach().numpy(),
                               np.asarray(jnsp.numpy()), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_nsp", [True, False], ids=["mlm_nsp", "mlm"])
def test_loss_and_gradients_match(models, with_nsp):
    jm, tm = models
    ids, _, labels, nsp = _batch(seed=1)
    assert (labels == -100).any() and (labels != -100).any()
    jargs = [paddle.to_tensor(ids), paddle.to_tensor(labels)]
    targs = [torch.from_numpy(ids), torch.from_numpy(labels)]
    if with_nsp:
        jargs.append(paddle.to_tensor(nsp))
        targs.append(torch.from_numpy(nsp))
    jm.clear_gradients()
    tm.zero_grad(set_to_none=True)
    jl = jm.loss(*jargs)
    jl.backward()
    tl = tm.loss(*targs)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5,
                               atol=1e-5)
    jgrads = {n: p.grad for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        if p.grad is None:  # the pooler and NSP head without NSP labels
            assert not with_nsp and n.split(".")[-2] in ("pooler",
                                                         "nsp_head"), n
            assert jgrads[n] is None or not np.asarray(
                jgrads[n].numpy()).any(), n
            continue
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[n].numpy()),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_ignored_labels_leave_the_loss():
    """Positions labelled -100 count nothing: the loss is the mean over the
    labelled positions only."""
    m = ErnieForPretraining(ernie_3_base(**CFG), device="cpu")
    ids, _, labels, _ = _batch(seed=2)
    base = m.loss(torch.from_numpy(ids), torch.from_numpy(labels)).item()
    mlm, _ = m(torch.from_numpy(ids))
    logp = torch.log_softmax(mlm, -1)
    keep = labels != -100
    want = -logp[torch.from_numpy(keep)].gather(
        -1, torch.from_numpy(labels[keep])[:, None]).mean().item()
    assert abs(base - want) < 1e-5


def test_attention_takes_the_exact_path(monkeypatch):
    """Bidirectional attention never reaches the flash wrapper."""
    import paddle_tpu_torch.nn.functional.attention as A

    def boom(*a, **k):
        raise AssertionError("flash called for a non-causal attention")

    monkeypatch.setattr(A, "flash_attention_array", boom)
    m = ErnieForPretraining(ernie_3_base(**CFG), device="cpu")
    m(torch.zeros(1, 4, dtype=torch.long))
