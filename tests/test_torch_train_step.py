"""Port parity of the training slice: ``GPTForPretraining.loss`` and its
gradients, and ``jit.compile_train_step`` with ``AdamW``, against the JAX
package on ``gpt_tiny`` in f32 with dropout 0.

The JAX model's weights are loaded into the port by name; token ids and
labels are numpy int64 from a seed. With ``attention_impl="flash"`` the
reference runs its Pallas kernels in interpret mode and the port its plain
flash version (the CPU has no card). Losses are compared, not parameters
after Adam steps: Adam's first step is close to lr * sign(g), so an element
whose gradient is near 0 may flip sign in a rounding and differ by lr.

Tolerances (f32, summation order only): loss rtol 1e-5; gradients
atol 2e-6 + rtol 1e-4 (entries are ~1e-3 to 1e-1); the 3-step loss
trajectory rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForPretraining as JGPT
from paddle_tpu.models.gpt import gpt_tiny as jgpt_tiny
from paddle_tpu_torch import jit as tjit
from paddle_tpu_torch import seed as tseed
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from torch_port_util import port_of

B, T = 2, 32


def _models(impl, fused):
    kw = dict(attention_impl=impl, fused_lm_loss=fused)
    paddle.seed(1)
    jm = JGPT(jgpt_tiny(hidden_dropout=0.0, attention_dropout=0.0, **kw))
    return jm, port_of(jm, **kw).train()


def _batch(seed=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (B, T)).astype(np.int64)
    labels = rng.randint(0, 1024, (B, T)).astype(np.int64)
    labels[0, :3] = -100  # ignored positions
    return ids, labels


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("impl", ["exact", "flash"])
def test_step0_loss_and_grads_match_reference(impl, fused):
    jm, tm = _models(impl, fused)
    ids, labels = _batch()
    jloss = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(labels))
    jloss.backward()
    want = {n: np.asarray(p.grad.numpy(), np.float32)
            for n, p in jm.named_parameters()}
    loss = tm.loss(torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss.numpy()), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert got.keys() == want.keys()
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=2e-6, rtol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("impl", ["exact", "flash"])
def test_train_step_loss_trajectory_matches_reference(impl):
    jm, tm = _models(impl, True)
    ids, labels = _batch(seed=3)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    jstep = paddle.jit.compile_train_step(jm, lambda m, i, l: m.loss(i, l),
                                          jopt)
    want = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(labels))
                  .numpy()) for _ in range(3)]
    topt_ = topt.AdamW(1e-3, parameters=tm.named_parameters())
    step = tjit.compile_train_step(tm, lambda m, i, l: m.loss(i, l), topt_)
    got = [step(ids, labels).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert step._step_count == 3 and topt_._step_count == 3


def test_train_step_returns_detached_loss_and_drops_grads():
    _, tm = _models("exact", True)
    ids, labels = _batch()
    opt = topt.SGD(1e-2, parameters=tm.parameters())
    step = tjit.compile_train_step(tm, lambda m, i, l: m.loss(i, l), opt)
    loss = step(torch.from_numpy(ids), torch.from_numpy(labels))
    assert loss.dim() == 0 and not loss.requires_grad
    assert all(p.grad is not None for p in tm.parameters())


def test_compile_train_step_without_device_raises_when_cuda_missing(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model = GPTForPretraining(gpt_tiny())
        tjit.compile_train_step(model, lambda m, i, l: m.loss(i, l),
                                topt.AdamW(1e-3,
                                           parameters=model.parameters()))


@pytest.mark.parametrize("impl,err", [("ring", NotImplementedError),
                                      ("bogus", ValueError)])
def test_attention_impl_checked(impl, err):
    with pytest.raises(err, match="A18" if impl == "ring" else "auto"):
        GPTForPretraining(gpt_tiny(attention_impl=impl), device="cpu")


def test_remat_replays_dropout_and_matches_no_remat():
    ids, labels = _batch()
    grads = []
    for remat in (False, True):
        m = GPTForPretraining(gpt_tiny(remat=remat, hidden_dropout=0.1,
                                       attention_dropout=0.1),
                              device="cpu").train()
        tseed(7)
        m.loss(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
