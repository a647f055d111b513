"""Port parity: ``paddle_tpu_torch.ops.fused_ce`` against the JAX package's
``fused_linear_cross_entropy`` (loss, dx and dW), and the hard-label
``cross_entropy`` against the reference's.

Inputs are numpy f32 made from a seed; rows at ``ignore_index`` (and a
negative label) are left out. f32 on the CPU: the two differ by summation
order only (rtol 1e-5 for the loss, atol 1e-6 on gradients of size ~1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jfce
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy


def _inputs(N, d=24, V=97, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, d).astype(np.float32)
    w = (0.3 * rng.randn(V, d)).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int64)
    labels[::7] = -100  # ignore_index rows
    labels[3] = -5      # a negative label counts as invalid too
    return x, w, labels


@pytest.mark.parametrize("N,block_rows", [(64, 2048), (50, 16), (37, 8)],
                         ids=["one_block", "ragged_last_block", "small_blocks"])
def test_loss_and_grads_match_reference(N, block_rows):
    x, w, labels = _inputs(N)
    (ref_loss, (ref_dx, ref_dw)) = jax.value_and_grad(
        lambda x, w: jfce(x, w, jnp.asarray(labels.astype(np.int32)),
                          block_rows=block_rows),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                      block_rows=block_rows)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref_dx),
                               atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_dw),
                               atol=1e-6, rtol=1e-4)


def test_fused_equals_unfused_cross_entropy_on_flattened_batch():
    x, w, labels = _inputs(48, seed=2)
    x3 = torch.from_numpy(x).reshape(2, 24, -1)
    lab = torch.from_numpy(labels).reshape(2, 24)
    lab[lab < 0] = -100
    fused = TF.fused_linear_cross_entropy(x3, torch.from_numpy(w), lab)
    logits = x3.reshape(-1, x.shape[1]) @ torch.from_numpy(w).T
    plain = TF.cross_entropy(logits, lab.reshape(-1))
    np.testing.assert_allclose(float(fused), float(plain), rtol=1e-5)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_reference(reduction):
    rng = np.random.RandomState(4)
    logits = rng.randn(30, 11).astype(np.float32)
    labels = rng.randint(0, 11, 30).astype(np.int64)
    labels[::5] = -100
    ref = JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(labels),
                           reduction=reduction)
    out = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           reduction=reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.numpy()),
                               atol=1e-6, rtol=1e-5)


def test_rejects_bad_shapes():
    x, w, labels = _inputs(8)
    with pytest.raises(ValueError, match="fused_linear_cross_entropy"):
        fused_linear_cross_entropy(torch.from_numpy(x),
                                   torch.from_numpy(w[:, :5]),
                                   torch.from_numpy(labels))
