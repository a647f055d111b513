"""``paddle_tpu_torch.nn.functional``'s vision functions and
``sparse_attention`` against the JAX package's, on the same numpy inputs
from a seed: outputs and the gradients of a weighted sum of them.

``grid_sample`` runs both modes, the three padding modes and both corner
conventions, on an ``affine_grid`` that reaches outside the image;
``max_pool2d(return_mask=True)`` feeds ``max_unpool2d``; ``sparse_attention``
runs a banded CSR pattern per (batch, head). Tolerances: f32 rtol 1e-5,
atol 1e-6 (gradients atol 1e-5); integers exactly, int64 by name.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as TF
from torch_nn_util import A, check, function_of
from torch_port_util import cpu_device


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(5)
IMG = _R.randn(2, 3, 5, 6).astype(np.float32)
THETA = (np.array([[[1.1, 0.2, 0.1], [-0.1, 0.9, 0.2]],
                   [[0.8, -0.3, -0.2], [0.3, 1.2, 0.0]]], np.float32)
         + _R.randn(2, 2, 3).astype(np.float32) * 0.05)
GRID = (_R.rand(2, 4, 7, 2).astype(np.float32) * 2.6 - 1.3)


def _banded_csr(B, H, T, w):
    """Each row attends to itself and the ``w`` before it."""
    cols, offs = [], [0]
    for r in range(T):
        c = list(range(max(0, r - w), r + 1))
        cols += c
        offs.append(len(cols))
    off = np.tile(np.array(offs, np.int64), (B, H, 1))
    col = np.tile(np.array(cols, np.int64), (B, H, 1))
    return off, col


def _pooled():
    x = _R.randn(2, 3, 6, 8).astype(np.float32)
    out, mask = TF.max_pool2d(torch.tensor(x), 2,
                              return_mask=True)
    return out.numpy(), mask.numpy()


POOLED, MASK = _pooled()
X1 = _R.randn(2, 3, 6).astype(np.float32)
X3 = _R.randn(1, 2, 2, 2, 3).astype(np.float32)
OFF, COLS = _banded_csr(2, 2, 6, 2)

FUNCTIONS = {
    "affine_grid": ((A(THETA), [2, 3, 4, 7]), {}),
    "affine_grid_edges": ((A(THETA), [2, 3, 5, 3]),
                          {"align_corners": False}),
    "sequence_mask": ((A(np.array([3, 0, 5], np.int64)),), {}),
    "sequence_mask_maxlen": ((A(np.array([[1, 4], [2, 2]], np.int64)),),
                             {"maxlen": 6, "dtype": "float32"}),
    "temporal_shift": ((A(_R.randn(6, 8, 2, 2).astype(np.float32)), 3),
                       {"shift_ratio": 0.25}),
    "zeropad2d": ((A(IMG), [1, 2, 0, 3]), {}),
    "pairwise_distance": ((A(IMG[0, 0]), A(IMG[1, 1])), {}),
    "pairwise_distance_p3": ((A(IMG[0, 0]), A(IMG[1, 1])),
                             {"p": 3.0, "keepdim": True}),
    "npair_loss": ((A(_R.randn(6, 4).astype(np.float32)),
                    A(_R.randn(6, 4).astype(np.float32)),
                    A(np.array([0, 1, 0, 2, 1, 3], np.int64))), {}),
    "dice_loss": ((A(_R.dirichlet(np.ones(4), (3, 5)).astype(np.float32)),
                   A(_R.randint(0, 4, (3, 5, 1)).astype(np.int64))), {}),
    "gather_tree": ((A(_R.randint(0, 9, (5, 2, 3)).astype(np.int64)),
                     A(_R.randint(0, 3, (5, 2, 3)).astype(np.int64))), {}),
    "max_unpool2d": ((A(POOLED), A(MASK), 2), {}),
    "max_unpool2d_size": ((A(POOLED), A(MASK), 2),
                          {"stride": 2, "output_size": [7, 9]}),
    "max_unpool1d": ((A(X1), A(np.array([[[0, 3, 5, 6, 9, 10]] * 3] * 2,
                                        np.int64)), 2), {}),
    "max_unpool3d": ((A(X3), A(np.arange(12, dtype=np.int64).reshape(
        1, 1, 2, 2, 3).repeat(2, 1) * 5), 2), {}),
}


@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function(case):
    args, kw = FUNCTIONS[case]
    name = function_of(case, JF)
    check(getattr(JF, name), getattr(TF, name), args, kw, atol=1e-6,
          what=case)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(mode, padding_mode, align_corners):
    kw = {"mode": mode, "padding_mode": padding_mode,
          "align_corners": align_corners}
    check(JF.grid_sample, TF.grid_sample, (A(IMG), A(GRID)), kw, atol=1e-6,
          what=str(kw))


def test_grid_sample_on_an_affine_grid():
    def run(F, theta, x):
        return F.grid_sample(x, F.affine_grid(theta, [2, 3, 5, 4]))

    check(lambda t, x: run(JF, t, x), lambda t, x: run(TF, t, x),
          (A(THETA), A(IMG)))


def test_max_pool_mask_then_unpool():
    x = _R.randn(2, 3, 6, 8).astype(np.float32)

    def run(F, a):
        out, mask = F.max_pool2d(a, 2, 2, return_mask=True)
        return F.max_unpool2d(out, mask, 2, 2), mask

    check(lambda a: run(JF, a), lambda a: run(TF, a), (A(x),))


def test_sparse_attention():
    q, k, v = (_R.randn(2, 2, 6, 8).astype(np.float32) for _ in range(3))
    check(JF.sparse_attention, TF.sparse_attention,
          (A(q), A(k), A(v), A(OFF), A(COLS)), atol=1e-6)
