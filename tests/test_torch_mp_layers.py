"""Port parity: the single-device model-parallel layers
(``paddle_tpu_torch.distributed.fleet.meta_parallel``) and the single-rank
helper collectives (``paddle_tpu_torch.distributed.collective``) against the
reference's, on the same weights and inputs (numpy, from a seed).

Forward outputs and input/weight gradients in f32 within rtol = atol = 1e-5
(the matmuls sum in another order); parameter names and shapes equal; a
group of more than one rank without a process group raises (the sharded
layers over a real group: tests/test_torch_tensor_parallel.py).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import collective as jcol
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as jmp
from paddle_tpu_torch.distributed import collective as tcol
from paddle_tpu_torch.distributed.fleet import meta_parallel as tmp
from paddle_tpu_torch.models import load_reference_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)

LAYERS = {
    "column_bias": (lambda m, **k: m.ColumnParallelLinear(
        6, 10, has_bias=True, gather_output=True, **k), (3, 4, 6), "float"),
    "column_nobias": (lambda m, **k: m.ColumnParallelLinear(
        6, 10, gather_output=False, **k), (3, 4, 6), "float"),
    "row_bias": (lambda m, **k: m.RowParallelLinear(
        10, 6, has_bias=True, input_is_parallel=True, **k), (3, 4, 10),
        "float"),
    "row_split": (lambda m, **k: m.RowParallelLinear(
        10, 6, has_bias=False, input_is_parallel=False, **k), (3, 4, 10),
        "float"),
    "vocab_embedding": (lambda m, **k: m.VocabParallelEmbedding(50, 8, **k),
                        (3, 7), "ids"),
}


def _inputs(kind, shape, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "ids":
        return rng.randint(0, 50, shape).astype(np.int64)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_reference(name):
    make, shape, kind = LAYERS[name]
    jl = make(jmp)
    tl = make(tmp, device="cpu")
    state = {k: np.asarray(v, np.float32) for k, v in jl.state_dict().items()}
    assert sorted(state) == sorted(dict(tl.named_parameters()))
    load_reference_state_dict(tl, state)
    x = _inputs(kind, shape)
    jx = paddle.to_tensor(x)
    tx = torch.from_numpy(x)
    if kind == "float":
        jx.stop_gradient = False
        tx.requires_grad_()
    jy = jl(jx)
    ty = tl(tx)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               **TOL)
    cot = np.random.RandomState(1).randn(*ty.shape).astype(np.float32)
    (jy * paddle.to_tensor(cot)).sum().backward()
    (ty * torch.from_numpy(cot)).sum().backward()
    for n, p in tl.named_parameters():
        jp = dict(jl.named_parameters())[n]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp.grad.numpy()),
                                   err_msg=n, **TOL)
    if kind == "float":
        np.testing.assert_allclose(tx.grad.numpy(),
                                   np.asarray(jx.grad.numpy()), **TOL)


def test_default_init_is_xavier_weight_and_zero_bias():
    g = torch.Generator().manual_seed(0)
    layer = tmp.ColumnParallelLinear(64, 96, has_bias=True, device="cpu",
                                     generator=g)
    limit = np.sqrt(6.0 / (64 + 96))
    w = layer.weight.detach().numpy()
    assert w.shape == (64, 96) and np.abs(w).max() <= limit
    assert np.abs(w).max() > 0.9 * limit
    assert not layer.bias.detach().numpy().any()
    assert tmp.RowParallelLinear(4, 3, device="cpu").bias is not None
    assert tmp.ColumnParallelLinear(4, 3, device="cpu").bias is None


def test_parallel_cross_entropy_matches_reference():
    rng = np.random.RandomState(2)
    logits = rng.randn(4, 5, 11).astype(np.float32)
    labels = rng.randint(0, 11, (4, 5)).astype(np.int64)
    labels[0, :2] = -100
    want = jmp.ParallelCrossEntropy()(paddle.to_tensor(logits),
                                      paddle.to_tensor(labels))
    got = tmp.ParallelCrossEntropy()(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert tuple(got.shape) == tuple(want.shape) == (4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **TOL)
    assert not got[0, :2].any()


@pytest.mark.parametrize("fn", ["_c_identity", "_mp_allreduce", "_c_split",
                                "_c_concat"])
def test_single_rank_collectives_are_identities(fn):
    x = np.random.RandomState(3).randn(2, 6).astype(np.float32)
    want = getattr(jcol, fn)(paddle.to_tensor(x))
    got = getattr(tcol, fn)(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    one = SimpleNamespace(nranks=1)
    np.testing.assert_array_equal(getattr(tcol, fn)(torch.from_numpy(x),
                                                    one).numpy(), x)


@pytest.mark.parametrize("fn", ["_c_identity", "_mp_allreduce", "_c_split",
                                "_c_concat", "_c_softmax_with_cross_entropy"])
def test_larger_group_raises(fn):
    """Over two ranks the layers hold their shards and the helpers run on
    the group's process group (parity: tests/test_torch_tensor_parallel.py);
    a group of two ranks that has no process group (the reference's
    GSPMD-partitioned axis) still raises, in the helper and in the layer."""
    group = SimpleNamespace(nranks=2, rank=0)
    x = torch.zeros(2, 4)
    args = (x, torch.zeros(2, dtype=torch.long)) \
        if fn == "_c_softmax_with_cross_entropy" else (x,)
    with pytest.raises(NotImplementedError, match="no process group"):
        getattr(tcol, fn)(*args, group)
    layer = tmp.ColumnParallelLinear(4, 6, mp_group=group, device="cpu")
    assert tuple(layer.weight.shape) == (4, 3) and layer.weight.mp_distributed
    with pytest.raises(NotImplementedError, match="no process group"):
        layer(torch.zeros(2, 4))
