"""Port parity of ``paddle_tpu_torch.sparse`` against the JAX package's
``paddle_tpu.sparse``, on the same numpy inputs from a seed: building COO
and CSR tensors, their accessors (``indices()``, ``values()``,
``crows()``, ``cols()``, ``nnz()``, ``coalesce()``), the conversions, and
``add``, ``multiply``, ``matmul``, ``masked_matmul``, the unary ops,
``softmax`` and ``SelectedRows``; results are compared dense.

float32 values rtol 1e-5, atol 1e-6; indices exactly; dtypes by name. The
gradient of ``matmul`` with respect to its dense operand (the reference's
result is off its tape) is held to the dense product's at the same
tolerance.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.sparse as RSP
import paddle_tpu_torch as tp
import paddle_tpu_torch.sparse as PSP
from torch_port_util import assert_same, cpu_device, public_names


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
DENSE = (_R.randn(5, 6) * (_R.rand(5, 6) > 0.6)).astype(np.float32)
DENSE2 = (_R.randn(5, 6) * (_R.rand(5, 6) > 0.5)).astype(np.float32)
D3 = (_R.randn(2, 3, 4) * (_R.rand(2, 3, 4) > 0.4)).astype(np.float32)
Y = _R.randn(6, 3).astype(np.float32)
IDX = np.array([[0, 1, 1, 4, 0], [2, 0, 3, 5, 2]], np.int64)  # a duplicate
VALS = np.array([1.0, 2.0, -1.0, 3.0, 0.5], np.float32)


def _both(fn):
    return fn(paddle, RSP), fn(tp, PSP)


def _dense_same(got, want, **kw):
    g = got.to_dense() if isinstance(got, PSP.SparseTensor) else got
    w = want.to_dense() if isinstance(want, RSP.SparseTensor) else want
    assert_same(g, w, **kw)


def test_coo_from_indices_keeps_duplicates_until_coalesce():
    want, got = _both(lambda pk, sp: sp.sparse_coo_tensor(
        pk.to_tensor(IDX), pk.to_tensor(VALS), [5, 6]))
    assert got.shape == want.shape == [5, 6] and got.nnz() == want.nnz()
    assert_same(got.indices(), want.indices())
    assert_same(got.values(), want.values())
    _dense_same(got, want)
    _dense_same(got.coalesce(), want.coalesce())
    assert got.coalesce().nnz() == want.coalesce().nnz() == 4
    # shape from the indices when none is given
    assert PSP.sparse_coo_tensor(tp.to_tensor(IDX),
                                 tp.to_tensor(VALS)).shape == [5, 6]


def test_csr_accessors_and_conversions():
    want, got = _both(lambda pk, sp: sp.to_sparse_csr(pk.to_tensor(DENSE)))
    assert_same(got.crows(), want.crows())
    assert_same(got.cols(), want.cols())
    assert_same(got.values(), want.values())
    _dense_same(got, want)
    assert got.is_sparse_csr() and got.nnz() == want.nnz()
    w2, g2 = want.to_sparse_coo(), got.to_sparse_coo()
    assert_same(g2.indices(), w2.indices())
    _dense_same(g2, w2)
    built = PSP.sparse_csr_tensor(got.crows(), got.cols(), got.values(),
                                  [5, 6])
    _dense_same(built, want)
    coo = PSP.to_sparse_coo(tp.to_tensor(DENSE))
    _dense_same(coo.to_sparse_csr(), want)


def test_dense_ops_on_a_sparse_tensor_raise():
    s = PSP.to_sparse_coo(tp.to_tensor(DENSE))
    with pytest.raises(TypeError):
        s + s
    with pytest.raises(TypeError):
        s.sum()


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_add_multiply_matmul(fmt):
    conv = "to_sparse_" + fmt
    for op in ("add", "multiply"):
        want, got = _both(lambda pk, sp: getattr(sp, op)(
            getattr(sp, conv)(pk.to_tensor(DENSE)),
            getattr(sp, conv)(pk.to_tensor(DENSE2))))
        _dense_same(got, want)
        assert isinstance(got, PSP.SparseCooTensor)
    want, got = _both(lambda pk, sp: sp.add(
        getattr(sp, conv)(pk.to_tensor(DENSE)), pk.to_tensor(DENSE2)))
    _dense_same(got, want)
    want, got = _both(lambda pk, sp: sp.multiply(
        getattr(sp, conv)(pk.to_tensor(DENSE)), pk.to_tensor(DENSE2)))
    _dense_same(got, want)
    want, got = _both(lambda pk, sp: sp.matmul(
        getattr(sp, conv)(pk.to_tensor(DENSE)), pk.to_tensor(Y)))
    assert_same(got, want)


def test_matmul_gradient_wrt_the_dense_operand():
    ty = tp.to_tensor(Y, stop_gradient=False)
    (PSP.matmul(PSP.to_sparse_coo(tp.to_tensor(DENSE)), ty) ** 2) \
        .sum().backward()
    want = DENSE.T @ (2 * (DENSE @ Y))
    np.testing.assert_allclose(ty.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_masked_matmul(monkeypatch):
    x = _R.randn(5, 4).astype(np.float32)
    y = _R.randn(4, 6).astype(np.float32)
    monkeypatch.setattr(PSP, "MASKED_CHUNK", 3)  # several chunks
    want, got = _both(lambda pk, sp: sp.masked_matmul(
        pk.to_tensor(x), pk.to_tensor(y),
        sp.to_sparse_csr(pk.to_tensor(DENSE))))
    _dense_same(got, want)
    np.testing.assert_allclose(got.to_dense().numpy(),
                               (x @ y) * (DENSE != 0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("op", ["relu", "sin", "tanh", "sqrt", "abs", "neg",
                                "pow", "cast"])
def test_unary_ops_keep_the_pattern(op):
    src = np.abs(DENSE) if op == "sqrt" else DENSE
    args = {"pow": (2.0,), "cast": (None, "float64")}.get(op, ())
    want, got = _both(lambda pk, sp: getattr(sp, op)(
        sp.to_sparse_coo(pk.to_tensor(src)), *args))
    _dense_same(got, want)
    assert got.nnz() == want.nnz()


@pytest.mark.parametrize("src", [DENSE, D3], ids=["2d", "3d"])
def test_softmax_over_the_stored_entries(src):
    want, got = _both(lambda pk, sp: sp.softmax(
        sp.to_sparse_coo(pk.to_tensor(src))))
    _dense_same(got, want)


def test_selected_rows_merge_and_to_dense():
    rows = np.array([3, 1, 3, 0], np.int64)
    vals = _R.randn(4, 2).astype(np.float32)
    want, got = _both(lambda pk, sp: sp.SelectedRows(
        pk.to_tensor(rows), pk.to_tensor(vals), 5))
    assert_same(got.to_dense(), want.to_dense())
    jm, tm = want.merge(), got.merge()
    np.testing.assert_array_equal(tm.rows.numpy(), np.asarray(jm.rows))
    np.testing.assert_allclose(tm.value.numpy(), np.asarray(jm.value),
                               rtol=1e-5, atol=1e-6)
    assert_same(tm.to_dense(), jm.to_dense())


def test_the_module_holds_the_reference_names():
    ref = public_names(RSP.__file__)
    assert ref <= set(vars(PSP)), sorted(ref - set(vars(PSP)))
    assert isinstance(PSP.to_sparse_coo(tp.to_tensor(DENSE)).values(),
                      torch.Tensor)
