"""Port parity of ``paddle_tpu_torch.ops.linalg`` (and the
``paddle_tpu_torch.linalg`` namespace) against the JAX package's, on the
same numpy inputs from a seed.

Unique results (``inv``, ``det``, ``slogdet``, ``solve``, the triangular
and Cholesky solves, ``pinv``, ``norm``, ``cond``, ``matrix_power``,
``matrix_rank``, ``lstsq``, ``lu``'s factor and pivots, ``cholesky``,
``multi_dot``, ``corrcoef``, ``cov``, ``householder_product``, the
eigenvalues and singular values) are held to the reference at rtol 1e-4,
atol 1e-5 in float32, integers exactly, dtypes by name. Factors that are
unique only up to signs or phases (``svd``'s U and V, ``qr``'s Q and R,
``eig``'s and ``eigh``'s vectors) are held by their identities:
U diag(S) Vᵀ = A, Q R = A with orthonormal Q and |diag R| the reference's,
A V = V diag(w), P L U = A; eigenvalues sorted before they are compared.
Gradients of ``det``, ``inv``, ``solve`` and ``cholesky`` are held to the
reference's tape at the same tolerance.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.linalg as RL
import paddle_tpu_torch as tp
import paddle_tpu_torch.linalg as PL
from torch_port_util import assert_same, cpu_device, flat_outputs


@pytest.fixture(autouse=True)
def cpu():
    with cpu_device():
        yield


_R = np.random.RandomState(0)
A = _R.randn(4, 4).astype(np.float32)
SPD = (A @ A.T / 4 + np.eye(4)).astype(np.float32)
TALL = _R.randn(6, 3).astype(np.float32)
B = _R.randn(4, 2).astype(np.float32)
B6 = _R.randn(6, 2).astype(np.float32)
LOW = np.tril(A) + 3 * np.eye(4, dtype=np.float32)
RANK2 = (_R.randn(5, 2) @ _R.randn(2, 4)).astype(np.float32)
BATCH = _R.randn(2, 3, 3).astype(np.float32)
TAU = _R.rand(3).astype(np.float32)


class A_:
    def __init__(self, a):
        self.a = a


def _conv(pkg, v):
    if isinstance(v, A_):
        return pkg.to_tensor(v.a)
    if isinstance(v, list) and v and isinstance(v[0], A_):
        return [pkg.to_tensor(x.a) for x in v]
    return v


UNIQUE = {
    "inv": ("inv", [A_(A)], {}),
    "inverse_batch": ("inverse", [A_(BATCH)], {}),
    "det": ("det", [A_(A)], {}),
    "det_batch": ("det", [A_(BATCH)], {}),
    "slogdet": ("slogdet", [A_(A)], {}),
    "cholesky": ("cholesky", [A_(SPD)], {}),
    "cholesky_upper": ("cholesky", [A_(SPD)], {"upper": True}),
    "solve": ("solve", [A_(A), A_(B)], {}),
    "triangular_solve": ("triangular_solve", [A_(LOW), A_(B)],
                         {"upper": False}),
    "triangular_solve_t": ("triangular_solve", [A_(LOW.T.copy()), A_(B)],
                           {"upper": True, "transpose": True}),
    "triangular_solve_unit": ("triangular_solve", [A_(LOW), A_(B)],
                              {"upper": False, "unitriangular": True}),
    "cholesky_solve": ("cholesky_solve",
                       [A_(B), A_(np.linalg.cholesky(SPD).astype(np.float32))],
                       {}),
    "cholesky_solve_upper": ("cholesky_solve",
                             [A_(B), A_(np.linalg.cholesky(SPD).T.copy())],
                             {"upper": True}),
    "pinv": ("pinv", [A_(TALL)], {}),
    "matrix_power": ("matrix_power", [A_(A)], {"n": 3}),
    "matrix_power_neg": ("matrix_power", [A_(SPD)], {"n": -2}),
    "matrix_rank": ("matrix_rank", [A_(RANK2)], {}),
    "matrix_rank_tol": ("matrix_rank", [A_(A)], {"tol": 0.5}),
    "norm_fro": ("norm", [A_(A)], {}),
    "norm_axis": ("norm", [A_(A)], {"axis": 1}),
    "norm_inf": ("norm", [A_(A)], {"p": np.inf, "axis": 0}),
    "norm_neg_inf_all": ("norm", [A_(A)], {"p": -np.inf}),
    "norm_zero": ("norm", [A_(np.round(A))], {"p": 0, "axis": 1,
                                               "keepdim": True}),
    "norm_1_all": ("norm", [A_(A)], {"p": 1}),
    "norm_3": ("norm", [A_(BATCH)], {"p": 3, "axis": [1, 2]}),
    "cond": ("cond", [A_(SPD)], {}),
    "cond_fro": ("cond", [A_(SPD)], {"p": "fro"}),
    "cond_1": ("cond", [A_(SPD)], {"p": 1}),
    "lstsq": ("lstsq", [A_(TALL), A_(B6)], {}),
    "multi_dot": ("multi_dot", [[A_(A), A_(B), A_(B.T.copy())]], {}),
    "corrcoef": ("corrcoef", [A_(TALL)], {}),
    "corrcoef_cols": ("corrcoef", [A_(TALL)], {"rowvar": False}),
    "cov": ("cov", [A_(TALL)], {}),
    "cov_biased": ("cov", [A_(TALL)], {"rowvar": False, "ddof": False}),
    "householder_product": ("householder_product", [A_(TALL), A_(TAU)], {}),
    "eigvalsh": ("eigvalsh", [A_(SPD)], {}),
    "eigvalsh_upper": ("eigvalsh", [A_(SPD)], {"UPLO": "U"}),
    "matmul": ("matmul", [A_(A), A_(B)], {}),
    "dot": ("dot", [A_(A), A_(A)], {}),
}


@pytest.mark.parametrize("case", sorted(UNIQUE))
def test_unique_result_matches_reference(case):
    name, args, kw = UNIQUE[case]
    want = flat_outputs(getattr(RL, name)(*[_conv(paddle, a) for a in args],
                                          **kw))
    got = flat_outputs(getattr(PL, name)(*[_conv(tp, a) for a in args],
                                         **kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, rtol=1e-4, atol=1e-5, what=f"{case}[{i}]")


def _t(a):
    return tp.to_tensor(a)


def _close(a, b, tol=1e-4):
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) \
        else np.float64
    a, b = np.asarray(a, dt), np.asarray(b, dt)
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), \
        np.abs(a - b).max()


@pytest.mark.parametrize("full", [False, True])
def test_svd_by_its_identity(full):
    u, s, v = PL.svd(_t(TALL), full_matrices=full)
    ju, js, jv = RL.svd(paddle.to_tensor(TALL), full_matrices=full)
    assert u.shape == tuple(ju.shape) and v.shape == tuple(jv.shape)
    assert_same(s, js, rtol=1e-4, atol=1e-5)
    k = s.shape[0]
    _close(u[:, :k] @ torch.diag(s) @ v[:, :k].T, TALL)
    _close(u.T @ u, np.eye(u.shape[1]))
    _close(v.T @ v, np.eye(v.shape[1]))


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
def test_qr_by_its_identity(mode):
    out = PL.qr(_t(TALL), mode=mode)
    want = RL.qr(paddle.to_tensor(TALL), mode=mode)
    r = out if mode == "r" else out[1]
    jr = want if mode == "r" else want[1]
    assert r.shape == tuple(jr.shape)
    _close(np.abs(np.diag(r.numpy())), np.abs(np.diag(jr.numpy())))
    if mode != "r":
        q = out[0]
        assert q.shape == tuple(want[0].shape)
        _close(q @ r, TALL)
        _close(q.T @ q, np.eye(q.shape[1]))


def _sorted_eig(w):
    w = np.asarray(w)
    return w[np.lexsort((w.imag, w.real))]


def test_eig_and_eigvals_by_their_identity():
    w, v = PL.eig(_t(A))
    jw, _ = RL.eig(paddle.to_tensor(A))
    assert w.dtype == torch.complex64 and v.dtype == torch.complex64
    _close(_sorted_eig(w.numpy()), _sorted_eig(jw.numpy()))
    av = torch.from_numpy(A).to(torch.complex64) @ v
    _close(np.abs((av - v * w[None, :]).numpy()), np.zeros((4, 4)))
    _close(_sorted_eig(PL.eigvals(_t(A)).numpy()),
           _sorted_eig(RL.eigvals(paddle.to_tensor(A)).numpy()))


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_by_its_identity(uplo):
    w, v = PL.eigh(_t(SPD), UPLO=uplo)
    jw, _ = RL.eigh(paddle.to_tensor(SPD), UPLO=uplo)
    assert_same(w, jw, rtol=1e-4, atol=1e-5)
    _close(SPD @ v.numpy(), v.numpy() * w.numpy()[None, :])
    _close(v.T @ v, np.eye(4))


def test_lu_factor_pivots_and_identity():
    lu, piv = PL.lu(_t(A))
    jlu, jpiv = RL.lu(paddle.to_tensor(A))
    assert_same(lu, jlu, rtol=1e-4, atol=1e-5)
    assert_same(piv, jpiv)  # 1-based int32, LAPACK's
    l_, u_ = tp.lu_unpack(lu)
    perm = np.arange(4)
    for i, p in enumerate(piv.numpy() - 1):
        perm[[i, p]] = perm[[p, i]]
    pa = A[perm]
    _close(l_ @ u_, pa)
    _, _, info = PL.lu(_t(A), get_infos=True)
    assert int(info) == 0 and info.dtype == torch.int32


@pytest.mark.parametrize("name,args", [
    ("det", [A]), ("inv", [A]), ("solve", [A, B]), ("cholesky", [SPD])])
def test_gradient_matches_reference_tape(name, args):
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in args]
    tt = [tp.to_tensor(a, stop_gradient=False) for a in args]
    getattr(RL, name)(*jt).sum().backward()
    getattr(PL, name)(*tt).sum().backward()
    for j, t in zip(jt, tt):
        assert_same(t.grad, j.grad, rtol=1e-4, atol=1e-5, what=name)


def test_the_namespace_holds_the_reference_names():
    ref = {n for n in dir(RL) if not n.startswith("_")}
    assert ref <= set(dir(PL)), sorted(ref - set(dir(PL)))


def test_norm_runs_in_float32_under_o1_bf16():
    x = _t(A).to(torch.bfloat16)
    with tp.amp.auto_cast(level="O1", dtype="bfloat16"):
        assert PL.norm(x).dtype == torch.float32
