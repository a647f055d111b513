"""Linear algebra (port of ``paddle_tpu/ops/linalg.py``) over
``torch.linalg``, under the reference's conventions:

- ``svd`` returns ``(U, S, V)`` with V, not Vᴴ; ``slogdet`` stacks
  ``[sign, log|det|]``;
- ``lu`` returns the packed LU matrix and 1-based int32 pivots (LAPACK's,
  which ``torch.linalg.lu_factor`` gives as they are);
- ``triangular_solve(x, y)`` solves ``x @ out = y`` with ``x``
  triangular; ``cholesky_solve(x, y)`` solves with ``y`` the Cholesky
  factor;
- ``lstsq`` returns ``(solution, residuals, rank, singular values)``:
  residuals are the squared column norms of ``y - x @ solution`` when ``x``
  is tall and of full rank (empty otherwise), as NumPy gives them.

The factors of ``svd``, ``eig``, ``eigh`` and ``qr`` are unique only up to
signs or phases. ``eig``, ``eigvals``, ``matrix_rank`` (host-side in the
reference), ``cond`` and ``lstsq`` wait for the card on it: ``eig`` copies
its result to the host inside ``torch.linalg.eig``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dispatch import amp_cast
from .creation import _as


def _driver(x):
    """cuSOLVER's QR-based ``gesvd`` on the card: the default Jacobi driver
    leaves ``U diag(S) Vᵀ`` ~1e-3 off an ill-conditioned float32 matrix."""
    return {"driver": "gesvd"} if x.is_cuda else {}


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(_as(x), upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(_as(x))


inverse = inv


def det(x, name=None):
    return torch.linalg.det(_as(x))


def slogdet(x, name=None):
    sign, logdet = torch.linalg.slogdet(_as(x))
    return torch.stack([sign, logdet])


def svd(x, full_matrices=False, name=None):
    x = _as(x)
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices,
                                **_driver(x))
    return u, s, vh.transpose(-1, -2)


def qr(x, mode="reduced", name=None):
    """``(Q, R)``; ``mode="r"`` gives R alone."""
    q, r = torch.linalg.qr(_as(x), mode=mode)
    return r if mode == "r" else (q, r)


def eig(x, name=None):
    return tuple(torch.linalg.eig(_as(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_as(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(_as(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_as(x), UPLO=UPLO)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    """The reference's ``norm``: Frobenius (or 2) over everything when
    ``axis`` is None, else the entrywise ``p``-norm over ``axis`` (``fro``,
    ``inf``, ``-inf``, 0 or any ``p``)."""
    x, = amp_cast("norm", (_as(x),))
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    if axis is None:
        dims, keepdim = None, False
        if p in ("fro", 2):
            return torch.sqrt(torch.sum(torch.square(x)))
    else:
        dims = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    a = torch.abs(x)
    if p == "fro":
        return torch.sqrt(torch.sum(torch.square(x), dims, keepdim=keepdim))
    if p == np.inf:
        return torch.amax(a, dims if dims is not None else (),
                          keepdim=keepdim)
    if p == -np.inf:
        return torch.amin(a, dims if dims is not None else (),
                          keepdim=keepdim)
    if p == 0:
        return torch.sum((x != 0).to(x.dtype), dims, keepdim=keepdim)
    return torch.pow(torch.sum(torch.pow(a, p), dims, keepdim=keepdim),
                     1.0 / p)


def cond(x, p=None, name=None):
    x = _as(x)
    if p is None or p in (2, -2):
        s = torch.linalg.svdvals(x, **_driver(x))
        big, small = s[..., 0], s[..., -1]
        return big / small if p != -2 else small / big
    return torch.linalg.cond(x, p)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_as(x), int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """int64; computed in float64, as the reference does on the host. With
    ``tol`` None the threshold is NumPy's: the largest singular value times
    max(M, N) times float64's machine epsilon."""
    a = _as(x).double()
    if tol is None:
        s = torch.linalg.svdvals(a, **_driver(a))
        t = s.amax(-1, keepdim=True) * max(a.shape[-2:]) \
            * torch.finfo(torch.float64).eps
        return (s > t).sum(-1)
    return torch.linalg.matrix_rank(a, atol=float(tol), rtol=0.0,
                                    hermitian=hermitian)


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    """The singular values above ``rcond`` times the largest inverted
    (``jnp.linalg.pinv``'s rule), through :func:`svd`."""
    x = _as(x)
    if hermitian:
        return torch.linalg.pinv(x, rtol=rcond, hermitian=True)
    u, s, v = svd(x)
    keep = s > rcond * s[..., :1]
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return (v * inv[..., None, :]) @ u.transpose(-1, -2)


def solve(x, y, name=None):
    return torch.linalg.solve(_as(x), _as(y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = _as(x)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, _as(y), upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(_as(x), _as(y), upper=upper)


def lstsq(x, y, rcond=None, driver=None, name=None):
    a, b = _as(x), _as(y)
    if rcond is None:
        rcond = torch.finfo(a.dtype).eps * max(a.shape[-2:])
    drv = driver or ("gelsd" if a.device.type == "cpu" else "gels")
    sol, _, rank, sv = torch.linalg.lstsq(a, b, rcond=rcond, driver=drv)
    m, n = a.shape[-2], a.shape[-1]
    if drv == "gels" or rank.numel() == 0:
        rank = torch.linalg.matrix_rank(a)
    if sv.numel() == 0:
        sv = torch.linalg.svdvals(a)
    full = bool(rank == n) if rank.dim() == 0 else bool((rank == n).all())
    if m > n and full:
        r = b - a @ sol
        res = torch.sum(r * r, -2)
    else:
        res = torch.zeros((0,), dtype=a.dtype, device=a.device)
    return sol, res, rank.to(torch.int64), sv


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` (and the int32 infos, 0 on success)."""
    lu_mat, piv, info = torch.linalg.lu_factor_ex(_as(x), pivot=pivot)
    if get_infos:
        return lu_mat, piv, info
    return lu_mat, piv


def multi_dot(tensors, name=None):
    return torch.linalg.multi_dot([_as(t) for t in tensors])


def corrcoef(x, rowvar=True, name=None):
    x = _as(x)
    return torch.corrcoef(x if rowvar else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = _as(x)
    return torch.cov(x if rowvar else x.T, correction=1 if ddof else 0)


def householder_product(x, tau, name=None):
    """The first N columns of H_0 H_1 ... H_{N-1}, H_i = I - tau_i v_i
    v_iᵀ with v_i the i-th column of ``x`` below the diagonal and 1 on it
    (LAPACK's ``orgqr``)."""
    return torch.linalg.householder_product(_as(x), _as(tau))


__all__ = ["cholesky", "inv", "inverse", "det", "slogdet", "svd", "qr",
           "eig", "eigh", "eigvals", "eigvalsh", "norm", "cond",
           "matrix_power", "matrix_rank", "pinv", "solve", "triangular_solve",
           "cholesky_solve", "lstsq", "lu", "multi_dot", "corrcoef", "cov",
           "householder_product"]
