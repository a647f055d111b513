"""``paddle.linalg`` (port of ``paddle_tpu/linalg/__init__.py``)."""
from ..ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond, corrcoef, cov, det, eig, eigh, eigvals,
    eigvalsh, householder_product, inv, inverse, lstsq, lu, matrix_power,
    matrix_rank, multi_dot, norm, pinv, qr, slogdet, solve, svd,
    triangular_solve,
)
from ..ops.math import dot, matmul  # noqa: F401
