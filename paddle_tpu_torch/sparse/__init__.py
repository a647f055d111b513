"""``paddle.sparse`` (port of ``paddle_tpu/sparse/__init__.py``): COO and
CSR sparse tensors and their ops, and ``SelectedRows``.

``SparseCooTensor`` and ``SparseCsrTensor`` wrap a ``torch.sparse_coo`` /
``torch.sparse_csr`` tensor in a small class of their own (not a
``torch.Tensor``), with Paddle's ``indices()``, ``values()``, ``crows()``,
``cols()``, ``nnz()``, ``to_dense()`` and ``coalesce()``; the indices read
as int32, as the reference's. Dense ops on them raise ``TypeError``: use
``paddle_tpu_torch.sparse.*`` or ``to_dense()``. A COO tensor keeps
duplicate coordinates until ``coalesce()``.

``matmul`` (sparse @ dense -> dense) is ``torch.sparse.mm``.
``masked_matmul`` computes only the mask's stored positions, gathering the
rows of ``x`` and the columns of ``y`` for them as the reference does, in
chunks of ``MASKED_CHUNK`` positions. The ops of two sparse operands, the
unary ops and ``softmax`` return COO, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core.place import resolve_device
from ..ops.creation import _as

# masked_matmul's positions a step: bounds its gathered rows and columns
MASKED_CHUNK = 1 << 16


class SparseTensor:
    """A sparse tensor: ``_sp`` holds the torch sparse tensor; ``shape``
    is the logical dense shape."""

    def __init__(self, sp, stop_gradient=True):
        self._sp = sp
        self.stop_gradient = stop_gradient

    @property
    def shape(self):
        return list(self._sp.shape)

    @property
    def ndim(self):
        return self._sp.dim()

    @property
    def size(self):
        return int(np.prod(self._sp.shape))

    @property
    def dtype(self):
        return self._sp.dtype

    @property
    def place(self):
        return self._sp.device

    @property
    def is_sparse(self):
        return True

    def numpy(self):
        return self.to_dense().detach().cpu().numpy()

    def to_dense(self):
        return self._sp.to_dense()

    def nnz(self):
        return int(self._sp._nnz())

    def _no_dense(self, *a, **k):
        raise TypeError("dense op on a sparse tensor: use "
                        "paddle_tpu_torch.sparse.* ops or call .to_dense() "
                        "first")

    __add__ = __radd__ = __sub__ = __mul__ = __rmul__ = __truediv__ = \
        _no_dense
    __matmul__ = __neg__ = _no_dense
    sum = mean = max = min = reshape = transpose = matmul = _no_dense


class SparseCooTensor(SparseTensor):
    def indices(self):
        return self._sp._indices().to(torch.int32)

    def values(self):
        return self._sp._values()

    def coalesce(self):
        return SparseCooTensor(self._sp.coalesce(), self.stop_gradient)

    def is_sparse_coo(self):
        return True

    def to_sparse_csr(self):
        return SparseCsrTensor(self._sp.coalesce().to_sparse_csr(),
                               self.stop_gradient)


class SparseCsrTensor(SparseTensor):
    def crows(self):
        return self._sp.crow_indices().to(torch.int32)

    def cols(self):
        return self._sp.col_indices().to(torch.int32)

    def values(self):
        return self._sp.values()

    def is_sparse_csr(self):
        return True

    def to_sparse_coo(self, sparse_dim=2):
        return SparseCooTensor(self._sp.to_sparse_coo(), self.stop_gradient)


def _values(values, dtype, device):
    v = values if isinstance(values, torch.Tensor) else \
        torch.as_tensor(np.asarray(values), device=device)
    return v.to(dtypes.convert_dtype(dtype)) if dtype is not None else v


def sparse_coo_tensor(indices, values, shape=None, dtype=None, place=None,
                      stop_gradient=True):
    """A COO tensor from ``indices`` (ndim, nnz) and ``values`` (nnz, ...);
    ``shape`` defaults to the largest index + 1 on each axis."""
    dev = resolve_device(place) if place is not None else None
    idx = indices.long() if isinstance(indices, torch.Tensor) else \
        torch.as_tensor(np.asarray(indices), dtype=torch.int64, device=dev)
    vals = _values(values, dtype, idx.device)
    if shape is None:
        shape = (idx.amax(1) + 1).tolist()
    sp = torch.sparse_coo_tensor(idx, vals, tuple(int(s) for s in shape),
                                 check_invariants=True)
    return SparseCooTensor(sp, stop_gradient=stop_gradient)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    dev = resolve_device(place) if place is not None else None

    def idx(v):
        return v.long() if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v), dtype=torch.int64, device=dev)

    crows, cols = idx(crows), idx(cols)
    vals = _values(values, dtype, crows.device)
    sp = torch.sparse_csr_tensor(crows, cols, vals,
                                 tuple(int(s) for s in shape),
                                 check_invariants=True)
    return SparseCsrTensor(sp, stop_gradient=stop_gradient)


def to_sparse_coo(x, sparse_dim=None):
    t = _as(x)
    return SparseCooTensor(t.to_sparse(), stop_gradient=not t.requires_grad)


def to_sparse_csr(x):
    t = _as(x)
    return SparseCsrTensor(t.to_sparse_csr(),
                           stop_gradient=not t.requires_grad)


def _sp(x):
    if isinstance(x, SparseTensor):
        return x._sp
    raise TypeError(f"expected a sparse tensor, got {type(x).__name__}")


def _coo(x):
    sp = _sp(x)
    return sp.to_sparse_coo() if sp.layout == torch.sparse_csr else sp


def _wrap_coo(sp, like):
    return SparseCooTensor(sp, stop_gradient=like.stop_gradient)


def _coo_like(indices, values, shape):
    """A COO tensor on indices taken from a valid sparse tensor."""
    return torch.sparse_coo_tensor(indices, values, shape,
                                   check_invariants=False)


# -- sparse ops --------------------------------------------------------------
def add(x, y, name=None):
    """Sparse + sparse -> COO (duplicates summed); with a dense operand,
    the sparse side is densified and the result is dense."""
    if isinstance(x, SparseTensor) and isinstance(y, SparseTensor):
        a, b = _coo(x), _coo(y)
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"sparse.add shape mismatch: {tuple(a.shape)} "
                             f"vs {tuple(b.shape)}")
        b = b.to(a.dtype)
        out = _coo_like(torch.cat([a._indices(), b._indices()], 1),
                        torch.cat([a._values(), b._values()]),
                        a.shape).coalesce()
        return _wrap_coo(out, x)
    xd = x.to_dense() if isinstance(x, SparseTensor) else _as(x)
    yd = y.to_dense() if isinstance(y, SparseTensor) else _as(y)
    return xd + yd


def multiply(x, y, name=None):
    """Elementwise product on ``x``'s stored positions (``y`` dense or
    sparse, read at them), COO."""
    if not isinstance(x, SparseTensor):
        raise TypeError("sparse.multiply expects a sparse first operand")
    coo = _coo(x)
    yv = y.to_dense() if isinstance(y, SparseTensor) else y
    if isinstance(yv, torch.Tensor) and yv.dim():
        gathered = yv[tuple(coo._indices())]
    else:
        gathered = yv
    return _wrap_coo(_coo_like(coo._indices(), coo._values() * gathered,
                               coo.shape), x)


def matmul(x, y, name=None):
    """Sparse (M, K) @ dense (K, N) -> dense (M, N)."""
    return torch.sparse.mm(_sp(x), _as(y))


def masked_matmul(x, y, mask, name=None):
    """``(x @ y)`` at ``mask``'s stored positions only, as a COO tensor
    with ``mask``'s pattern."""
    xt, yt = _as(x), _as(y)
    coo = _coo(mask)
    rows, cols = coo._indices()
    yt_t = yt.transpose(0, 1)
    vals = torch.cat([
        torch.einsum("nk,nk->n", xt[rows[i:i + MASKED_CHUNK]],
                     yt_t[cols[i:i + MASKED_CHUNK]])
        for i in range(0, rows.numel(), MASKED_CHUNK)]) if rows.numel() \
        else xt.new_zeros((0,))
    return _wrap_coo(_coo_like(coo._indices(), vals, coo.shape), mask)


def _unary(fn_name, fn):
    def op(x, name=None):
        coo = _coo(x)
        return _wrap_coo(_coo_like(coo._indices(), fn(coo._values()),
                                   coo.shape), x)

    op.__name__ = fn_name
    op.__doc__ = f"Sparse elementwise {fn_name} of the stored values (COO)."
    return op


relu = _unary("relu", torch.relu)
sin = _unary("sin", torch.sin)
tanh = _unary("tanh", torch.tanh)
sqrt = _unary("sqrt", torch.sqrt)
abs = _unary("abs", torch.abs)
neg = _unary("neg", torch.neg)


def pow(x, factor, name=None):
    return _unary("pow", lambda v: torch.pow(v, factor))(x)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    dt = dtypes.convert_dtype(value_dtype)
    return _unary("cast", lambda v: v.to(dt) if dt is not None else v)(x)


def softmax(x, axis=-1, name=None):
    """Softmax over the last axis of the stored entries: the entries that
    share every other coordinate form one group, and missing entries count
    as -inf (only stored ones are normalised). COO."""
    coo = _coo(x).coalesce()
    ndim = coo.dim()
    if axis not in (-1, ndim - 1):
        raise NotImplementedError("sparse.softmax supports the last axis "
                                  "only")
    idx, v = coo._indices(), coo._values()
    lead = coo.shape[:-1]
    rows = torch.zeros_like(idx[0])
    for i, n in enumerate(lead):
        rows = rows * n + idx[i]
    n_rows = int(np.prod(lead))
    row_max = torch.full((n_rows,), -torch.inf, dtype=v.dtype,
                         device=v.device).scatter_reduce(0, rows, v, "amax")
    ex = torch.exp(v - row_max[rows])
    row_sum = torch.zeros((n_rows,), dtype=v.dtype,
                          device=v.device).index_add(0, rows, ex)
    return _wrap_coo(_coo_like(idx, ex / row_sum[rows], coo.shape), x)


class SelectedRows:
    """The embedding-gradient format: ``rows[i]`` is the row id of
    ``value[i]``; duplicates stay until ``merge()``."""

    def __init__(self, rows, value, height):
        self.rows = _as(rows).to(torch.int32)
        self.value = _as(value)
        self.height = int(height)

    def merge(self):
        """Duplicate rows summed, the row ids sorted."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        merged = torch.zeros((uniq.shape[0],) + tuple(self.value.shape[1:]),
                             dtype=self.value.dtype, device=self.value.device)
        merged = merged.index_add(0, inv, self.value)
        return SelectedRows(uniq, merged, self.height)

    def to_dense(self):
        out = torch.zeros((self.height,) + tuple(self.value.shape[1:]),
                          dtype=self.value.dtype, device=self.value.device)
        return out.index_add(0, self.rows.long(), self.value)


__all__ = [
    "SparseCooTensor", "SparseCsrTensor", "SelectedRows",
    "sparse_coo_tensor", "sparse_csr_tensor", "to_sparse_coo",
    "to_sparse_csr", "add", "multiply", "matmul", "masked_matmul", "softmax",
    "relu", "sin", "tanh", "sqrt", "abs", "pow", "neg", "cast",
]
