"""Top-level misc ops (port of ``paddle_tpu/ops/misc.py``): the tensor
attribute queries, ``reverse``, ``multiplex``, ``mode``, ``poisson``,
``set_printoptions``, ``create_parameter``, the build queries and the CUDA
generator state.

``get_cuda_rng_state``/``set_cuda_rng_state`` read and restore every
device generator of the port (``core/random.py``), the card's included.
``mode`` gives the smallest of the most frequent values and the index of
its first occurrence, as the reference does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import random as random_state
from .creation import _as


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_floating_point(x):
    return _as(x).is_floating_point()


def is_integer(x):
    x = _as(x)
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex(x):
    return _as(x).is_complex()


def is_empty(x, name=None):
    x = _as(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def rank(input):
    x = _as(input)
    return torch.tensor(x.dim(), device=x.device)


def shape(input):
    x = _as(input)
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def tolist(x):
    return _as(x).tolist()


def reverse(x, axis, name=None):
    from .manipulation import flip

    return flip(x, axis)


def multiplex(inputs, index, name=None):
    """Row b of the output is row b of ``inputs[index[b]]``."""
    stacked = torch.stack([_as(t) for t in inputs])  # (K, B, ...)
    idx = _as(index).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1], device=idx.device)]


def mode(x, axis=-1, keepdim=False, name=None):
    """``(values, indices)`` of the most frequent value along ``axis``: of
    the values tied for most frequent, the smallest, with the index of its
    first occurrence (the reference's choice)."""
    a = _as(x)
    s, si = torch.sort(a, dim=axis, stable=True)
    s_m, si_m = s.movedim(axis, -1), si.movedim(axis, -1)
    n = s_m.shape[-1]
    start = torch.ones_like(s_m[..., :1], dtype=torch.int64)
    runs = torch.cumsum(torch.cat(
        [start, (s_m[..., 1:] != s_m[..., :-1]).long()], -1), -1)
    flat = runs.reshape(-1, n)
    counts = torch.zeros(flat.shape[0], n + 1, dtype=torch.int64,
                         device=a.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    per = torch.gather(counts, 1, flat).reshape(runs.shape)
    best = torch.argmax(per, -1, keepdim=True)  # the first longest run
    vals = torch.gather(s_m, -1, best)
    idxs = torch.gather(si_m, -1, best)
    if keepdim:
        return vals.movedim(-1, axis), idxs.movedim(-1, axis)
    return vals[..., 0], idxs[..., 0]


def poisson(x, name=None):
    """Poisson draws with the rates ``x``, in ``x``'s dtype."""
    x = _as(x)
    gen = random_state.default_generator(x.device)
    return torch.poisson(x.float(), generator=gen).to(x.dtype)


_PRINTOPTS = {"precision": 8, "threshold": 1000, "edgeitems": 3,
              "linewidth": 80}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    _PRINTOPTS.update(kw)
    np.set_printoptions(**kw)
    torch.set_printoptions(sci_mode=sci_mode, **kw)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A ``Parameter`` of ``shape`` on ``get_device()``: zeros for a bias,
    else N(0, 0.02), unless ``default_initializer`` is given."""
    from ..core.dtype import convert_dtype
    from ..core.place import resolve_device
    from ..core.tensor import Parameter
    from ..nn.initializer import Constant, Normal

    init = default_initializer or (Constant(0.0) if is_bias
                                   else Normal(std=0.02))
    data = init([int(s) for s in shape], convert_dtype(dtype),
                resolve_device())
    return Parameter(data, name=name)


def disable_signal_handler():
    return None


def is_compiled_with_cinn():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_npu():
    return False


def is_compiled_with_mlu():
    return False


def is_compiled_with_ipu():
    return False


def get_cuda_rng_state():
    """Every device generator's state (``core.random.get_rng_state``)."""
    return random_state.get_rng_state()


def set_cuda_rng_state(state):
    return random_state.set_rng_state(state)


__all__ = [
    "is_tensor", "is_floating_point", "is_integer", "is_complex", "is_empty",
    "rank", "shape", "tolist", "reverse", "multiplex", "mode", "poisson",
    "set_printoptions", "create_parameter", "disable_signal_handler",
    "is_compiled_with_cinn", "is_compiled_with_rocm", "is_compiled_with_xpu",
    "is_compiled_with_npu", "is_compiled_with_mlu", "is_compiled_with_ipu",
    "get_cuda_rng_state", "set_cuda_rng_state",
]
