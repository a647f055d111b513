"""Tensor creation (port of ``paddle_tpu/ops/creation.py``). New tensors
land on ``get_device()``; the random ones are drawn from the port's
generator of that device (``core/random.py``, never torch's global stream),
the continuous ones in float32 and cast to the asked dtype, as the
reference draws in float32 and casts. They cannot give JAX's bits: they
are held to their shape, dtype, range and moments.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtypes
from ..core import random as random_state
from ..core.place import resolve_device
from ..core.tensor import to_tensor


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else dtypes.get_default_dtype()
    return dtypes.convert_dtype(dtype)


def _shape(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _as(x):
    """A tensor as is; anything else through ``to_tensor``."""
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, torch.Tensor):
        fill_value = fill_value.item()
    if dtype is None and isinstance(fill_value, float):
        dtype = dtypes.get_default_dtype()
    return torch.full(_shape(shape), fill_value,
                      dtype=dtypes.convert_dtype(dtype),
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = _as(x)
    return torch.zeros_like(x, dtype=_dt(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    x = _as(x)
    return torch.ones_like(x, dtype=_dt(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = _as(x)
    return torch.full_like(x, fill_value, dtype=_dt(dtype, x.dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """int64 for integer bounds, the default dtype when one is a float."""
    if end is None:
        start, end = 0, start
    start, end, step = (v.item() if isinstance(v, torch.Tensor) else v
                        for v in (start, end, step))
    if dtype is None and any(isinstance(v, float) for v in (start, end, step)):
        dtype = dtypes.get_default_dtype()
    return torch.arange(start, end, step, dtype=dtypes.convert_dtype(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(float(start), float(stop), int(num),
                          dtype=_dt(dtype), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(float(start), float(stop), int(num), base=base,
                          dtype=_dt(dtype), device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(num_rows, cols, dtype=_dt(dtype),
                     device=resolve_device())


def tril(x, diagonal=0, name=None):
    return torch.tril(_as(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(_as(x), diagonal)


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D input as the diagonal ``offset`` of a square matrix whose other
    entries are ``padding_value``; a 2-D input's diagonal ``offset``."""
    x = _as(x)
    if x.dim() != 1:
        return torch.diagonal(x, offset)
    d = torch.diag(x, offset)
    if padding_value != 0:
        on = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        d = torch.where(on, d, torch.as_tensor(padding_value, dtype=d.dtype,
                                               device=x.device))
    return d


def diagflat(x, offset=0, name=None):
    return torch.diagflat(_as(x), offset)


def meshgrid(*args, name=None):
    """``ij``-indexed grids of the 1-D inputs (given as arguments or one
    list)."""
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[_as(t) for t in ts], indexing="ij"))


def assign(x, output=None):
    x = _as(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(x)
        return output
    return x.clone()


def clone(x, name=None):
    return _as(x).clone()


def numel(x, name=None):
    """The element count as a 0-d int64 tensor on ``x``'s device."""
    x = _as(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Each id's index inside shard ``shard_id`` of ``nshards`` equal shards
    of ``index_num`` ids, ``ignore_value`` where the id lies elsewhere."""
    a = _as(input)
    size = index_num // nshards
    return torch.where(torch.div(a, size, rounding_mode="floor") == shard_id,
                       torch.remainder(a, size), ignore_value)


# -- random (reference: python/paddle/tensor/random.py) ----------------------
def _f32(shape):
    dev = resolve_device()
    return (torch.empty(_shape(shape), dtype=torch.float32, device=dev),
            random_state.default_generator(dev))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    t, gen = _f32(shape)
    return t.uniform_(min, max, generator=gen).to(_dt(dtype))


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def normal(mean=0.0, std=1.0, shape=None, dtype=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        shape = torch.broadcast_shapes(
            getattr(mean, "shape", ()), getattr(std, "shape", ()))
    t, gen = _f32(shape)
    return (t.normal_(generator=gen) * std + mean).to(_dt(dtype))


def randn(shape, dtype=None, name=None):
    return normal(0.0, 1.0, shape, dtype=dtype)


def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None):
    return normal(mean, std, shape, dtype=dtype)


def standard_normal(shape, dtype=None, name=None):
    return normal(0.0, 1.0, shape, dtype=dtype)


def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(int(low), int(high), _shape(shape), device=dev,
                         generator=random_state.default_generator(dev),
                         dtype=torch.int64).to(_dt(dtype, torch.int64))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = _as(x)
    return randint(low, high, tuple(x.shape), dtype=_dt(dtype, x.dtype))


def randperm(n, dtype=None, name=None):
    dev = resolve_device()
    return torch.randperm(int(n), device=dev,
                          generator=random_state.default_generator(dev)).to(
        _dt(dtype, torch.int64))


def bernoulli(x, name=None):
    """0/1 draws with the probabilities ``x``, in ``x``'s dtype, on ``x``'s
    device."""
    x = _as(x)
    gen = random_state.default_generator(x.device)
    return torch.bernoulli(x.float(), generator=gen).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """int64 category draws from the (unnormalised) row weights ``x``."""
    x = _as(x)
    gen = random_state.default_generator(x.device)
    return torch.multinomial(x.float(), int(num_samples), replacement,
                             generator=gen)


__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace", "eye",
           "diag", "diagflat", "tril", "triu", "meshgrid", "assign", "clone",
           "numel", "shard_index", "uniform", "rand", "normal", "gaussian",
           "standard_normal", "randn", "randint", "randint_like", "randperm",
           "bernoulli", "multinomial"]
