"""Sharding annotation API (port of ``paddle_tpu/distributed/sharding_api.py``
and of the reference's ``auto_parallel.reshard``).

The reference places a logical array over a GSPMD mesh. The port runs one
process a rank, so a tensor placed over a mesh is **this rank's shard** of
the logical tensor: :func:`shard_tensor` cuts it, and the result carries
``placement`` (a :class:`PartitionSpec`), ``mesh`` and ``logical_shape``.
A placement is the reference's: one entry a dimension, an axis name, a
tuple of axis names (the dimension split over their product, the first
axis major) or None (replicated). The shard a rank holds is the one the
reference's ``addressable_shards`` hands the device at that rank's mesh
coordinates: dimension ``d`` split into ``n`` equal parts, part ``i``
where ``i`` is the rank's row-major index over the entry's axes.

A tensor that needs grad stays differentiable: the shard is a slice of it.
A ``Parameter`` is not cut: it takes the placement as its ``pspec``, the
annotation ``auto_parallel`` completes and realises (the engine there
cuts it and inserts the collectives its placement needs).

:func:`reshard` moves a sharded tensor between placements over the groups
of the mesh axes it names: a dimension that becomes sharded is a local
slice, one that becomes replicated an all-gather over its axes, and one
axis moving from one dimension to another an all-to-all. Under autograd
its backward reshards the gradient back.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import global_mesh

__all__ = ["PartitionSpec", "NamedSharding", "shard_tensor", "shard_op",
           "reshard", "local_shard"]


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry a
    dimension (an axis name, a tuple of them, or None); missing trailing
    entries are None."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __getnewargs__(self):  # pickling passes the entries back
        return tuple(self)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)


P = PartitionSpec


def _spec(placement, ndim=None) -> PartitionSpec:
    if placement is None:
        spec = PartitionSpec()
    elif isinstance(placement, PartitionSpec):
        spec = placement
    else:
        spec = PartitionSpec(*placement)
    if ndim is not None:
        if len(spec) > ndim:
            raise ValueError(f"placement {spec} has more entries than the "
                             f"tensor's {ndim} dimensions")
        spec = PartitionSpec(*spec, *([None] * (ndim - len(spec))))
    return spec


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _coords(mesh, rank=None) -> dict:
    """This rank's coordinate on each mesh axis."""
    from .parallel_env import get_rank

    r = get_rank() if rank is None else rank
    hit = np.argwhere(np.asarray(mesh.devices) == r)
    if not len(hit):
        raise ValueError(f"rank {r} is not in the mesh {mesh}")
    return dict(zip(mesh.axis_names, (int(c) for c in hit[0])))


def _part(mesh, axes, coords) -> tuple:
    """(parts, this rank's part) of a dimension split over ``axes``."""
    n, i = 1, 0
    for a in axes:
        if a not in mesh.shape:
            raise ValueError(f"axis {a!r} is not in the mesh {mesh}")
        s = int(mesh.shape[a])
        n, i = n * s, i * s + coords[a]
    return n, i


def local_shard(x: torch.Tensor, spec, mesh, rank=None) -> torch.Tensor:
    """Rank ``rank``'s (default: this rank's) shard of the logical ``x``
    under ``spec``: a view that keeps ``x``'s autograd graph."""
    spec = _spec(spec, x.dim())
    coords = _coords(mesh, rank)
    out = x
    for d, entry in enumerate(spec):
        n, i = _part(mesh, _axes(entry), coords)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split into {n} equal parts ({spec})")
        size = x.shape[d] // n
        out = out.narrow(d, i * size, size)
    return out


class NamedSharding:
    """A layout: a placement over a mesh (the reference's
    ``jax.sharding.NamedSharding``). ``shard(x)`` is this rank's shard of
    the logical ``x``, carrying the layout as :func:`shard_tensor`'s
    result does."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = _spec(spec)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        spec = _spec(self.spec, x.dim())
        return _tag(local_shard(x, spec, self.mesh), spec, self.mesh,
                    x.shape)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, {self.spec})"


def _tag(t, spec, mesh, logical_shape):
    t.placement = spec
    t.mesh = mesh
    t.logical_shape = tuple(logical_shape)
    return t


def shard_tensor(x, mesh=None, placement=None, dist_attr=None):
    """Place ``x`` (the logical tensor, the same on every rank) over
    ``mesh`` by ``placement``: returns this rank's shard. A ``Parameter``
    keeps its data and takes the placement as its ``pspec`` annotation."""
    mesh = mesh or global_mesh()
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    spec = _spec(placement, x.dim())
    if isinstance(x, torch.nn.Parameter):
        x.pspec = spec
        return x
    return _tag(local_shard(x, spec, mesh), spec, mesh, x.shape)


def shard_op(op, mesh=None, in_specs=None, out_specs=None):
    """Wrap a callable so its inputs and outputs are placed by
    ``in_specs``/``out_specs`` (None entries are left as they are):
    inputs already placed are resharded, logical ones cut."""
    mesh = mesh or global_mesh()

    def place(t, s):
        if s is None:
            return t
        if getattr(t, "placement", None) is not None:
            return reshard(t, s, mesh)
        return shard_tensor(t, mesh, s)

    def wrapped(*args, **kwargs):
        if in_specs is not None:
            args = tuple(place(a, s) for a, s in zip(args, in_specs))
        out = op(*args, **kwargs)
        if out_specs is not None:
            if isinstance(out, (list, tuple)):
                out = type(out)(place(o, s) for o, s in zip(out, out_specs))
            else:
                out = place(out, out_specs)
        return out

    return wrapped


# -- reshard -----------------------------------------------------------------
def _members(mesh, axes, coords) -> list:
    """The ranks sharing this rank's coordinates off ``axes``, in the
    order of their part index over ``axes``."""
    devs = np.asarray(mesh.devices)
    idx = [slice(None) if a in axes else coords[a] for a in mesh.axis_names]
    sub = devs[tuple(idx)]
    # sub's axes are the mesh's order of `axes`; put them in entry order
    order = [a for a in mesh.axis_names if a in axes]
    sub = np.transpose(sub, [order.index(a) for a in axes])
    return [int(r) for r in sub.reshape(-1)]


def _group(mesh, axes):
    from .engine import fused_group

    order = [a for a in mesh.axis_names if a in axes]
    return fused_group(mesh, order)


def _gather(x, d, mesh, axes, coords):
    """All-gather dimension ``d`` over ``axes``: the parts in part order."""
    from . import collective as C

    members = _members(mesh, axes, coords)
    if len(members) == 1:
        return x
    g = _group(mesh, axes)
    parts = []
    C.all_gather(parts, x.contiguous(), group=g)
    by_rank = dict(zip(sorted(g.ranks), parts))
    return torch.cat([by_rank[r] for r in members], dim=d)


def _move(x, src, dst, mesh):
    """``x`` (this rank's shard under ``src``) as its shard under ``dst``."""
    coords = _coords(mesh)
    moved = [d for d in range(len(src)) if src[d] != dst[d]]
    if not moved:
        return x
    # one axis moving between two dimensions: a tiled all-to-all
    if len(moved) == 2:
        a, b = moved
        sa, sb, da, db = (_axes(src[a]), _axes(src[b]), _axes(dst[a]),
                          _axes(dst[b]))
        for d_from, d_to, s_from, s_to, t_from, t_to in (
                (a, b, sa, sb, da, db), (b, a, sb, sa, db, da)):
            if s_from and not s_to and not t_from and t_to == s_from:
                members = _members(mesh, s_from, coords)
                if len(members) == 1:
                    break
                g = _group(mesh, s_from)
                if members == sorted(g.ranks):
                    from . import collective as C

                    return C._a2a(x.contiguous(), g, d_to, d_from)
    # else: every dimension whose entry changes is gathered to whole, then
    # cut by its new entry (a dimension that only becomes sharded is a
    # local slice)
    out = x
    for d in moved:
        if _axes(src[d]):
            out = _gather(out, d, mesh, _axes(src[d]), coords)
    for d in moved:
        n, i = _part(mesh, _axes(dst[d]), coords)
        if n > 1:
            if out.shape[d] % n:
                raise ValueError(f"dimension {d} of size {out.shape[d]} does "
                                 f"not split into {n} equal parts ({dst})")
            size = out.shape[d] // n
            out = out.narrow(d, i * size, size)
    return out.contiguous()


class _Reshard(torch.autograd.Function):
    """Forward: ``src`` -> ``dst``; backward: the gradient ``dst`` ->
    ``src``."""

    @staticmethod
    def forward(ctx, x, src, dst, mesh):
        ctx.args = (src, dst, mesh)
        return _move(x.detach(), src, dst, mesh)

    @staticmethod
    def backward(ctx, g):
        src, dst, mesh = ctx.args
        return _move(g.contiguous(), dst, src, mesh), None, None, None


def reshard(x, placement, mesh=None):
    """``x`` under a new placement: ``x`` is a shard that
    :func:`shard_tensor` or :func:`reshard` returned (its own ``placement``
    and ``mesh``), or a logical tensor (replicated). Returns this rank's
    shard under ``placement``; every rank of the mesh calls it (the
    collectives are theirs too)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    mesh = getattr(x, "mesh", None) or mesh or global_mesh()
    src = _spec(getattr(x, "placement", None), x.dim())
    dst = _spec(placement, x.dim())
    logical = getattr(x, "logical_shape", None) or tuple(x.shape)
    if torch.is_grad_enabled() and x.requires_grad:
        out = _Reshard.apply(x, src, dst, mesh)
    else:
        out = _move(x, src, dst, mesh)
        if out is x:
            out = x.view(x.shape)
    return _tag(out, dst, mesh, logical)
