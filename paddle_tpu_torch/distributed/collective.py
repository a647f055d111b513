"""Collective communication on ``torch.distributed`` (port of
``paddle_tpu/distributed/collective.py``).

The reference's collective is an HLO op on a mesh axis: inside a
``shard_map`` trace it lowers to ``lax.psum``/``all_gather``/``all_to_all``,
and eagerly on one controller it is the single-participant identity. The
port runs one process a card, so a collective here is a
``torch.distributed`` call over a :class:`Group`'s process group: NCCL on
the card, gloo on the CPU (``init_parallel_env``). Without a process group
(``init_parallel_env`` not called) the world is one rank and every
collective is the reference's single-participant identity. A world of one
with a process group launches the collective all the same.

Reductions take the reference's ``ReduceOp``; ``AVG`` is a sum divided by
the group's size, on every backend. ``reduce`` leaves the result on
``dst`` (the reference's all-reduce is the TPU's cheaper form). Host-level
eager p2p (``send``/``recv``/``isend``/``irecv``) raises, as the
reference's does.

The quantized collectives (``blockwise_quantize``, ``quantized_*``) keep
the reference's EQuARX blockwise int8 arithmetic around an all-to-all and
an all-gather. The model-parallel helpers (``_c_identity``,
``_mp_allreduce``, ``_c_split``, ``_c_concat``,
``_c_softmax_with_cross_entropy``) are ``torch.autograd.Function``s over a
group: identity forward and all-reduce backward, and so on. With no group,
or a group of one rank, each is what the reference's is outside a bound
``mp`` axis: the identity, or the plain per-row cross-entropy. Over a group
of more ranks they run on its process group (the hybrid topology's ``mp``
group, ``fleet/base/topology.py``); a group of more ranks that has no
process group (the reference's GSPMD-partitioned mesh axis) raises.

Sequence parallelism adds three internal autograd collectives over a
group: ``_ring_shift`` (the reference's ``lax.ppermute`` with
``perm = [(i, (i - 1) % n)]``: rank i sends to i - 1 and receives from
i + 1, and the backward shifts the gradient the other way),
``_all_to_all_tiled`` (the reference's tiled ``lax.all_to_all``, whose
backward is the reverse exchange) and ``_all_gather_tiled`` (the tiled
``lax.all_gather``, whose backward is the reduce-scatter of the sum). The
public eager ``send``/``recv`` keep raising.

``record()`` logs every collective launched inside its block, with its
kind (the reference's HLO names: ``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``; else the torch
name) and the bytes it produces; auto-parallel's plan cost reads it in
place of the reference's parse of compiled HLO. ``barrier`` and ``wait``
run under the watchdog's ``guard`` (``FLAGS_collective_timeout_s``; a
flag probe when it is 0); on the card a guarded ``wait`` synchronizes the
tensor's stream inside the guard.
"""
from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "ReduceOp", "Group", "new_group", "get_group", "get_rank",
    "get_world_size", "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce", "reduce_scatter", "broadcast", "scatter", "all_to_all",
    "alltoall", "alltoall_single", "send", "recv", "isend", "irecv",
    "p2p_permute",
    "barrier", "wait", "split", "blockwise_quantize", "blockwise_dequantize",
    "quantized_psum_scatter_mean", "quantized_all_reduce_mean",
    "_c_identity", "_mp_allreduce", "_c_split", "_c_concat",
    "_c_softmax_with_cross_entropy", "_ring_shift", "_all_to_all_tiled",
    "_all_gather_tiled", "record",
]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.SUM}


class Group:
    """A communicator: world ranks and their ``torch.distributed`` process
    group (the reference's is a mesh axis). ``rank`` is this process's
    index in ``ranks`` (-1 outside them)."""

    _next_id = 0

    def __init__(self, axis_name: Optional[str] = None, ranks=None,
                 nranks=None, pg=None):
        Group._next_id += 1
        self.id = Group._next_id
        self.axis_name = axis_name
        self.ranks = list(ranks) if ranks is not None else []
        self._nranks = nranks
        self._pg = pg

    @property
    def nranks(self) -> int:
        if self._nranks is not None:
            return self._nranks
        if self.ranks:
            return len(self.ranks)
        if self.axis_name:
            from .mesh import mesh_axis_size

            return mesh_axis_size(self.axis_name)
        return 1

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        from .parallel_env import get_rank as _world_rank

        return self.get_group_rank(_world_rank())

    def get_group_rank(self, rank) -> int:
        if not self.ranks:
            return 0 if rank == 0 else -1
        return self.ranks.index(rank) if rank in self.ranks else -1

    def process_group(self):
        return self._pg


_default_group: Optional[Group] = None
_groups = {}
_fused = {}  # the engine's groups over fused mesh axes (engine.fused_group)


def _reset() -> None:
    """Forget the groups of a process group that was destroyed."""
    global _default_group
    _default_group = None
    _groups.clear()
    _fused.clear()


def _get_default_group() -> Group:
    global _default_group
    live = dist.is_initialized()
    if _default_group is None or (_default_group._pg is not None) != live:
        n = dist.get_world_size() if live else 1
        _default_group = Group(ranks=range(n), nranks=n,
                               pg=dist.group.WORLD if live else None)
    return _default_group


def new_group(ranks=None, backend=None, axis_name=None, timeout=None):
    """A group over ``ranks`` (default: every rank). With a process group
    joined this is ``torch.distributed.new_group``, which every rank of the
    world must call, as NCCL requires."""
    if dist.is_initialized():
        world = dist.get_world_size()
        ranks = list(range(world)) if ranks is None else sorted(ranks)
        pg = dist.new_group(ranks=ranks)
        g = Group(axis_name=axis_name, ranks=ranks, pg=pg)
    else:
        g = Group(axis_name=axis_name, ranks=ranks)
    _groups[g.id] = g
    return g


def get_group(gid=0):
    if gid == 0:
        return _get_default_group()
    return _groups.get(gid)


def get_rank(group=None) -> int:
    from .parallel_env import get_rank as _rank

    return _rank(group)


def get_world_size(group=None) -> int:
    from .parallel_env import get_world_size as _world

    return _world(group)


def _resolve(group, what: str):
    """(process group, ranks) of ``group``: the process group is None for
    the single-participant identity. A group of more than one rank without
    a process group raises."""
    if group is None:
        group = _get_default_group()
    n = int(getattr(group, "nranks", 1))
    pg = group._pg if isinstance(group, Group) else None
    if pg is None and n > 1:
        raise NotImplementedError(
            f"{what} over a group of {n} ranks that has no process group "
            "(a mesh axis the reference's GSPMD partitions) has no port: "
            "join one with init_parallel_env() and fleet.init() (or "
            "new_group())")
    return pg, n


# -- the collective API ------------------------------------------------------
def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    """Reduce ``tensor`` over the group in place and return it."""
    pg, n = _resolve(group, "all_reduce")
    if pg is None:
        return tensor
    dist.all_reduce(tensor, op=_TORCH_OP[op], group=pg)
    if op == ReduceOp.AVG and n > 1:
        _div_(tensor, n)
    return tensor


def _div_(t, n):
    if t.is_floating_point() or t.is_complex():
        t.div_(n)
    else:
        t.div_(n, rounding_mode="trunc")


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Every rank's ``tensor``: appended to ``tensor_list`` when it is a
    list, else returned stacked on a new leading axis."""
    pg, n = _resolve(group, "all_gather")
    if pg is None:
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor.contiguous(), group=pg)
    if isinstance(tensor_list, list):
        tensor_list.extend(parts)
        return None
    return torch.stack(parts)


def _quiet(fn, *args, **kw):
    # newer torch renames the *_tensor collectives with a FutureWarning
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kw)


def all_gather_into_tensor(out, tensor, group=None, sync_op=True,
                           concat_axis=0):
    """Every rank's ``tensor`` concatenated along ``concat_axis`` (written
    into ``out`` too when it is a tensor of that shape)."""
    pg, n = _resolve(group, "all_gather_into_tensor")
    if pg is None:
        res = tensor
    elif concat_axis == 0:
        res = tensor.new_empty((tensor.shape[0] * n,) + tuple(tensor.shape[1:]))
        _quiet(dist.all_gather_into_tensor, res, tensor.contiguous(),
               group=pg)
    else:
        parts = [torch.empty_like(tensor) for _ in range(n)]
        dist.all_gather(parts, tensor.contiguous(), group=pg)
        res = torch.cat(parts, dim=concat_axis)
    if isinstance(out, torch.Tensor) and out.shape == res.shape \
            and out is not res:
        out.copy_(res)
    return res


def reduce(tensor, dst, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group onto rank ``dst`` (in place there;
    the other ranks' copies are left to the backend)."""
    pg, n = _resolve(group, "reduce")
    if pg is None:
        return tensor
    dist.reduce(tensor, dst=dst, op=_TORCH_OP[op], group=pg)
    if op == ReduceOp.AVG and n > 1 and get_rank() == dst:
        _div_(tensor, n)
    return tensor


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This rank's share of the reduction, written into ``tensor`` and
    returned: of ``tensor_list[rank]`` over the ranks when given a list,
    else of the input's dim-0 shard (tiled)."""
    pg, n = _resolve(group, "reduce_scatter")
    src = tensor_list_or_input
    if pg is None:
        res = src[0] if isinstance(src, list) else src
        if isinstance(tensor, torch.Tensor) and tensor is not res \
                and tensor.shape == res.shape:
            tensor.copy_(res)
        return res
    if isinstance(src, list):
        dist.reduce_scatter(tensor, [s.contiguous() for s in src],
                            op=_TORCH_OP[op], group=pg)
    else:
        _quiet(dist.reduce_scatter_tensor, tensor, src.contiguous(),
               op=_TORCH_OP[op], group=pg)
    if op == ReduceOp.AVG and n > 1:
        _div_(tensor, n)
    return tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    pg, _ = _resolve(group, "broadcast")
    if pg is not None:
        dist.broadcast(tensor, src=src, group=pg)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """``tensor_list[rank]`` of rank ``src`` into ``tensor``."""
    pg, _ = _resolve(group, "scatter")
    if pg is None:
        if tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    lst = [t.contiguous() for t in tensor_list] \
        if get_rank() == src and tensor_list is not None else None
    dist.scatter(tensor, lst, src=src, group=pg)
    return tensor


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Rank r's ``in_tensor_list[j]`` becomes rank j's ``out[r]`` (MoE's
    routing block). ``in_tensor_list`` may be one tensor split on dim 0."""
    pg, n = _resolve(group, "all_to_all")
    ins = list(in_tensor_list) if isinstance(in_tensor_list, list) \
        else list(in_tensor_list.unbind(0))
    if pg is None:
        outs = ins
    else:
        outs = [torch.empty_like(t) for t in ins]
        dist.all_to_all(outs, [t.contiguous() for t in ins], group=pg)
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(outs)
        return None
    return torch.stack(outs)


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    out_tensor_list = [] if out_tensor_list is None else out_tensor_list
    all_to_all(out_tensor_list, in_tensor_list, group, sync_op)
    return out_tensor_list


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """The tiled all-to-all of one tensor's dim 0 (even splits unless sizes
    are given)."""
    pg, _ = _resolve(group, "alltoall_single")
    if pg is None:
        return in_tensor
    out = out_tensor if isinstance(out_tensor, torch.Tensor) else None
    if out is None:
        rows = (sum(out_split_sizes) if out_split_sizes is not None
                else in_tensor.shape[0])
        out = in_tensor.new_empty((rows,) + tuple(in_tensor.shape[1:]))
    dist.all_to_all_single(out, in_tensor.contiguous(),
                           output_split_sizes=out_split_sizes,
                           input_split_sizes=in_split_sizes, group=pg)
    return out


def p2p_permute(tensor, perm, group=None):
    """The collective permute: ``perm`` is a list of (src, dst) pairs of
    group ranks, and each dst receives its src's ``tensor``; a rank that no
    pair names as a dst receives zeros. Point to point over
    ``batch_isend_irecv``; over one rank, the identity (zeros when ``perm``
    does not name it)."""
    if group is None:
        group = _get_default_group()
    pg, _ = _resolve(group, "p2p_permute")
    me = max(group.rank, 0)
    srcs = [s for s, d in perm if d == me]
    if pg is None:
        return tensor if srcs else torch.zeros_like(tensor)
    x = tensor.contiguous()
    out = x.clone() if (me, me) in perm else torch.zeros_like(x)
    ops = [dist.P2POp(dist.isend, x, group.ranks[d], group=pg)
           for s, d in perm if s == me and d != me]
    ops += [dist.P2POp(dist.irecv, out, group.ranks[s], group=pg)
            for s in srcs if s != me]
    if ops:
        for q in dist.batch_isend_irecv(ops):
            q.wait()
    return out


def _p2p_unsupported(name):
    raise NotImplementedError(
        f"paddle_tpu_torch.distributed.{name}: host-level eager p2p is not "
        "part of the reference, whose p2p is compiler-scheduled (p2p_permute "
        "inside shard_map, pipeline schedules); use all_gather/broadcast "
        "for a host-visible exchange")


def send(tensor, dst=0, group=None, sync_op=True):
    _p2p_unsupported("send")


def recv(tensor, src=0, group=None, sync_op=True):
    _p2p_unsupported("recv")


def isend(tensor, dst=0, group=None):
    _p2p_unsupported("isend")


def irecv(tensor, src=0, group=None):
    _p2p_unsupported("irecv")


def barrier(group=None):
    from . import watchdog

    pg, _ = _resolve(group, "barrier")
    if pg is not None:
        with watchdog.guard("barrier"):
            dist.barrier(group=pg)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until ``tensor``'s pending work on its card is done
    (the reference's ``block_until_ready``), under the watchdog's
    deadline."""
    from . import watchdog

    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        with watchdog.guard("wait"):
            torch.cuda.current_stream(tensor.device).synchronize()


# -- the record of launched collectives (auto-parallel's plan cost) ----------
def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _first(a, k):
    return a[0] if a else next(iter(k.values()), None)


def _out_list(a, k):
    return sum(_nbytes(t) for t in (_first(a, k) or ()))


def _p2p_recv(a, k):
    return sum(_nbytes(op.tensor) for op in (_first(a, k) or ())
               if getattr(op.op, "__name__", "") == "irecv")


# torch.distributed function -> (kind, bytes it produces)
_RECORDED = {
    "all_reduce": ("all-reduce", lambda a, k: _nbytes(_first(a, k))),
    "all_gather": ("all-gather", _out_list),
    "all_gather_into_tensor": ("all-gather",
                               lambda a, k: _nbytes(_first(a, k))),
    "reduce_scatter": ("reduce-scatter", lambda a, k: _nbytes(_first(a, k))),
    "reduce_scatter_tensor": ("reduce-scatter",
                              lambda a, k: _nbytes(_first(a, k))),
    "all_to_all": ("all-to-all", _out_list),
    "all_to_all_single": ("all-to-all", lambda a, k: _nbytes(_first(a, k))),
    "batch_isend_irecv": ("collective-permute", _p2p_recv),
    "broadcast": ("broadcast", lambda a, k: _nbytes(_first(a, k))),
    "reduce": ("reduce", lambda a, k: _nbytes(_first(a, k))),
    "scatter": ("scatter", lambda a, k: _nbytes(_first(a, k))),
}


@contextlib.contextmanager
def record():
    """Log ``(kind, bytes)`` for every collective launched in the block,
    wherever it is called from (the port's modules call ``torch.distributed``
    through its module attributes, which the block wraps). Yields the list;
    not for concurrent use from two threads."""
    log = []
    saved = {}

    def wrap(fn, kind, size):
        def recorded(*a, **k):
            log.append((kind, int(size(a, k))))
            return fn(*a, **k)
        return recorded

    for name, (kind, size) in _RECORDED.items():
        fn = getattr(dist, name, None)
        if fn is not None:
            saved[name] = fn
            setattr(dist, name, wrap(fn, kind, size))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def split(x, num_partitions, axis=0, group=None):
    from ..ops.manipulation import split as _split

    return _split(x, num_partitions, axis)


# -- quantized collectives (EQuARX, arXiv:2506.17615) ------------------------
# Blockwise-scaled int8 compression around the DP gradient collectives: each
# `block`-element tile carries one f32 scale (amax/127), so the wire payload
# drops ~4x against f32. The bucket layer (fleet/grad_buckets.py) hands in
# flat inputs whose length divides into nranks shards of whole blocks.

def blockwise_quantize(flat, block=128):
    """flat (m,) float -> (q int8 (m/block, block), scale f32 (m/block, 1)).
    m must be a multiple of block."""
    xb = flat.float().reshape(-1, block)
    scale = torch.clamp_min(xb.abs().amax(dim=1, keepdim=True), 1e-30) / 127.0
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def blockwise_dequantize(q, scale, dtype=torch.float32):
    return (q.float() * scale).reshape(-1).to(dtype)


def quantized_psum_scatter_mean(flat, group=None, nranks=None, block=128):
    """Quantized reduce-scatter-mean of ``flat`` (padded,) over the group:
    each rank compresses its bucket blockwise to int8 and all-to-alls, so
    rank i collects every rank's version of shard i; dequantize, sum and
    divide by n. Returns ``(shard (padded/n,) f32, err (padded,) f32)``,
    ``err`` the local compression residual."""
    pg, n = _resolve(group, "quantized_psum_scatter_mean")
    n = int(nranks or n)
    s = flat.shape[0] // n
    q, scale = blockwise_quantize(flat, block)
    err = flat.float() - blockwise_dequantize(q, scale)
    qs = q.reshape(n, s // block, block)
    ss = scale.reshape(n, s // block, 1)
    if pg is not None:
        qt, st = torch.empty_like(qs), torch.empty_like(ss)
        dist.all_to_all_single(qt, qs.contiguous(), group=pg)
        dist.all_to_all_single(st, ss.contiguous(), group=pg)
    else:
        qt, st = qs, ss
    shard = torch.sum(qt.float() * st, dim=0).reshape(-1) / n
    return shard, err


def quantized_all_reduce_mean(flat, group=None, nranks=None, block=128):
    """Quantized all-reduce-mean: the quantized reduce-scatter, then the
    reduced shard re-quantized and all-gathered (both wire phases int8 and
    scales). Returns ``(mean (padded,) f32, err (padded,) f32)``."""
    pg, _ = _resolve(group, "quantized_all_reduce_mean")
    shard, err = quantized_psum_scatter_mean(flat, group, nranks, block)
    q2, s2 = blockwise_quantize(shard, block)
    if pg is not None:
        qg = all_gather_into_tensor(None, q2.reshape(-1), group)
        sg = all_gather_into_tensor(None, s2.reshape(-1), group)
    else:
        qg, sg = q2.reshape(-1), s2.reshape(-1)
    out = blockwise_dequantize(qg.reshape(-1, block), sg.reshape(-1, 1))
    return out, err


# -- model-parallel helper prims (reference collective.py:364-444) -----------
def _mp(group, what):
    """The group's (process group, size) for a helper; None for the
    single-rank identity."""
    if group is None:
        return None
    pg, n = _resolve(group, what)
    return None if n == 1 else (pg, n, group.rank)


def _sum(t, pg):
    t = t.contiguous().clone()
    dist.all_reduce(t, group=pg)
    return t


def _gather_last(t, pg, n):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=pg)
    return torch.cat(parts, dim=-1)


def _shard_last(t, n, r):
    size = t.shape[-1] // n
    return t[..., r * size:(r + 1) * size].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.pg), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _sum(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, r):
        ctx.pg, ctx.n = pg, n
        return _shard_last(x, n, r)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.pg, ctx.n), None, None, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, r):
        ctx.n, ctx.r = n, r
        return _gather_last(x, pg, n)

    @staticmethod
    def backward(ctx, g):
        return _shard_last(g, ctx.n, ctx.r), None, None, None


def _c_identity(tensor, group=None):
    """Forward identity; backward all-reduce (column-parallel input)."""
    m = _mp(group, "_c_identity")
    return tensor if m is None else _Identity.apply(tensor, m[0])


def _mp_allreduce(tensor, group=None):
    """Forward all-reduce; backward identity (row-parallel output)."""
    m = _mp(group, "_mp_allreduce")
    return tensor if m is None else _AllReduce.apply(tensor, m[0])


def _c_split(tensor, group=None):
    """This rank's shard of the last axis (forward); all-gather (backward)."""
    m = _mp(group, "_c_split")
    return tensor if m is None else _Split.apply(tensor, *m)


def _c_concat(tensor, group=None):
    """All-gather along the last axis (forward); this rank's shard of the
    gradient (backward)."""
    m = _mp(group, "_c_concat")
    return tensor if m is None else _Concat.apply(tensor, *m)


class _ShardedCE(torch.autograd.Function):
    """Vocab-sharded softmax cross-entropy (reference collective.py:1032 and
    c_softmax_with_cross_entropy_op.cu): per-rank partial max and sum are
    all-reduced, the label's log-probability comes from the one rank whose
    shard holds it; a label on no rank's shard (``ignore_index``) gives 0
    and no gradient."""

    @staticmethod
    def forward(ctx, x, label, pg, r):
        xf = x.float()
        gmax = xf.amax(dim=-1, keepdim=True)
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=pg)
        ex = torch.exp(xf - gmax)
        gsum = ex.sum(dim=-1, keepdim=True)
        dist.all_reduce(gsum, group=pg)
        logp = xf - gmax - torch.log(gsum)
        vshard = x.shape[-1]
        lab = label.long()
        if lab.dim() == x.dim():
            lab = lab.squeeze(-1)
        local = lab - r * vshard
        in_range = (local >= 0) & (local < vshard)
        safe = local.clamp(0, vshard - 1)
        picked = torch.gather(logp, -1, safe.unsqueeze(-1)).squeeze(-1)
        loss = torch.where(in_range, -picked, torch.zeros_like(picked))
        dist.all_reduce(loss, group=pg)
        # rows whose label is on some rank's shard take the gradient
        valid = in_range.to(torch.float32)
        dist.all_reduce(valid, group=pg)
        ctx.save_for_backward(ex / gsum, safe, in_range, valid)
        ctx.dtype = x.dtype
        return loss.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        soft, safe, in_range, valid = ctx.saved_tensors
        onehot = torch.zeros_like(soft).scatter_(
            -1, safe.unsqueeze(-1), in_range.unsqueeze(-1).to(soft.dtype))
        d = (soft - onehot) * (g.float() * valid).unsqueeze(-1)
        return d.to(ctx.dtype), None, None, None


def _c_softmax_with_cross_entropy(logits, label, group=None,
                                  ignore_index=-100):
    """Per-row softmax cross-entropy of logits whose class axis is sharded
    over the group (this rank holds its contiguous shard); rows labelled
    ``ignore_index`` give 0."""
    m = _mp(group, "_c_softmax_with_cross_entropy")
    if m is None:
        from ..nn.functional.loss import cross_entropy

        return cross_entropy(logits, label, reduction="none",
                             ignore_index=ignore_index)
    return _ShardedCE.apply(logits, label, m[0], m[2])


# -- sequence-parallel autograd collectives ----------------------------------
def _peers(group, step):
    """World ranks this rank sends to and receives from when every rank
    passes its tensor ``step`` places down the group's ring."""
    n, r = group.nranks, group.rank
    return group.ranks[(r - step) % n], group.ranks[(r + step) % n]


def _shift(x, group, step):
    pg, _ = _resolve(group, "_ring_shift")
    dst, src = _peers(group, step)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group=pg),
                                   dist.P2POp(dist.irecv, out, src, group=pg)])
    for q in reqs:
        q.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _ring_shift(x, group):
    """Rank i's ``x`` lands on rank i - 1 (mod n), differentiable; the
    identity over one rank."""
    if group is None or group.nranks == 1:
        return x
    return _RingShift.apply(x, group)


def _a2a(x, group, split_axis, concat_axis):
    pg, n = _resolve(group, "_all_to_all_tiled")
    parts = [t.contiguous() for t in x.chunk(n, dim=split_axis)]
    outs = [torch.empty_like(t) for t in parts]
    dist.all_to_all(outs, parts, group=pg)
    return torch.cat(outs, dim=concat_axis)


class _AllToAllTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _a2a(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _a2a(g, group, concat_axis, split_axis), None, None, None


def _all_to_all_tiled(x, group, split_axis, concat_axis):
    """The tiled all-to-all: ``x`` split in n equal parts along
    ``split_axis``, part j sent to rank j, the parts received concatenated
    along ``concat_axis`` in rank order; the backward is the reverse
    exchange. The identity over one rank."""
    if group is None or group.nranks == 1:
        return x
    return _AllToAllTiled.apply(x, group, split_axis, concat_axis)


def _gather_axis(x, group, axis):
    pg, n = _resolve(group, "_all_gather_tiled")
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat(parts, dim=axis)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis)
        return _gather_axis(x, group, axis)

    @staticmethod
    def backward(ctx, g):
        group, axis = ctx.args
        pg, n = _resolve(group, "_all_gather_tiled")
        parts = [t.contiguous() for t in g.chunk(n, dim=axis)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=pg)
        return out, None, None


def _all_gather_tiled(x, group, axis):
    """Every rank's ``x`` concatenated along ``axis`` in rank order; the
    backward reduce-scatters the sum. The identity over one rank."""
    if group is None or group.nranks == 1:
        return x
    return _AllGatherTiled.apply(x, group, axis)
