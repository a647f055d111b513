"""DataParallel (port of ``paddle_tpu/distributed/parallel.py``).

The reference's gradient averaging is compiler-inserted when its train step
runs under pjit with the batch sharded on ``dp``; ``apply_collective_grads``
is its explicit reducer path. In the port each rank runs its own process
on its own shard of the batch, so ``apply_collective_grads`` is the sync
(``sync_gradients``, which ``HybridParallelOptimizer``'s eager step calls
too):
the gradients are coalesced into reverse-backward-order flat buckets
(``fleet/grad_buckets.py``, capped at ``comm_buffer_size`` MB, else
``FLAGS_dp_bucket_bytes``) and each bucket is one all-reduce-mean over the
group (a sum divided by the group's size), or the blockwise int8
``quantized_all_reduce_mean`` under ``FLAGS_quantized_allreduce`` when the
group has more than one rank. Each parameter's gradient then views its
bucket's flat tensor, made anew each sync (so nothing is kept between
steps, and the replaced gradients are freed). Without a process group, or
in a group of one rank, the sync is the reference's single-participant
identity: the buckets are planned and counted, nothing moves.

Counters: ``dp_buckets`` (buckets synced), ``dp_all_reduces`` (bucket
all-reduces launched) and ``dp_sync_bytes`` (their payload at a ring's two
phases); spans ``dp_sync`` and one ``dp_bucket`` a bucket.
"""
from __future__ import annotations

from .. import profiler
from ..framework import flags as _flags
from ..nn.layer.layers import Layer
from . import collective as C

__all__ = ["DataParallel", "sync_gradients"]


def sync_gradients(params, group, bucket_bytes=0, cache=None):
    """Average the gradients of ``params`` over ``group``: one
    all-reduce-mean a bucket, buckets in reverse-backward order, each
    bucket ``bucket_bytes`` at most (0: ``FLAGS_dp_bucket_bytes``).
    ``cache`` is a dict the caller keeps between calls: it holds the bucket
    plan of the last call's parameters."""
    params = [p for p in params if p.requires_grad and p.grad is not None]
    if not params:
        return
    pg, n = C._resolve(group, "DataParallel")
    quant = bool(_flags.flag("FLAGS_quantized_allreduce", False)) \
        and pg is not None and n > 1
    block = int(_flags.flag("FLAGS_quantized_allreduce_block", 128))
    plan = _plan_for(params, n, block, bucket_bytes,
                     {} if cache is None else cache)
    if pg is None or n == 1:  # the single-participant identity
        profiler.counter_inc("dp_buckets", len(plan.buckets))
        return
    with profiler.span("dp_sync", buckets=len(plan.buckets), world=n,
                       quantized=quant) as ssp:
        for b in plan.buckets:
            b_params = [params[i] for i in b.indices]
            with profiler.span("dp_bucket", bytes=b.padded * b.itemsize,
                               params=len(b.indices), dtype=str(b.dtype)):
                flat = plan.flatten(b, [p.grad for p in b_params])
                if quant:
                    flat = C.quantized_all_reduce_mean(
                        flat, group, n, block)[0].to(b.dtype)
                else:
                    C.all_reduce(flat, C.ReduceOp.AVG, group)
                for p, g in zip(b_params, plan.unflatten(b, flat)):
                    p.grad = g
        sync_bytes = plan.sync_bytes(quant)
        profiler.counter_inc("dp_buckets", len(plan.buckets))
        profiler.counter_inc("dp_all_reduces", len(plan.buckets))
        profiler.counter_inc("dp_sync_bytes", sync_bytes)
        ssp.set(sync_bytes=sync_bytes)


def _plan_for(params, nranks, block, bucket_bytes, cache):
    from .fleet.grad_buckets import build_bucket_plan

    sig = (tuple(id(p) for p in params), int(nranks), int(block),
           int(bucket_bytes))
    if cache.get("sig") != sig:
        cache["plan"] = build_bucket_plan(
            params, nranks=nranks,  # pad so quantized shards divide
            bucket_bytes=bucket_bytes or _flags.flag("FLAGS_dp_bucket_bytes"),
            block=block)
        cache["sig"] = sig
    return cache["plan"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        self._comm_buffer_bytes = int(comm_buffer_size) * 1024 * 1024
        self._buckets = {}  # sync_gradients' plan of the last sync

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Bucketed gradient sync after the backward (``sync_gradients``
        over this wrapper's group)."""
        sync_gradients(self._layers.parameters(), self._group,
                       self._comm_buffer_bytes, self._buckets)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)
