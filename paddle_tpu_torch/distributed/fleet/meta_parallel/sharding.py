"""ZeRO sharding, stages 1 and 2 (port of
``paddle_tpu/distributed/fleet/meta_parallel/sharding.py:32–174``).

The reference states a stage as layouts: optimizer state (stage 1) and
gradients (stage 2) carry a spec over the ``sharding`` mesh axis on the
dimension ``shard_spec_for`` picks (the first one the group's size
divides), and GSPMD partitions the update. The port runs one process a
rank and does the exchange itself, parameter by parameter, in the
optimizer's step:

* stage 1 (``ShardingOptimizerStage1``) all-reduces each gradient (mean)
  over the sharding group, then updates this rank's slice of the parameter
  along that dimension with this rank's slice of each moment, so a rank
  holds 1/n of the optimizer state of every shardable parameter;
* stage 2 (``ShardingStage2`` over a stage-1 optimizer) reduce-scatters the
  gradient along that dimension instead, so only the rank's slice of it is
  reduced;
* both then all-gather the updated parameter.

A parameter no dimension of which the group's size divides, and every
parameter of a rule that is not elementwise (``Lamb``, ``LarsMomentum``
need whole-parameter norms), is updated whole on every rank from the
all-reduced gradient. ``state_dict()`` gathers the moments into their
logical shapes (a collective: every rank calls it); ``set_state_dict``
keeps this rank's slices. ``group_sharded_parallel`` takes ``"os"`` and
``"os_g"`` and ``"p_g_os"``.

ZeRO-3 (``ShardingStage3``) shards the parameters themselves: at rest each
rank holds only its slice of every parameter along ``shard_spec_for``'s
dimension (the ``Parameter`` object keeps its identity, so an optimizer
built on the model updates the slices and its moments come out
slice-sized). Each call into the model (its ``forward``, or a method read
through the wrapper, such as ``loss``) swaps in every parameter gathered
by ``_GatherParam``: an all-gather in the forward, and in the backward a
reduce-scatter that takes the mean of the full gradient over the group,
so ``.grad`` is slice-shaped. Autograd keeps the gathered tensors its
backward needs until it runs; the wrapper keeps none after the call. A
parameter that no dimension of the group's size divides stays whole, and
its gradient is all-reduced (mean) by ``_MeanGrad``. Each slice carries
``zero3_group``, over which the global-norm clip, ``ClipGradByNorm`` and
the norms of ``Lamb`` and ``LarsMomentum`` sum their squares.
``get_all_parameters()`` and ``state_dict()`` gather the logical tensors
(collectives: every rank calls them). ``offload`` is accepted and ignored,
as the reference's is. Over a group of one rank nothing is sliced or
wrapped.
"""
from __future__ import annotations

import torch

from ....nn.clip import ClipGradByNorm
from ....nn.layer.layers import Layer
from ... import collective as C
from .parallel_wrappers import _MetaParallelBase


def _largest_divisible_dim(shape, n):
    for i, s in enumerate(shape):
        if s % n == 0 and s >= n:
            return i
    return None


def shard_spec_for(p, axis_name: str, n: int) -> tuple:
    """The reference's spec: ``axis_name`` on the first dimension ``n``
    divides (the flat reference partitions dim 0 first), None elsewhere;
    all None when no dimension divides."""
    dim = _largest_divisible_dim(tuple(p.shape), n)
    spec = [None] * len(p.shape)
    if dim is not None:
        spec[dim] = axis_name
    return tuple(spec)


def _shard_dim(p, n):
    return None if n <= 1 else _largest_divisible_dim(tuple(p.shape), n)


class ShardingOptimizerStage1:
    """Wraps an optimizer; its state is sharded over the sharding group
    (``group``, default the hybrid communicate group's). Attributes it lacks
    are the inner optimizer's."""

    def __init__(self, optimizer, hcg=None, group=None):
        self.inner = optimizer
        self._hcg = hcg
        self.group = group or (hcg.get_sharding_parallel_group()
                               if hcg is not None else None)
        self._parameter_list = optimizer._parameter_list
        self._reduce_scatter = False  # ZeRO-2 turns it on

    def __getattr__(self, name):
        if name == "inner":
            raise AttributeError(name)
        return getattr(self.inner, name)

    @property
    def _step_count(self):
        return self.inner._step_count

    @_step_count.setter
    def _step_count(self, v):
        self.inner._step_count = v

    def _n_rank(self):
        g = self.group
        n = g.nranks if g is not None else 1
        return n, (max(g.rank, 0) if g is not None else 0)

    def _dim(self, p, n):
        if not getattr(self.inner, "_elementwise_rule", False):
            return None
        return _shard_dim(p, n)

    def step(self):
        self._step(functional=False)

    def clear_grad(self, *a, **k):
        self.inner.clear_grad()

    clear_gradients = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``loss.backward()``, then this optimizer's sharded ``step``."""
        loss.backward()
        self.step()
        return None, None

    def get_lr(self):
        return self.inner.get_lr()

    def set_lr(self, value):
        self.inner.set_lr(value)

    def set_lr_scheduler(self, scheduler):
        self.inner.set_lr_scheduler(scheduler)

    @torch.no_grad()
    def _step(self, functional: bool, with_params: bool = False) -> None:
        """The inner optimizer's ``_step`` on this rank's slices: exchange
        the gradients, clip (eager step), update, all-gather."""
        opt = self.inner
        n, r = self._n_rank()
        opt._step_count += 1
        live = [i for i, p in enumerate(opt._parameter_list)
                if p.requires_grad and p.grad is not None]
        pg, views, sharded = [], [], set()
        for i in live:
            p = opt._parameter_list[i]
            g, dim = p.grad, self._dim(p, n)
            if n > 1 and dim is not None and self._reduce_scatter:
                parts = [t.contiguous() for t in g.chunk(n, dim=dim)]
                g = torch.empty_like(parts[0])
                C.reduce_scatter(g, parts, C.ReduceOp.AVG, self.group)
                sharded.add(i)
            elif n > 1:
                g = C.all_reduce(g.clone(), C.ReduceOp.AVG, self.group)
            pg.append((p, g))
        clip = opt._grad_clip
        if clip is not None and not functional:
            if sharded and isinstance(clip, ClipGradByNorm):
                raise NotImplementedError(
                    "ClipGradByNorm over reduce-scattered (ZeRO-2) "
                    "gradients: each rank holds a slice of the tensor")
            pg = clip(pg, sharded=sharded, shard_group=self.group) \
                if sharded else clip(pg)
        slices = []
        for i, (p, g) in zip(live, pg):
            dim = self._dim(p, n)
            if n > 1 and dim is not None:
                size = p.shape[dim] // n
                view = p.narrow(dim, r * size, size)
                gs = g if i in sharded else g.narrow(dim, r * size, size)
                slices.append((view, gs))
                views.append((p, view, dim))
            else:
                slices.append((p, g))
        opt._apply_updates(live, slices, functional, with_params)
        for p, view, dim in views:
            p.copy_(C.all_gather_into_tensor(None, view.contiguous(),
                                             self.group, concat_axis=dim))

    def state_dict(self):
        """The inner optimizer's state with every moment in its logical
        shape (gathered over the group)."""
        opt = self.inner
        sd = opt.state_dict()
        n, _ = self._n_rank()
        for name, p in zip(opt._names, opt._parameter_list):
            dim = self._dim(p, n)
            if n == 1 or dim is None:
                continue
            for k, v in opt._accumulators.get(name, {}).items():
                if tuple(v.shape) != tuple(p.shape):
                    sd[f"{name}.{k}"] = C.all_gather_into_tensor(
                        None, v.contiguous(), self.group, concat_axis=dim)
        return sd

    def set_state_dict(self, state_dict):
        """Load a logical state, keeping this rank's slice of each moment."""
        opt = self.inner
        n, r = self._n_rank()
        sd = dict(state_dict)
        for name, p in zip(opt._names, opt._parameter_list):
            dim = self._dim(p, n)
            if n == 1 or dim is None:
                continue
            size = p.shape[dim] // n
            for key in [k for k in sd if isinstance(k, str)
                        and k.startswith(f"{name}.")]:
                v = torch.as_tensor(sd[key])
                if tuple(v.shape) == tuple(p.shape):
                    sd[key] = v.narrow(dim, r * size, size).clone()
        opt.set_state_dict(sd)

    load_state_dict = set_state_dict


DygraphShardingOptimizer = ShardingOptimizerStage1


class ShardingStage2(_MetaParallelBase):
    """ZeRO-2: the model, whose stage-1 optimizer reduce-scatters the
    gradients along each parameter's shard dimension (reference
    sharding.py:95)."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 buffer_max_size=2**23, device=None):
        super().__init__(layer, None, None)
        self.group = group
        if isinstance(optimizer, ShardingOptimizerStage1):
            optimizer._reduce_scatter = True
            self._optim = optimizer
        elif optimizer is not None:
            raise TypeError("ShardingStage2 takes a ShardingOptimizerStage1 "
                            "(group_sharded_parallel builds one)")


class _GatherParam(torch.autograd.Function):
    """A parameter's slice -> the whole parameter (all-gather along
    ``dim``); the backward reduce-scatters the mean of the gradient."""

    @staticmethod
    def forward(ctx, p, group, dim):
        ctx.args = (group, dim)
        return C.all_gather_into_tensor(None, p.detach(), group,
                                        concat_axis=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        parts = [t.contiguous() for t in g.chunk(group.nranks, dim=dim)]
        out = torch.empty_like(parts[0])
        C.reduce_scatter(out, parts, C.ReduceOp.AVG, group)
        return out, None, None


class _MeanGrad(torch.autograd.Function):
    """The identity; the backward averages the gradient over the group."""

    @staticmethod
    def forward(ctx, p, group):
        ctx.group = group
        return p.detach().clone()

    @staticmethod
    def backward(ctx, g):
        return C.all_reduce(g.contiguous().clone(), C.ReduceOp.AVG,
                            ctx.group), None


class ShardingStage3(_MetaParallelBase):
    """ZeRO-3: the parameters themselves sharded over ``group`` (default
    the hybrid communicate group's sharding group); reference
    sharding.py:135. See the module docstring."""

    def __init__(self, layer, optimizer=None, group=None, sync_buffers=False,
                 segment_size=2**20, offload=False, device=None):
        super().__init__(layer, None, None)
        if group is None:
            from ..base.fleet_base import get_hybrid_communicate_group

            hcg = get_hybrid_communicate_group()
            group = hcg.get_sharding_parallel_group() \
                if hcg is not None else None
        self.group = group
        self.offload = offload
        if optimizer is not None:
            self._optim = optimizer
        n = group.nranks if group is not None else 1
        r = max(group.rank, 0) if group is not None else 0
        # (module, name, parameter) of every registration of a parameter
        self._held = []
        if n == 1:
            return
        for mod in layer.modules():
            for name, p in list(mod._parameters.items()):
                if p is None:
                    continue
                if getattr(p, "zero3_group", None) is not group:
                    dim = _shard_dim(p, n)
                    if dim is not None:
                        size = p.shape[dim] // n
                        p.data = p.data.narrow(dim, r * size, size).clone()
                    p.zero3_group, p.zero3_dim = group, dim
                self._held.append((mod, name, p))

    def _gathered(self):
        """Swap every held parameter for its gathered tensor; returns the
        undo list."""
        full, undo = {}, []
        for mod, name, p in self._held:
            dim = p.zero3_dim
            if id(p) not in full:
                if not p.requires_grad:
                    full[id(p)] = p if dim is None else \
                        C.all_gather_into_tensor(None, p.detach(),
                                                 self.group, concat_axis=dim)
                elif dim is None:
                    full[id(p)] = _MeanGrad.apply(p, self.group)
                else:
                    full[id(p)] = _GatherParam.apply(p, self.group, dim)
            mod._parameters[name] = full[id(p)]
            undo.append((mod, name, p))
        return undo

    @staticmethod
    def _restore(undo):
        for mod, name, p in undo:
            mod._parameters[name] = p

    def _call(self, fn, *args, **kwargs):
        if not self._held:
            return fn(*args, **kwargs)
        undo = self._gathered()
        try:
            return fn(*args, **kwargs)
        finally:
            self._restore(undo)

    def forward(self, *inputs, **kwargs):
        return self._call(self._layers, *inputs, **kwargs)

    def __getattr__(self, name):
        attr = super().__getattr__(name)
        layers = self.__dict__["_modules"].get("_layers")
        if callable(attr) and not isinstance(attr, torch.nn.Module) \
                and getattr(attr, "__self__", None) is layers:
            return lambda *a, **k: self._call(attr, *a, **k)
        return attr

    @torch.no_grad()
    def get_all_parameters(self):
        """Every parameter of the model in its logical shape (a collective
        over the group)."""
        out = []
        for p in self._layers.parameters():
            dim = getattr(p, "zero3_dim", None)
            out.append(p.detach() if dim is None or not self._held else
                       C.all_gather_into_tensor(None, p.detach(), self.group,
                                                concat_axis=dim))
        return out

    @torch.no_grad()
    def state_dict(self, *args, **kwargs):
        """The model's state with every parameter gathered into its
        logical shape (a collective over the group)."""
        sd = self._layers.state_dict(*args, **kwargs)
        if not self._held:
            return sd
        params = dict(self._layers.named_parameters(remove_duplicate=False))
        for k, v in sd.items():
            dim = getattr(params.get(k), "zero3_dim", None)
            if dim is not None:
                sd[k] = C.all_gather_into_tensor(None, v.contiguous(),
                                                 self.group, concat_axis=dim)
        return sd


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False):
    """``paddle.distributed.sharding.group_sharded_parallel``: ``"os"``
    shards the optimizer state, ``"os_g"`` the gradients too, and
    ``"p_g_os"`` the parameters (``ShardingStage3``, with the raw
    optimizer). ``group`` defaults to the hybrid communicate group's
    sharding group."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError(f"unknown sharding level {level}")
    if group is None:
        from ..base.fleet_base import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        group = hcg.get_sharding_parallel_group() if hcg is not None else None
    if level == "p_g_os":
        model = ShardingStage3(model, optimizer, group=group, offload=offload)
        return model, optimizer, scaler
    opt = ShardingOptimizerStage1(optimizer, group=group)
    if level == "os_g":
        model = ShardingStage2(model, opt, group=group)
    return model, opt, scaler


__all__ = ["shard_spec_for", "ShardingOptimizerStage1",
           "DygraphShardingOptimizer", "ShardingStage2", "ShardingStage3",
           "group_sharded_parallel"]
