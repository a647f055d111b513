"""Pipeline-parallel training (port of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

The reference runs every stage inside one ``shard_map`` over the ``pp``
mesh axis and moves activations with ``lax.ppermute``. The port runs one
process a stage: each rank holds its stage of a ``PipelineLayer`` and runs
it eagerly. Activations go downstream and cotangents upstream by
point-to-point ``torch.distributed`` operations over the pp group; each
exchange posts its sends and receives together (``batch_isend_irecv``) in
the same order on every rank. These stay inside the schedule: the public
``send``/``recv`` raise, as the reference's do.

Two schedules, one micro-batch a step of either:

* ``"1F1B"`` (the default): stage ``s`` of ``S`` runs ``S - 1 - s``
  warm-up forwards, then alternates one forward and one backward, then
  drains the rest. A stage's forward keeps its output with its autograd
  graph, and that micro-batch's backward (``torch.autograd.backward(out,
  grad)`` with the cotangent received from downstream) runs ``2(S-1-s)``
  forward and backward steps later. At most ``S - s`` micro-batches are
  stashed on stage ``s``, whatever ``n_micro`` is
  (``stash_high_water``).
* ``"F-then-B"`` (GPipe): every forward, then every backward, so all
  ``n_micro`` graphs are live at once.

Both run the backwards in micro-batch order and accumulate as the engine
does: the last stage's loss is scaled by ``1 / n_micro`` before its
backward and ``.grad`` accumulates in the parameter's dtype, so at one
stage each schedule gives the bits of ``HybridParallelEngine`` at
``grad_accumulate=n_micro``. The returned loss is the mean of the
micro-batch losses, summed in f32 on the last stage and broadcast over the
pp group. Before the update the copies of each ``SharedLayerDesc`` key sum
their gradients over their group (the reference's ``psum`` over ``pp``),
and at dp > 1 the gradients and the loss are averaged over the
data-parallel group (each dp rank passes its own dim-0 shard of the
batch). The update is the reference's ``_functional_update(...,
params=params)``: ``Optimizer._step(functional=True, with_params=True)``,
with the decay gate and the lr scale and no clip.

The carrier (the activation between stages) is stage 0's output: stage 0
runs one forward without gradients on the first micro-batch of each new
input shape and broadcasts its shape and dtype; each middle stage runs one
on zeros of that shape, and a stage that changes it raises the
reference's ``ValueError`` on every rank. Stage outputs are cast to the
carrier's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ....nn.layer.layers import Layer
from ... import collective as C
from ...mesh import global_mesh


def _loss_of(loss_fn, out, labels):
    return loss_fn(out, labels) if loss_fn is not None else out.mean()


class PipelineTrainStep:
    """One pipelined train step of this rank's stage of ``pipeline_layer``
    a call (see the module docstring)."""

    def __init__(self, pipeline_layer, optimizer, mesh=None, n_micro=1,
                 axis="pp", schedule="1F1B"):
        self.pl = pipeline_layer
        self.optimizer = optimizer
        self.mesh = mesh if mesh is not None else global_mesh()
        self.n_micro = int(n_micro)
        self.axis = axis
        self.schedule = str(schedule).upper().replace("-", "")
        if self.schedule not in ("1F1B", "FTHENB"):
            raise ValueError(
                f"schedule_mode must be '1F1B' or 'F-then-B', got "
                f"{schedule!r}")
        self.n_stages = pipeline_layer.num_stages
        pp_devices = dict(self.mesh.shape).get(axis, 1)
        if self.n_stages != pp_devices:
            raise ValueError(
                f"PipelineLayer has {self.n_stages} stages but mesh axis "
                f"'{axis}' has {pp_devices} devices; they must match")
        self.group = pipeline_layer._pp_group
        if self.n_stages > 1 and self.group is None:
            raise ValueError(
                f"a PipelineLayer of {self.n_stages} stages runs one stage a "
                "rank: build it after fleet.init with pp_degree = "
                f"{self.n_stages}")
        self.stage = pipeline_layer._stage_id
        self.params = [p for p in pipeline_layer.parameters()
                       if p.requires_grad]
        from ..base.fleet_base import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        self._dp_group = hcg.get_data_parallel_group() if hcg is not None \
            and hcg.get_data_parallel_world_size() > 1 else None
        self._carriers = {}  # (micro-batch shape, dtype) -> (shape, dtype)
        self._buckets = {}  # the dp sync's bucket plan
        self.stash_high_water = 0  # most micro-batches stashed at once

    # -- point to point ------------------------------------------------------
    def _exchange(self, sends=(), recvs=()):
        """Post ``sends`` ((tensor, stage)) and the receives ``recvs``
        ((shape, dtype, stage)) together and wait for all; the received
        tensors, in order."""
        pg, ranks = self.group.process_group(), self.group.ranks
        ops, bufs = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), ranks[peer],
                                  pg))
        for shape, dtype, peer in recvs:
            b = torch.empty(shape, dtype=dtype, device=self._device)
            bufs.append(b)
            ops.append(dist.P2POp(dist.irecv, b, ranks[peer], pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return bufs

    def _carrier(self, ids0):
        """(shape, dtype) of the activation between stages, probed once
        for each micro-batch shape (see the module docstring)."""
        key = (tuple(ids0.shape), ids0.dtype)
        if key in self._carriers:
            return self._carriers[key]
        S, s = self.n_stages, self.stage
        pg, ranks = self.group.process_group(), self.group.ranks
        with torch.no_grad():
            box = [None]
            if s == 0:
                out = self.pl.run_stage(0, ids0)
                box = [(tuple(out.shape), out.dtype)]
                del out
            dist.broadcast_object_list(box, src=ranks[0], group=pg)
            shape, dtype = box[0]
            mid = None
            if 0 < s < S - 1:
                out = self.pl.run_stage(s, torch.zeros(
                    shape, dtype=dtype, device=self._device))
                mid = (tuple(out.shape), out.dtype)
                del out
        mids = [None] * S
        dist.all_gather_object(mids, mid, group=pg)
        for mid_s in range(1, S - 1):
            if mids[mid_s] != (shape, dtype):
                raise ValueError(
                    "pipeline stages must preserve activation shape/dtype "
                    f"between boundaries: stage0 -> {shape}/{dtype}, "
                    f"stage{mid_s} -> {mids[mid_s][0]}/{mids[mid_s][1]}")
        self._carriers[key] = (shape, dtype)
        return shape, dtype

    # -- the schedule --------------------------------------------------------
    def _schedule(self, ids_mb, lbl_mb):
        """Run this stage's forwards and backwards; the last stage's sum of
        the micro-batch losses (f32), else None."""
        S, s, n = self.n_stages, self.stage, self.n_micro
        first, last = s == 0, s == S - 1
        carrier = self._carrier(ids_mb[0]) if S > 1 else None
        loss_fn = getattr(self.pl, "_loss_fn", None)
        stash = {}  # micro-batch -> (input leaf or None, output or scaled loss)
        total = [None]

        def forward(j, x):
            if first:
                inp, x = None, ids_mb[j]
            else:
                inp = x.requires_grad_()
            with torch.enable_grad():
                out = self.pl.run_stage(s, x)
                if last:
                    loss = _loss_of(loss_fn, out, lbl_mb[j])
                    part = loss.detach().float()
                    total[0] = part if total[0] is None else total[0] + part
                    stash[j] = (inp, loss / n)
                    out = None
                else:
                    out = out.to(carrier[1])
                    stash[j] = (inp, out)
            self.stash_high_water = max(self.stash_high_water, len(stash))
            return None if out is None else out.detach()

        def backward(j, g):
            inp, out = stash.pop(j)
            if last:
                out.backward()
            else:
                torch.autograd.backward(out, g)
            return None if first else inp.grad

        def recv_fwd():
            return None if first else \
                self._exchange(recvs=[(*carrier, s - 1)])[0]

        def recv_bwd():
            return None if last else \
                self._exchange(recvs=[(*carrier, s + 1)])[0]

        def send_fwd(y):
            if not last:
                self._exchange(sends=[(y, s + 1)])

        def send_bwd(dx):
            if not first:
                self._exchange(sends=[(dx, s - 1)])

        if self.schedule == "FTHENB":
            for j in range(n):
                send_fwd(forward(j, recv_fwd()))
            for j in range(n):
                send_bwd(backward(j, recv_bwd()))
            return total[0]
        warm = min(S - 1 - s, n)
        for j in range(warm):
            send_fwd(forward(j, recv_fwd()))
        x = recv_fwd() if n > warm else None
        for i in range(n - warm):
            y = forward(warm + i, x)
            # send the activation down and take the cotangent up together
            g = None if last else self._exchange(
                sends=[(y, s + 1)], recvs=[(*carrier, s + 1)])[0]
            dx = backward(i, g)
            if i == n - warm - 1:
                send_bwd(dx)
            elif first:
                x = None
            else:
                x = self._exchange(sends=[(dx, s - 1)],
                                   recvs=[(*carrier, s - 1)])[0]
        for i in range(warm):
            send_bwd(backward(n - warm + i, recv_bwd()))
        return total[0]

    def _reduce(self, total):
        """Sum the shared keys' gradients over their stages, average the
        gradients over dp, and return the mean loss (on every rank)."""
        for key, g in self.pl._shared_groups.items():
            for p in self.pl.shared_layers[key].parameters():
                if not p.requires_grad:
                    continue
                grad = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = C.all_reduce(grad, group=g)
        loss = (total / self.n_micro) if total is not None else \
            torch.zeros((), dtype=torch.float32, device=self._device)
        if self.n_stages > 1:
            C.broadcast(loss, src=self.group.ranks[-1], group=self.group)
        if self._dp_group is not None:
            from ...parallel import sync_gradients

            sync_gradients(self.params, self._dp_group, cache=self._buckets)
            loss = C.all_reduce(loss, C.ReduceOp.AVG, self._dp_group)
        return loss

    def __call__(self, inputs, labels):
        self._device = self.params[0].device if self.params else \
            torch.device("cpu")
        ids = torch.as_tensor(inputs, device=self._device)
        lbls = torch.as_tensor(labels, device=self._device)
        b = ids.shape[0]
        if b % self.n_micro:
            raise ValueError(f"batch size {b} not divisible by "
                             f"accumulate_steps {self.n_micro}")
        mb = b // self.n_micro
        ids_mb = ids.reshape((self.n_micro, mb) + tuple(ids.shape[1:]))
        lbls_mb = lbls.reshape((self.n_micro, mb) + tuple(lbls.shape[1:]))
        opt = self.optimizer
        opt.clear_grad(set_to_zero=False)
        loss = self._reduce(self._schedule(ids_mb, lbls_mb))
        opt._step(functional=True, with_params=True)
        return loss


class PipelineParallelModel(Layer):
    """``fleet.distributed_model``'s wrapper at pp_degree > 1:
    ``train_batch(data, optimizer)`` is one ``PipelineTrainStep`` (reference
    train_batch pipeline_parallel.py:152)."""

    def __init__(self, layers, hcg, strategy):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self._hcg = hcg
        self._strategy = strategy
        self.num_stages = hcg.get_pipe_parallel_world_size()
        self.micro_batches = strategy.pipeline_configs.get(
            "accumulate_steps", 1)
        self._train_fn = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Pipelined train step. pp_degree > 1 requires a PipelineLayer;
        pp_degree == 1 runs ``CompiledTrainStep`` over the whole model and
        its loss."""
        from ....jit import CompiledTrainStep
        from .pp_layers import PipelineLayer

        inputs, labels = data
        if scaler is not None:
            raise NotImplementedError(
                "train_batch does not thread GradScaler loss scaling through "
                "the compiled pipeline step; train in bf16 (TPU-native, no "
                "scaling needed) or scale the loss inside the model's "
                "loss_fn")
        if self.num_stages > 1 and not isinstance(self._layers,
                                                  PipelineLayer):
            raise TypeError(
                "pp_degree>1 requires the model to be a PipelineLayer; got "
                f"{type(self._layers).__name__}")
        if self.num_stages > 1:
            acc = max(self.micro_batches, 1)
            mb_cfg = self._strategy.pipeline_configs.get("micro_batch_size")
            b = inputs.shape[0]
            if acc > 1 and mb_cfg and b != acc * mb_cfg:
                raise ValueError(
                    f"batch size {b} != accumulate_steps({acc}) * "
                    f"micro_batch_size({mb_cfg}); fix pipeline_configs")
            if self._train_fn is None:
                self._train_fn = PipelineTrainStep(
                    self._layers, optimizer, self._hcg.mesh, n_micro=acc,
                    axis="pp", schedule=self._strategy.pipeline_configs.get(
                        "schedule_mode", "1F1B"))
            loss = self._train_fn(inputs, labels)
        else:
            loss_fn = getattr(self._layers, "_loss_fn", None)

            def full_loss(model, x, y):
                return _loss_of(loss_fn, model(x), y)

            if self._train_fn is None:
                self._train_fn = CompiledTrainStep(self._layers, full_loss,
                                                   optimizer)
            loss = self._train_fn(inputs, labels)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss


__all__ = ["PipelineTrainStep", "PipelineParallelModel"]
