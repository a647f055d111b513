"""The train step (port of ``paddle_tpu/jit/__init__.py``
``compile_train_step`` / ``CompiledTrainStep``).

The reference traces forward, backward and the optimizer update into one
XLA executable. PyTorch runs eagerly, so "compiled" is the reference's name
only here: one call clears the gradients, runs ``loss_fn(model, *batch)``,
its ``backward()`` and the optimizer update, and returns the loss tensor
without a host sync, so consecutive steps queue on the card's stream.
Capturing the step in a CUDA graph is later work.

The update is the reference's compiled one, which differs from its eager
``Optimizer.step()``: the reference's ``CompiledTrainStep`` calls
``_functional_update`` without the parameters, so it applies no
``grad_clip``, decays every parameter whatever ``apply_decay_param_fun``
says, and ignores the per-parameter lr scale. The port keeps both
behaviours, since each is held against the reference: ``step()`` for the
eager loop, ``Optimizer._step(functional=True)`` here.

With ``FLAGS_check_nan_inf`` set, a call raises ``TypeError``, as the
reference's traced step does (``core/dispatch.py``).

Under ``FLAGS_hbm_admission`` ``warn`` or ``enforce`` the step is admitted
as the reference's lazy flush is (``fault/memory.py``): the first two calls
of a signature (the batch's shapes and dtypes) measure its footprint
(``cost_model.MeasuredStep``; on the card this resets the allocator's peak
statistics; the first builds the state the second finds in place, see
``cost_model.MEASURED_CALLS``), and every later call is admitted with the
second's numbers: it runs ``fault.memory.preflight`` before it
clears the gradients or launches anything, so an ``enforce`` rejection
leaves the parameters, gradients, optimizer state, step counts and RNG
stream as they were and the same call can simply be made again. With the
flag ``off`` the cost is one flag probe and ``fault.memory`` is never
reached.

Each call is one ``train_step`` span. Under ``Profiler(profile_memory=True)``
or ``FLAGS_profile_memory`` the step ends with a memory census
(``profiler.memory_census``) whose ``live_bytes``, ``live_arrays``,
``peak_live_bytes`` and ``delta_bytes`` become the span's attrs, as the
reference's lazy flush sets them; on the card the census reads the caching
allocator's counters and adds no host sync.
"""
from __future__ import annotations

import torch

from .. import profiler
from ..core.place import resolve_device
from ..framework.flags import flag

__all__ = ["CompiledTrainStep", "compile_train_step"]


class CompiledTrainStep:
    def __init__(self, model, loss_fn, optimizer):
        params = list(model.parameters())
        if not params:
            raise ValueError("compile_train_step: the model has no parameters")
        # raises when the model sits on a card this process cannot reach
        self._device = resolve_device(params[0].device)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._step_count = 0
        # step signature -> (calls measured, the last footprint): admission
        self._mem = {}

    def _as_tensor(self, b):
        return b if isinstance(b, torch.Tensor) \
            else torch.as_tensor(b, device=self._device)

    def __call__(self, *batch):
        if flag("FLAGS_check_nan_inf", False):
            # the reference's step is traced, and its nan/inf scan cannot
            # read a traced value: every call raises jax's
            # TracerBoolConversionError (a TypeError) while the flag is set
            raise TypeError(
                "compile_train_step: FLAGS_check_nan_inf cannot scan a "
                "compiled train step, whose values are traced in the "
                "reference; clear the flag or run the eager loop")
        with profiler.span("train_step", step=self._step_count) as sp:
            batch = [self._as_tensor(b) for b in batch]
            if flag("FLAGS_hbm_admission", "off") != "off":
                loss = self._admitted(sp, batch)
            else:
                loss = self._run(batch)
            if profiler._memory_active():
                mem = profiler.memory_census(self._device)
                sp.set(live_bytes=mem["live_bytes"],
                       live_arrays=mem["live_arrays"],
                       peak_live_bytes=mem["peak_live_bytes"],
                       delta_bytes=mem["last_delta_bytes"])
            return loss.detach()

    def _run(self, batch):
        self.optimizer.clear_grad(set_to_zero=False)
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer._step(functional=True)
        self._step_count += 1
        return loss

    def _admitted(self, sp, batch):
        """The step under HBM admission: measured on its signature's first
        ``MEASURED_CALLS`` calls, admitted by ``preflight`` before every
        later one."""
        from ..cost_model import MEASURED_CALLS, MeasuredStep
        from ..fault import memory as _hbm

        sig = ("train_step",) + tuple(
            (tuple(b.shape), str(b.dtype)) for b in batch)
        calls, mem = self._mem.get(sig, (0, None))
        if calls >= MEASURED_CALLS:
            _hbm.preflight(mem, "train_step", span=sp, device=self._device)
            return self._run(batch)
        with MeasuredStep(self._device) as run:
            loss = self._run(batch)
        mem = _hbm.analyze_compiled(
            run, key=f"train_step:{hash(sig) & 0xFFFFFFFFFFFFFFFF:016x}")
        self._mem[sig] = (calls + 1, mem)
        if mem is not None:
            sp.set(hbm_exec_peak_bytes=mem["peak_bytes"])
        return loss


def compile_train_step(model, loss_fn, optimizer) -> CompiledTrainStep:
    return CompiledTrainStep(model, loss_fn, optimizer)
