"""The train step (port of ``paddle_tpu/jit/__init__.py``
``compile_train_step`` / ``CompiledTrainStep``).

The reference traces forward, backward and the optimizer update into one
XLA executable. PyTorch runs eagerly, so "compiled" is the reference's name
only here: one call clears the gradients, runs ``loss_fn(model, *batch)``,
its ``backward()`` and the optimizer update, and returns the loss tensor
without a host sync, so consecutive steps queue on the card's stream.
Capturing the step in a CUDA graph is later work.
"""
from __future__ import annotations

import torch

from ..core.place import resolve_device
from ..profiler import span

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

    def _as_tensor(self, b):
        return b if isinstance(b, torch.Tensor) \
            else torch.as_tensor(b, device=self._device)

    def __call__(self, *batch):
        with span("train_step", step=self._step_count):
            self.optimizer.clear_grad(set_to_zero=False)
            loss = self.loss_fn(self.model,
                                *(self._as_tensor(b) for b in batch))
            loss.backward()
            self.optimizer.step()
            self._step_count += 1
            return loss.detach()


def compile_train_step(model, loss_fn, optimizer) -> CompiledTrainStep:
    return CompiledTrainStep(model, loss_fn, optimizer)
