"""The high-level ``Model`` API (port of ``paddle_tpu/hapi/model.py``):
``prepare``/``fit``/``evaluate``/``predict``/``save``/``load`` with
callbacks, over the eager loop (forward, ``backward()``, the optimizer's
``step()`` and ``clear_grad()``).

Batches go where the network's parameters are: ``fit``, ``evaluate`` and
``predict`` build their ``DataLoader`` with ``places`` set to that device,
and numpy inputs to the ``*_batch`` calls are moved there. Each train step
reads its loss back once (``float(loss.item())``), as the reference's
does. ``fit(stability=...)`` runs the stability sentinel's loop
(``fault/sentinel.py``): a skip withholds the update, a rollback restores
the model, the optimizer, the learning-rate schedule, the generators
(``core.random.program_rng``) and the loader position from the newest
anchor and replays with the quarantined batches skipped at the index level.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..framework.io import load as fload
from ..framework.io import save as fsave
from ..io import DataLoader
from ..metric import Metric
from .callbacks import config_callbacks


def _on(device, x):
    """``x`` as a tensor on ``device`` (a tensor moves only if it must)."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _arrays_to(obj, device):
    """A loaded state tree with its numpy arrays as tensors on ``device``."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj)).to(device)
    if isinstance(obj, dict):
        return {k: _arrays_to(v, device) for k, v in obj.items()}
    return obj


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._loss = None
        self._optimizer = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    @property
    def _device(self) -> torch.device:
        """Where the network's parameters (else its buffers) are; with
        neither, ``set_device``'s choice."""
        for t in self.network.parameters():
            return t.device
        for t in self.network.buffers():
            return t.device
        from ..core.place import resolve_device

        return resolve_device()

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is None:
            self._metrics = []
        elif isinstance(metrics, (list, tuple)):
            self._metrics = list(metrics)
        else:
            self._metrics = [metrics]

    # -- single-batch ops --------------------------------------------------
    def _forward(self, inputs, labels):
        dev = self._device
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = [] if labels is None else (
            labels if isinstance(labels, (list, tuple)) else [labels])
        labels = [_on(dev, lab) for lab in labels]
        outputs = self.network(*[_on(dev, i) for i in inputs])
        outs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        return outs, labels

    def _loss_of(self, outs, labels):
        loss = self._loss(*(outs + labels))
        return loss if isinstance(loss, torch.Tensor) else loss[0]

    def _update_metrics(self, outs, labels):
        metrics = []
        for m in self._metrics:
            m.update(m.compute(outs[0], *labels))
            metrics.append(m.accumulate())
        return metrics

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        outs, labels = self._forward(inputs, labels)
        loss_t = self._loss_of(outs, labels)
        loss_t.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        return ([float(loss_t.item())], metrics) if metrics \
            else [float(loss_t.item())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad():
            outs, labels = self._forward(inputs, labels)
            results = []
            if self._loss is not None and labels:
                results.append(float(self._loss_of(outs, labels).item()))
        metrics = self._update_metrics(outs, labels)
        return (results, metrics) if metrics else results

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs, _ = self._forward(inputs, None)
        return [o.detach().cpu().numpy() for o in outs]

    def _loader(self, data, batch_size, **kw):
        if isinstance(data, DataLoader):
            return data
        return DataLoader(data, batch_size=batch_size, places=self._device,
                          **kw)

    # -- loops -------------------------------------------------------------
    def fit(
        self,
        train_data=None,
        eval_data=None,
        batch_size=1,
        epochs=1,
        eval_freq=1,
        log_freq=10,
        save_dir=None,
        save_freq=1,
        verbose=2,
        drop_last=False,
        shuffle=True,
        num_workers=0,
        callbacks=None,
        accumulate_grad_batches=1,
        num_iters=None,
        device_prefetch=0,
        stability=None,
    ):
        """Train for ``epochs`` (or ``num_iters`` steps). ``stability`` is
        a configured ``StabilitySentinel``, True (one from the
        ``FLAGS_stability_*`` flags) or None (the flags decide).
        ``device_prefetch=N`` stages the next N batches on the device while
        a step runs (not with the sentinel, which warns and trains
        without it). ``accumulate_grad_batches`` is accepted for the
        signature and, as in the reference, every batch updates."""
        sentinel = self._resolve_sentinel(stability)
        device_prefetch = int(device_prefetch or 0)
        wrap_prefetch = False
        if not isinstance(train_data, DataLoader):
            train_loader = self._loader(
                train_data, batch_size, shuffle=shuffle, drop_last=drop_last,
                num_workers=num_workers, device_prefetch=device_prefetch)
        else:
            train_loader = train_data
            # a loader with its own device_prefetch already prefetches
            wrap_prefetch = (device_prefetch > 0
                             and not getattr(train_loader, "device_prefetch",
                                             0))
        eval_loader = None
        if eval_data is not None:
            eval_loader = self._loader(eval_data, batch_size)

        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=len(train_loader),
            log_freq=log_freq, save_freq=save_freq, save_dir=save_dir,
            verbose=verbose, metrics=self._metrics_name(),
        )
        if sentinel is not None:
            if device_prefetch:
                import warnings

                warnings.warn(
                    "Model.fit: device_prefetch is not supported together "
                    "with the stability sentinel yet; training proceeds "
                    "without device-side input double-buffering")
            return self._fit_sentinel_loop(
                sentinel, train_loader, eval_loader, cbks, epochs=epochs,
                batch_size=batch_size, eval_freq=eval_freq,
                save_dir=save_dir, save_freq=save_freq, num_iters=num_iters,
            )
        cbks.on_begin("train")
        steps_done = 0
        logs = {}
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            epoch_iter = train_loader
            if wrap_prefetch:
                from ..io import device_prefetch as _device_prefetch

                epoch_iter = _device_prefetch(
                    train_loader, buffer_size=device_prefetch,
                    device=self._device)
            try:
                for step, batch in enumerate(epoch_iter):
                    cbks.on_batch_begin("train", step, logs)
                    ins, labs = self._split_batch(batch)
                    result = self.train_batch(ins, labs)
                    logs = self._make_logs(result)
                    logs["step"] = step
                    logs["batch_size"] = batch_size
                    cbks.on_batch_end("train", step, logs)
                    steps_done += 1
                    if num_iters is not None and steps_done >= num_iters:
                        break
            finally:
                if epoch_iter is not train_loader:
                    # an early break must not leave the prefetch thread
                    # staging batches of an abandoned epoch
                    epoch_iter.close()
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(epoch)))
            if self.stop_training or (num_iters is not None
                                      and steps_done >= num_iters):
                break
        cbks.on_end("train", logs)
        if save_dir:
            self.save(os.path.join(save_dir, "final"))

    # -- the stability sentinel's loop -------------------------------------
    def _resolve_sentinel(self, stability):
        from ..framework import flags as _flags

        if stability is None:
            if not _flags.flag("FLAGS_stability_enable", False):
                return None
        elif not stability:
            return None  # an explicit opt-out (False/0) overrides the flag
        from ..fault.sentinel import StabilitySentinel

        if isinstance(stability, StabilitySentinel):
            return stability
        s = StabilitySentinel.from_flags()
        s._auto = True  # fit owns it: closed when fit returns
        return s

    def _fit_sentinel_loop(self, sentinel, train_loader, eval_loader, cbks,
                           epochs, batch_size, eval_freq, save_dir, save_freq,
                           num_iters):
        """The fit loop with the sentinel in the step path: per batch the
        chaos spikes, the backward, the signals, then the verdict (a skip
        withholds the update and quarantines the batch; a rollback restores
        model, optimizer, schedule, generators and loader from the anchor
        and replays; a halt raises ``StabilityError``), and anchor
        checkpoints keyed by the global step."""
        from ..core.random import program_rng

        state = {"model": self.network, "optimizer": self._optimizer,
                 "loader": train_loader, "rng": program_rng}
        params = [p for p in self.network.parameters()
                  if not getattr(p, "stop_gradient", not p.requires_grad)]
        try:
            self._fit_sentinel_body(
                sentinel, train_loader, eval_loader, cbks, epochs, batch_size,
                eval_freq, save_dir, save_freq, num_iters, state, params,
            )
        finally:
            if getattr(sentinel, "_auto", False):
                sentinel.close()

    def _fit_sentinel_body(self, sentinel, train_loader, eval_loader, cbks,
                           epochs, batch_size, eval_freq, save_dir, save_freq,
                           num_iters, state, params):
        from ..fault import inject as _inject

        cbks.on_begin("train")
        global_step = 0  # steps that reached a verdict (trained or skipped)
        epoch0 = train_loader._epoch
        logs = {}
        cur_epoch = None
        done = False
        while not done and train_loader._epoch - epoch0 < epochs:
            if cur_epoch != train_loader._epoch:
                cur_epoch = train_loader._epoch
                for m in self._metrics:
                    m.reset()
                cbks.on_epoch_begin(cur_epoch - epoch0)
            it = train_loader._stateful_iter()
            restarted = False
            while True:
                pos = (train_loader._epoch, train_loader._batch_idx)
                if sentinel.is_quarantined(pos=pos):
                    if not it.skip_batch():
                        break  # the quarantined batch was the epoch's last
                    global_step += 1
                    continue
                try:
                    batch = next(it)
                except StopIteration:
                    break
                cbks.on_batch_begin("train", pos[1], logs)
                ins, labs = self._split_batch(batch)
                result, verdict = self._sentinel_train_batch(
                    sentinel, global_step, pos, ins, labs, params,
                    train_loader, _inject,
                )
                if verdict is not None and verdict.action == "rollback":
                    anchor_step = sentinel.rollback(verdict, state)
                    global_step = anchor_step + 1
                    restarted = True
                    break
                if verdict is not None and verdict.action == "halt":
                    sentinel.halt(verdict)
                if result is not None:
                    logs = self._make_logs(result)
                    logs["step"] = pos[1]
                    logs["batch_size"] = batch_size
                    cbks.on_batch_end("train", pos[1], logs)
                global_step += 1
                sentinel.maybe_anchor(global_step - 1, state)
                if num_iters is not None and global_step >= num_iters:
                    done = True
                    break
            it.close()
            if restarted:
                cur_epoch = None  # re-enter at the restored loader position
                continue
            if done or self.stop_training:
                break
            # the epoch is complete (the iterator rolled the loader forward)
            ep = cur_epoch - epoch0
            if eval_loader is not None and (ep + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_loader, verbose=0)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(ep, logs)
            if save_dir and (ep + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, str(ep)))
        cbks.on_end("train", logs)
        if save_dir:
            self.save(os.path.join(save_dir, "final"))

    def _sentinel_train_batch(self, sentinel, step, pos, inputs, labels,
                              params, loader, _inject):
        """One sentinel-guarded train step: ``(result, verdict)``, where
        ``result`` is None when the update was withheld (a skip, rollback
        or halt verdict; the optimizer never ran)."""
        self.network.train()
        outs, labels = self._forward(inputs, labels)
        loss_t = self._loss_of(outs, labels)
        if _inject.armed():
            s = _inject.spike("loss.spike", step=step)
            if s is not None:
                loss_t = loss_t * s
        loss_t.backward()
        if _inject.armed():
            s = _inject.spike("grad.spike", step=step)
            if s is not None:
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(s)
        verdict = sentinel.observe(
            step,
            loss=loss_t.detach(),
            grads=[p.grad for p in params if p.grad is not None],
            params=params,
            lr=self._optimizer.get_lr(),
            pos=pos,
            indices_fn=lambda e=pos[0], b=pos[1]: loader.batch_indices(e, b),
        )
        if verdict is not None:
            # any verdict withholds this step's update
            self._optimizer.clear_grad()
            return None, verdict
        self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        result = ([float(loss_t.item())], metrics) if metrics \
            else [float(loss_t.item())]
        return result, None

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size)
        for m in self._metrics:
            m.reset()
        logs = {}
        for batch in loader:
            ins, labs = self._split_batch(batch)
            result = self.eval_batch(ins, labs)
            logs = self._make_logs(result)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size)
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(batch, has_label=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs:
            n_out = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(n_out)]
        return outputs

    # -- persistence -------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, when training,
        ``path.pdopt`` (the optimizer's), in the reference's format."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        fsave(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.set_state_dict(
            fload(path + ".pdparams", return_numpy=True))
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(_arrays_to(
                fload(path + ".pdopt", return_numpy=True), self._device))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)

    # -- helpers -----------------------------------------------------------
    def _split_batch(self, batch, has_label=True):
        if isinstance(batch, (list, tuple)):
            if has_label and len(batch) >= 2:
                return list(batch[:-1]), [batch[-1]]
            return list(batch), []
        return [batch], []

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            names.extend(m.name() if isinstance(m.name(), list)
                         else [m.name()])
        return names

    def _make_logs(self, result):
        logs = {}
        if isinstance(result, tuple):
            losses, metrics = result
            logs["loss"] = losses[0]
            for m, v in zip(self._metrics, metrics):
                names = m.name() if isinstance(m.name(), list) \
                    else [m.name()]
                vals = v if isinstance(v, list) else [v]
                for n, val in zip(names, vals):
                    logs[n] = val
        else:
            logs["loss"] = result[0]
        return logs


def summary(net, input_size=None, dtypes=None, input=None):
    """paddle.summary: the parameter table, printed; returns the totals."""
    rows = []
    total = 0
    trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if not getattr(p, "stop_gradient", not p.requires_grad):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max([len(r[0]) for r in rows], default=20) + 2
    lines = [f"{'Layer (param)':{width}s} {'Shape':20s} {'Param #':>12s}"]
    lines.append("-" * (width + 34))
    for name, shape, n in rows:
        lines.append(f"{name:{width}s} {str(shape):20s} {n:12,d}")
    lines.append("-" * (width + 34))
    lines.append(f"Total params: {total:,d}")
    lines.append(f"Trainable params: {trainable:,d}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
