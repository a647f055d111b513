"""hapi callbacks (port of ``paddle_tpu/hapi/callbacks.py``): the fit
loop's hooks, plain host code over the model's optimizer and logs."""
from __future__ import annotations

import os
import time


__all__ = ['Callback', 'CallbackList', 'ProgBarLogger', 'ModelCheckpoint', 'EarlyStopping', 'LRScheduler', 'config_callbacks', 'ReduceLROnPlateau', 'VisualDL']


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_begin", lambda *a: None)(step, logs)

    def on_batch_end(self, mode, step, logs=None):
        getattr(self, f"on_{mode}_batch_end", lambda *a: None)(step, logs)


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def __iter__(self):
        return iter(self.callbacks)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def on_begin(self, mode, logs=None):
        self._call("on_begin", mode, logs)

    def on_end(self, mode, logs=None):
        self._call("on_end", mode, logs)

    def on_epoch_begin(self, epoch, logs=None):
        self._call("on_epoch_begin", epoch, logs)

    def on_epoch_end(self, epoch, logs=None):
        self._call("on_epoch_end", epoch, logs)

    def on_batch_begin(self, mode, step, logs=None):
        self._call("on_batch_begin", mode, step, logs)

    def on_batch_end(self, mode, step, logs=None):
        self._call("on_batch_end", mode, step, logs)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self._t0 = None

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}"
                for k, v in (logs or {}).items()
                if k not in ("batch_size",)
            )
            print(f"Epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - (self._t0 or time.time())
            items = " - ".join(
                f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}" for k, v in (logs or {}).items()
            )
            print(f"Epoch {epoch} done in {dt:.1f}s: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1, min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        if val is None:
            return
        better = (
            self.best is None
            or (self.mode == "min" and val < self.best - self.min_delta)
            or (self.mode == "max" and val > self.best + self.min_delta)
        )
        if better:
            self.best = val
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience and self.model is not None:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if s is not None and self.by_step:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if s is not None and self.by_epoch:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None, steps=None, log_freq=2, verbose=2, save_freq=1, save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    cl = CallbackList(cbks)
    for c in cbks:
        c.set_model(model)
        c.set_params(
            {"epochs": epochs, "steps": steps, "verbose": verbose, "metrics": metrics or []}
        )
    return cl


class ReduceLROnPlateau(Callback):
    """Reference hapi/callbacks.py ReduceLROnPlateau:958 — shrink the
    optimizer LR when the monitored metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = "min" if mode in ("auto", "min") else "max"
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        val = (logs or {}).get(self.monitor)
        opt = getattr(self.model, "_optimizer", None) if self.model else None
        if val is None or opt is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = (
            self.best is None
            or (self.mode == "min" and val < self.best - self.min_delta)
            or (self.mode == "max" and val > self.best + self.min_delta)
        )
        if better:
            self.best = val
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                from ..optimizer.lr import LRScheduler as _Sched

                if isinstance(getattr(opt, "_learning_rate", None), _Sched):
                    # reference raises here: set_lr on a scheduler-driven
                    # optimizer would silently kill the schedule
                    raise TypeError(
                        "ReduceLROnPlateau cannot adjust an optimizer driven "
                        "by an LRScheduler; use optimizer.lr.ReduceOnPlateau "
                        "as the scheduler instead"
                    )
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:g} -> {new:g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalars to ``<log_dir>/scalars.jsonl``, one JSON record a line
    (the reference's record: the visualdl service is not used)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._fh = None
        self._step = 0

    def _write(self, tag, logs):
        import json
        import time

        if self._fh is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._fh = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        # global_step is ours (monotonic across epochs); logs may carry its
        # own per-epoch 'step' key, which must not clobber it
        rec = {"global_step": self._step, "tag": tag, "ts": time.time()}
        for k, v in (logs or {}).items():
            if k in ("global_step", "tag", "ts"):
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        if self._step % 10 == 0:
            self._write("train", logs)

    def on_epoch_end(self, epoch, logs=None):
        self._write("train_epoch", logs)

    def on_end(self, mode, logs=None):
        # the harness delivers end-of-run as on_end(mode, logs)
        if mode == "eval":
            self._write("eval", logs)
        if mode == "train" and self._fh is not None:
            self._fh.close()
            self._fh = None
