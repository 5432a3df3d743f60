"""Callbacks of ``hapi.Model.fit`` in the port (counterpart of
paddle_tpu/hapi/callbacks.py; reference python/paddle/hapi/callbacks.py):
``Callback``, ``CallbackList``, ``ProgBarLogger``, ``ModelCheckpoint``,
``LRScheduler`` (steps the optimizer's ``optimizer/lr.py`` scheduler),
``EarlyStopping``, ``TelemetryCallback`` (one ``StepTelemetry`` record a
train batch; attached by ``config_callbacks`` when
``PADDLE_TPU_TELEMETRY_DIR`` is set, as the engine's telemetry is),
``VisualDL`` (scalars to a JSONL file) and ``config_callbacks``.
"""
from __future__ import annotations

import numbers
import os
import sys
import time


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


def _fmt_logs(logs):
    parts = []
    for k, v in (logs or {}).items():
        if k in ("batch_size",):
            continue
        if isinstance(v, (list, tuple)):
            v = v[0] if len(v) == 1 else list(v)
        if isinstance(v, numbers.Number):
            parts.append(f"{k}: {v:.4f}")
        else:
            parts.append(f"{k}: {v}")
    return " - ".join(parts)


class ProgBarLogger(Callback):
    """Prints per-epoch progress: `step N/M - loss: x - acc: y - t/step`."""

    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        if self.verbose:
            print("The loss value printed in the log is the current step, and the "
                  "metric is the average value of previous steps.", flush=True)

    def on_epoch_begin(self, epoch, logs=None):
        self.steps = self.params.get("steps")
        self.epoch = epoch
        self._t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}", flush=True)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and (step % self.log_freq == 0 or step + 1 == (self.steps or 0)):
            dt = (time.time() - self._t0) / max(1, step + 1)
            total = self.steps if self.steps is not None else "?"
            print(f"step {step + 1}/{total} - {_fmt_logs(logs)} - {dt * 1000:.0f}ms/step",
                  file=sys.stdout, flush=True)

    def on_eval_begin(self, logs=None):
        self.eval_steps = (logs or {}).get("steps")
        if self.verbose:
            print("Eval begin...", flush=True)

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval samples: {(logs or {}).get('samples', '?')} - {_fmt_logs(logs)}",
                  flush=True)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.model is None or self.save_dir is None:
            return
        if epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.model is not None and self.save_dir is not None:
            self.model.save(os.path.join(self.save_dir, "final"))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched

        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if isinstance(lr, Sched) else None

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.baseline = baseline
        self.min_delta = abs(min_delta)
        self.wait_epoch = 0
        self.best_weights = None
        self.stopped_epoch = 0
        self.save_best_model = save_best_model
        if mode not in ("auto", "min", "max"):
            mode = "auto"
        if mode == "min" or (mode == "auto" and "acc" not in monitor):
            self.monitor_op = lambda cur, best: cur < best - self.min_delta
            self.best_value = float("inf")
        else:
            self.monitor_op = lambda cur, best: cur > best + self.min_delta
            self.best_value = -float("inf")

    def on_train_begin(self, logs=None):
        self.wait_epoch = 0
        if self.baseline is not None:
            self.best_value = self.baseline

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch

    def on_eval_end(self, logs=None):
        if logs is None or self.monitor not in logs:
            return
        current = logs[self.monitor]
        if isinstance(current, (list, tuple)):
            current = current[0]
        if self.monitor_op(current, self.best_value):
            self.best_value = current
            self.wait_epoch = 0
            if self.save_best_model and self.model is not None \
                    and getattr(self.model, "_save_dir", None):
                self.model.save(os.path.join(self.model._save_dir, "best_model"))
        else:
            self.wait_epoch += 1
        if self.wait_epoch > self.patience:
            self.model.stop_training = True
            self.stopped_epoch = getattr(self, "_epoch", 0)
            if self.verbose:
                print(f"Epoch {self.stopped_epoch}: Early stopping.", flush=True)


class TelemetryCallback(Callback):
    """Per-step structured telemetry for Model.fit, emitting one
    observability.StepTelemetry JSONL record per train batch (wall time,
    samples/s, loss, tracked reader_cost, compile/dispatch counters).

    Wall time spans on_train_batch_begin -> end; train_batch reads the
    loss on the host (``item()``), which waits for the card's step. Auto-attached by
    config_callbacks when PADDLE_TPU_TELEMETRY_DIR is set."""

    def __init__(self, telemetry=None, path=None, flops_per_token=None):
        super().__init__()
        if telemetry is None:
            from ..observability.step_telemetry import InMemorySink, JsonlSink, StepTelemetry

            sink = JsonlSink(path) if path else InMemorySink()
            telemetry = StepTelemetry(sink=sink,
                                      flops_per_token=flops_per_token)
        self.telemetry = telemetry
        self._t0 = None
        self._step = 0

    def on_train_batch_begin(self, step, logs=None):
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        logs = logs or {}
        loss = logs.get("loss")
        if isinstance(loss, (list, tuple)):
            loss = loss[0] if loss else None
        self._step += 1
        self.telemetry.record_step(
            step=self._step, wall_time=dt,
            samples=logs.get("batch_size"),
            loss=float(loss) if isinstance(loss, numbers.Number) else None,
            reader_cost=logs.get("reader_cost"))

    def on_train_end(self, logs=None):
        self.telemetry.close()


class VisualDL(Callback):
    """Scalar logging callback: the scalars of each train batch and of each
    evaluation appended to ``log_dir/scalars.jsonl`` (the JAX package's
    file; the visualdl package is not a dependency)."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, logs):
        import json

        os.makedirs(self.log_dir, exist_ok=True)
        rec = {"tag": tag, "step": self._step}
        for k, v in (logs or {}).items():
            if isinstance(v, (list, tuple)) and v and isinstance(v[0], numbers.Number):
                rec[k] = float(v[0])
            elif isinstance(v, numbers.Number):
                rec[k] = float(v)
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1, save_dir=None,
                     metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    tele_dir = os.environ.get("PADDLE_TPU_TELEMETRY_DIR")
    if (tele_dir and mode == "train"
            and not any(isinstance(c, TelemetryCallback) for c in cbks)):
        cbks.append(TelemetryCallback(
            path=os.path.join(tele_dir, "fit_telemetry.jsonl")))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    lst = CallbackList(cbks)
    lst.set_model(model)
    lst.set_params({"batch_size": batch_size, "epochs": epochs, "steps": steps,
                    "verbose": verbose, "metrics": metrics or []})
    return lst


__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "TelemetryCallback", "VisualDL", "config_callbacks"]
