"""``hapi.Model`` of the port: the Keras-like training facade (counterpart of
paddle_tpu/hapi/model.py; reference python/paddle/hapi/model.py:907
``Model``, :1486 ``evaluate``, :1557 ``fit``).

``Model(network)`` wraps an ``nn.Module``; ``prepare(optimizer, loss,
metrics)`` configures it; ``train_batch`` / ``eval_batch`` /
``predict_batch`` run one batch eagerly on the network's device, and
``fit`` / ``evaluate`` / ``predict`` loop over a dataset (through
``io.DataLoader`` on that device) or over a loader or any iterable of
batches, with the callbacks of ``hapi/callbacks.py``. ``fit`` times each
fetch from the loader (``reader_cost`` in the batch's logs: the wait the
consumer paid, which the loader's worker threads make small).

``fit(accumulate_grad_batches=K)``, K > 1, takes one of two routes, decided
once a fit by ``engine_route_refusal`` and never by catching an error:

- **engine**: K loader batches are concatenated and run as one
  ``TrainStepEngine`` step of K microbatches (one optimizer update; a
  shorter group at the epoch's tail), and the network holds the engine's
  parameters at every epoch's end. It applies when no metric is configured
  (the engine returns the loss alone) and an optimizer is, as in the JAX
  package (reference :131), and when the engine takes the network: every
  trainable parameter is one of the optimizer's. ``model._engine`` is the
  engine, or None on the eager route.
- **eager**: each batch's loss, scaled by 1/K, is backpropagated, the
  optimizer steps every K batches, and the epoch's tail gradients are
  flushed by one more step.

Persistence is ``framework/io.py``'s: ``save(path)`` writes the network's
state dict to ``path.pdparams`` and the optimizer's to ``path.pdopt``, in
the port's layout (a Linear weight ``[out, in]``; models/convert.py's
``gather_to_jax`` and ``state_from_jax`` carry a state to and from the JAX
package's ``[in, out]``).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..metric import Metric
from .callbacks import config_callbacks


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _to_host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


def module_device(network) -> torch.device:
    """The device of ``network``'s first parameter (or buffer); for a network
    that holds neither, the card (``resolve_device``: it raises without one)."""
    for t in network.parameters():
        return t.device
    for t in network.buffers():
        return t.device
    return resolve_device(None)


def engine_route_refusal(network, optimizer, metrics) -> Optional[str]:
    """Why ``fit(accumulate_grad_batches=K > 1)`` takes the eager route, or
    None when the engine route applies (module docstring)."""
    if metrics:
        return "metrics are configured (the engine returns the loss alone)"
    if optimizer is None:
        return "no optimizer is configured"
    owned = {id(p) for p in optimizer._parameter_list}
    trainable = [p for p in network.parameters() if p.requires_grad]
    if not trainable:
        return "the network has no trainable parameter"
    if any(id(p) not in owned for p in trainable):
        return "a trainable parameter of the network is not one of the optimizer's"
    return None


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _to_list(inputs)
        self._labels = _to_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._save_dir = None
        self.stop_training = False
        # the engine of fit(accumulate_grad_batches=K > 1) on the engine
        # route (module docstring); None on the eager route
        self._engine = None
        self._accumulate = 1

    @property
    def device(self) -> torch.device:
        return module_device(self.network)

    # ---- configuration ----
    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable (a loss Layer or function)")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m!r} is not a paddle_tpu_torch.metric.Metric")
        self._amp_configs = amp_configs or {}
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def _to_tensors(self, xs):
        dev = self.device
        out = []
        for x in _to_list(xs):
            if not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            out.append(x.to(dev, non_blocking=True))
        return out

    # ---- one batch ----
    def train_batch(self, inputs, labels=None, update=True):
        if self._optimizer is None:
            raise RuntimeError("call prepare() with an optimizer first")
        self.network.train()
        inputs, labels = self._to_tensors(inputs), self._to_tensors(labels)
        outputs = _to_list(self.network(*inputs))
        losses = self._compute_loss(outputs, labels)
        total = losses[0]
        for extra in losses[1:]:
            total = total + extra
        if self._accumulate > 1:
            # the mean over the accumulation window: the step is the large
            # batch's (reference model.py scales final_loss)
            total = total * (1.0 / self._accumulate)
        total.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        loss_vals = [float(l.item()) for l in losses]
        return (loss_vals, metrics) if metrics else loss_vals

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._to_tensors(inputs), self._to_tensors(labels)
        with torch.no_grad():
            outputs = _to_list(self.network(*inputs))
            # loss=None without metrics: the network computes its own loss;
            # loss=None with metrics: an evaluation of the metrics alone
            losses = (self._compute_loss(outputs, labels)
                      if self._loss is not None or not self._metrics else [])
        metrics = self._update_metrics(outputs, labels)
        loss_vals = [float(l.item()) for l in losses]
        return (loss_vals, metrics) if metrics else loss_vals

    def predict_batch(self, inputs):
        self.network.eval()
        inputs = self._to_tensors(inputs)
        with torch.no_grad():
            outputs = _to_list(self.network(*inputs))
        return [_to_host(o) for o in outputs]

    def _compute_loss(self, outputs, labels):
        if self._loss is None:
            return [outputs[0]]   # the network returns its loss
        return _to_list(self._loss(*(outputs + labels)))

    def _update_metrics(self, outputs, labels):
        vals = []
        for m in self._metrics:
            state = m.compute(*(outputs + labels))
            m.update(*[_to_host(s) for s in _to_list(state)])
            vals.append(m.accumulate())
        return vals

    # ---- accumulation on the engine route ----
    def _accum_engine(self, k, n_inputs):
        """The engine of the engine route, or None for the eager route
        (``engine_route_refusal``). A new engine each fit."""
        if engine_route_refusal(self.network, self._optimizer, self._metrics) is not None:
            self._engine = None
            return None
        from ..distributed.engine import TrainStepEngine

        self._engine = TrainStepEngine(
            self.network, self._optimizer, loss_fn=self._loss, microbatches=k,
            num_model_inputs=n_inputs if self._loss is not None else None)
        return self._engine

    def _engine_group_step(self, engine, group):
        """The stashed (inputs, labels) batches of one group concatenated on
        the batch dim and run as one step of len(group) microbatches."""
        cols = [torch.cat(self._to_tensors([b[pos] for b in group]), dim=0)
                for pos in range(len(group[0]))]
        engine.microbatches = len(group)
        return [float(engine.step(*cols).item())]

    # ---- loops ----
    def _make_loader(self, data, batch_size, shuffle, num_workers, drop_last=False,
                     prefetch_factor=2):
        from ..io import DataLoader, Dataset

        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last,
                              prefetch_factor=prefetch_factor, device=self.device)
        # any other iterable of ready batches: kept as a list, so a generator
        # serves every epoch
        return data if hasattr(data, "__getitem__") else list(data)

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None, prefetch_factor=2):
        if train_data is None:
            raise ValueError("train_data must be given")
        self._save_dir = save_dir
        loader = self._make_loader(train_data, batch_size, shuffle, num_workers,
                                   drop_last, prefetch_factor=prefetch_factor)
        eval_loader = self._make_loader(eval_data, batch_size, False, num_workers)
        steps = self._safe_len(loader)
        self._accumulate = max(1, accumulate_grad_batches)
        self._engine = None
        engine = None   # decided at the first batch (it needs the input count)
        cbks = config_callbacks(callbacks, model=self, epochs=epochs, steps=steps,
                                batch_size=batch_size, verbose=verbose,
                                log_freq=log_freq, save_freq=save_freq,
                                save_dir=save_dir, metrics=self._metrics_name())
        self.stop_training = False
        cbks.on_train_begin()
        history = []
        for epoch in range(epochs):
            if self.stop_training:
                break
            cbks.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            logs = {}
            pending_update = False
            group, group_reader = [], 0.0   # engine route: the stashed batches
            batches = iter(loader)
            step = -1
            try:
                while True:
                    t_fetch = time.perf_counter()
                    try:
                        batch = next(batches)
                    except StopIteration:
                        break
                    reader_dt = time.perf_counter() - t_fetch
                    step += 1
                    if num_iters is not None and step >= num_iters:
                        break
                    ins, labs = self._split_batch(batch)
                    if self._accumulate > 1 and engine is None:
                        engine = self._accum_engine(self._accumulate, len(ins)) or False
                    cbks.on_train_batch_begin(step)
                    if engine:
                        # K loader batches, then one engine step; the
                        # callbacks' batch end comes with the step
                        group.append(ins + labs)
                        group_reader += reader_dt
                        if len(group) == self._accumulate:
                            logs = self._pack_logs(self._engine_group_step(engine, group),
                                                   batch_size)
                            logs["reader_cost"] = group_reader
                            group, group_reader = [], 0.0
                            cbks.on_train_batch_end(step, logs)
                    else:
                        update = (step + 1) % self._accumulate == 0
                        out = self.train_batch(ins, labs, update=update)
                        pending_update = not update
                        logs = self._pack_logs(out, batch_size)
                        logs["reader_cost"] = reader_dt
                        cbks.on_train_batch_end(step, logs)
                    if self.stop_training:
                        break
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()
            if group:
                # the epoch's tail on the engine route: a shorter group, so
                # nothing spills into the next epoch
                logs = self._pack_logs(self._engine_group_step(engine, group), batch_size)
                logs["reader_cost"] = group_reader
                cbks.on_train_batch_end(step, logs)
            if pending_update:
                # the eager route's tail gradients, when K does not divide
                # the epoch
                self._optimizer.step()
                self._optimizer.clear_grad()
            if engine:
                engine.sync_to_model()   # evaluation and checkpoints read the network
            if eval_loader is not None and epoch % eval_freq == 0:
                eval_logs = self._run_eval(eval_loader, cbks)
                logs.update({f"eval_{k}": v for k, v in eval_logs.items()})
            cbks.on_epoch_end(epoch, logs)
            history.append(logs)
        cbks.on_train_end(logs if history else {})
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = self._make_loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, batch_size=batch_size,
                                verbose=verbose, log_freq=log_freq,
                                metrics=self._metrics_name())
        return self._run_eval(loader, cbks, num_iters=num_iters)

    def _run_eval(self, loader, cbks, num_iters=None):
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin({"steps": self._safe_len(loader)})
        logs, samples = {}, 0
        batches = iter(loader)
        try:
            for step, batch in enumerate(batches):
                if num_iters is not None and step >= num_iters:
                    break
                cbks.on_eval_batch_begin(step)
                ins, labs = self._split_batch(batch)
                logs = self._pack_logs(self.eval_batch(ins, labs), None)
                samples += len(ins[0]) if ins and hasattr(ins[0], "__len__") else 0
                cbks.on_eval_batch_end(step, logs)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        logs["samples"] = samples
        cbks.on_eval_end(logs)
        logs.pop("samples", None)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, batch_size=batch_size,
                                verbose=verbose)
        cbks.on_predict_begin()
        outputs: List[List[np.ndarray]] = []
        batches = iter(loader)
        try:
            for step, batch in enumerate(batches):
                cbks.on_predict_batch_begin(step)
                ins, _ = self._split_batch(batch, has_labels=False)
                outputs.append(self.predict_batch(ins))
                cbks.on_predict_batch_end(step)
        finally:
            close = getattr(batches, "close", None)
            if close is not None:
                close()
        cbks.on_predict_end()
        # a list over batches of lists over outputs -> a list over outputs
        n_out = len(outputs[0]) if outputs else 0
        result = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r, axis=0) for r in result]
        return result

    def _split_batch(self, batch, has_labels=True):
        batch = _to_list(batch)
        if self._inputs:
            n_in = len(self._inputs)
        elif self._loss is None and not self._metrics:
            n_in = len(batch)   # the network computes its loss from the whole batch
        elif len(batch) == 1:
            n_in = 1
        else:
            n_in = max(1, len(batch) - 1)
        return batch[:n_in], batch[n_in:] if has_labels else []

    def _pack_logs(self, out, batch_size):
        logs = {}
        if self._metrics:
            losses, metrics = out
        else:
            losses, metrics = out, []
        if losses:
            logs["loss"] = losses if len(losses) > 1 else losses[0]
        for m, v in zip(self._metrics, metrics):
            names = m.name() if isinstance(m.name(), (list, tuple)) else [m.name()]
            vals = v if isinstance(v, (list, tuple)) else [v]
            for n, val in zip(names, vals):
                logs[n] = val
        if batch_size:
            logs["batch_size"] = batch_size
        return logs

    @staticmethod
    def _safe_len(loader):
        try:
            return len(loader)
        except TypeError:
            return None

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, (list, tuple)) else [n])
        return names

    # ---- persistence ----
    def save(self, path, training=True):
        from ..framework import io as fio

        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import io as fio

        state = fio.load(path + ".pdparams", device=self.device)
        self.network.load_state_dict(state, strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fio.load(path + ".pdopt", device=self.device))

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtypes=dtype)
