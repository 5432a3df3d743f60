"""The eager ``PipelineParallel`` facade (counterpart of
paddle_tpu/distributed/meta_parallel/pipeline_parallel.py; reference
fleet/meta_parallel/pipeline_parallel.py:31, ``forward_backward_pipeline``
:81, ``train_batch`` :153).

``train_batch`` splits the batch into ``accumulate_steps`` micro-batches
(or batch / ``micro_batch_size``) and runs forward and backward of each,
the gradients accumulating, then the optimizer's step: on one controller
the numbers of the reference's 1F1B, which reorders micro-batch work across
ranks but computes the same accumulated gradient. The pipeline over ranks
is the stacked path: ``GPTForPretrainingPipe`` through
``fleet.distributed_engine`` runs distributed/pipeline_schedule.py.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..mesh import get_hybrid_communicate_group


class PipelineParallel(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy
        pc = getattr(strategy, "pipeline_configs", None)
        self.accumulate_steps = int(getattr(pc, "accumulate_steps", 1) or 1)
        self.micro_batch_size = getattr(pc, "micro_batch_size", None)
        self.total_loss = None

    def _num_micro(self, data):
        # accumulate_steps wins when set; otherwise a micro_batch_size above
        # one derives the split (reference: micro_batch_size * accumulate_steps = batch)
        if self.accumulate_steps > 1:
            return self.accumulate_steps
        if self.micro_batch_size and self.micro_batch_size > 1:
            inputs = data[0] if isinstance(data, (tuple, list)) else data
            b = inputs.shape[0]
            if b % self.micro_batch_size != 0:
                raise ValueError(
                    f"batch {b} not divisible by micro_batch_size "
                    f"{self.micro_batch_size}")
            return b // self.micro_batch_size
        return self.accumulate_steps

    # reference pipeline_parallel.py:153
    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None:
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        self._layers.eval()
        with torch.no_grad():
            inputs, labels = self._load_micro_batches(data, 1)[0]
            out = self._layers(inputs)
            if compute_loss and hasattr(self._layers, "loss"):
                return self._layers.loss(out, labels)
            return out

    # reference pipeline_parallel.py:81
    def forward_backward_pipeline(self, data, scaler=None):
        micros = self._load_micro_batches(data, self._num_micro(data))
        n = len(micros)
        total = None
        for inputs, labels in micros:
            out = self._layers(inputs)
            if hasattr(self._layers, "loss") and labels is not None:
                loss = self._layers.loss(out, labels)
            else:
                loss = out
            loss = loss / n
            (scaler.scale(loss) if scaler is not None else loss).backward()
            total = loss.detach() if total is None else total + loss.detach()
        self.total_loss = total
        return total

    def _load_micro_batches(self, data, n):
        if isinstance(data, (tuple, list)):
            inputs, labels = data[0], data[1] if len(data) > 1 else None
        else:
            inputs, labels = data, None

        def split(t):
            if t is None:
                return [None] * n
            b = t.shape[0]
            if b % n != 0:
                raise ValueError(f"batch {b} not divisible by accumulate_steps {n}")
            mb = b // n
            return [t[i * mb:(i + 1) * mb] for i in range(n)]

        return list(zip(split(inputs), split(labels)))

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        yield  # the gradients are summed in place; nothing to suppress


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved (virtual-stage) schedule's facade: the same numbers
    eagerly. The interleaved scheduler over ranks is the stacked path:
    GPTForPretrainingPipe(num_virtual_stages=V) runs
    pipeline_schedule.spmd_pipeline_interleaved, each rank holding V stage
    chunks (reference SectionWorker interleaving, device_worker.h:615)."""
