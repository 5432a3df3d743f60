"""Single-GPU train step (counterpart of paddle_tpu/distributed/engine.py's
``TrainStepEngine``: ``step`` at engine.py:1853, the step body at
``_raw_step``, engine.py:824-871, and the microbatch accumulation of
``grad_comm.make_accum_step``, grad_comm.py:215-263).

``step(ids, labels)`` advances the step count, reads the learning rate,
runs the model's forward (which returns the scalar loss) and backward under
whatever ``amp.auto_cast`` the caller holds, clips the gradients with the
optimizer's rule, and applies the optimizer's rule to the f32 parameters and
f32 state in place. It returns the loss.

With ``microbatches=K`` > 1 the batch dim splits into K consecutive
microbatches; each runs forward and backward, the gradients are summed in
f32 and divided by K, the loss is the mean of the K losses, and the step
clips and updates once: the same step on 1/K of the activations.

PyTorch runs eagerly, so there is no compiled step to build, cache or
donate into. Not ported yet (ROADMAP.md): telemetry and health,
checkpoints, ZeRO / FSDP and the device mesh, CUDA graphs around the step.
"""
from __future__ import annotations

import torch

from ..optimizer import functional as opt_funct


class TrainStepEngine:
    """Fused train step of ``model`` (whose ``forward(*batch)`` returns the
    scalar loss) with ``optimizer``, on the model's device.

    Every trainable parameter of the model must be one of the optimizer's;
    its state and its weight-decay decision go by the optimizer's name for
    it. ``microbatches`` (also a mutable attribute) is K of the module
    docstring."""

    def __init__(self, model, optimizer, microbatches: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.microbatches = max(1, int(microbatches))
        opt_names = {id(p): n for n, p in zip(optimizer._param_names,
                                               optimizer._parameter_list)}
        self.params = {}
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            if id(p) not in opt_names:
                raise ValueError(f"parameter {name!r} of the model is not one of "
                                 "the optimizer's parameters")
            self.params[opt_names[id(p)]] = p
        self._step_count = optimizer._step_count
        self.last_loss = None

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _to_device(self, x):
        return torch.as_tensor(x).to(self.device, non_blocking=True)

    def step(self, *batch):
        """One optimizer step on ``batch`` (tensors or arrays, moved to the
        model's device). Returns the loss (a detached 0-dim tensor)."""
        batch = [self._to_device(b) for b in batch]
        k = self.microbatches
        if k > 1:
            for b in batch:
                if b.dim() and b.shape[0] % k:
                    raise ValueError(f"batch dim {b.shape[0]} is not divisible by "
                                     f"microbatches = {k}; pad or resize the batch")
        opt = self.optimizer
        self._step_count += 1
        opt._step_count = self._step_count  # keep checkpoints consistent
        lr_val = opt.get_lr()
        for p in self.params.values():
            p.grad = None
        if k == 1:
            loss = self.model(*batch)
            loss.backward()
        else:
            loss = self._accumulate(batch, k)
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.params.items()}
            grads = opt_funct.clip_grads(grads, opt._grad_clip)
            opt._apply(self.params, grads, lr_val, self._step_count)
        self.last_loss = loss.detach()
        return self.last_loss

    def _accumulate(self, batch, k):
        """Forward and backward of each of the k microbatches; leaves the mean
        gradient (the f32 sum over them, divided by k, in each parameter's
        dtype) on the parameters and returns the mean loss."""
        parts = [b.split(b.shape[0] // k) if b.dim() else [b] * k for b in batch]
        acc, losses = {}, []
        for i in range(k):
            loss = self.model(*(p[i] for p in parts))
            loss.backward()
            losses.append(loss.detach())
            with torch.no_grad():
                for n, p in self.params.items():
                    if p.grad is not None:
                        g = p.grad.float()
                        acc[n] = g if n not in acc else acc[n].add_(g)
                        p.grad = None
        with torch.no_grad():
            for n, p in self.params.items():
                if n in acc:
                    p.grad = acc[n].div_(k).to(p.dtype)
            return torch.stack(losses).mean()
