"""Single-GPU train step (counterpart of paddle_tpu/distributed/engine.py's
``TrainStepEngine``: ``step`` at engine.py:1853, the step body at
``_raw_step``, engine.py:824-871).

``step(ids, labels)`` advances the step count, reads the learning rate,
runs the model's forward (which returns the scalar loss) and backward under
whatever ``amp.auto_cast`` the caller holds, clips the gradients with the
optimizer's rule, and applies the optimizer's rule to the f32 parameters and
f32 state in place. It returns the loss.

PyTorch runs eagerly, so there is no compiled step to build, cache or
donate into. Not ported yet (ROADMAP.md): microbatch accumulation,
telemetry and health, checkpoints, ZeRO / FSDP and the device mesh, CUDA
graphs around the step.
"""
from __future__ import annotations

import torch

from ..optimizer import functional as opt_funct


class TrainStepEngine:
    """Fused train step of ``model`` (whose ``forward(*batch)`` returns the
    scalar loss) with ``optimizer``, on the model's device.

    Every trainable parameter of the model must be one of the optimizer's;
    its state and its weight-decay decision go by the optimizer's name for
    it."""

    def __init__(self, model, optimizer):
        self.model = model
        self.optimizer = optimizer
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
        opt = self.optimizer
        self._step_count += 1
        opt._step_count = self._step_count  # keep checkpoints consistent
        lr_val = opt.get_lr()
        for p in self.params.values():
            p.grad = None
        loss = self.model(*batch)
        loss.backward()
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in self.params.items()}
            grads = opt_funct.clip_grads(grads, opt._grad_clip)
            opt._apply(self.params, grads, lr_val, self._step_count)
        self.last_loss = loss.detach()
        return self.last_loss
