"""Rank bodies of tests/test_torch_elastic.py's checks over 2 gloo ranks (a
helper module: pytest does not collect it). It imports torch and the port
only, never jax: ``spawn`` imports it again in every rank.

``resnet_resume(out_dir, ckpt_root)`` runs in each rank (torch on one
intra-op thread, deterministic algorithms), replicated and under ZeRO in
turn: ResNet-18 (10 classes, seed 0) through ``fleet.init`` (dp 2) ->
``fleet.distributed_engine(model, Momentum, loss_fn=CrossEntropyLoss())``
takes ``SAVED_STEPS`` steps on the global batch ``resnet_batch()`` and
saves (a blocking ``CheckpointManager.save``, a collective), then
``RESUMED_STEPS`` more; a fresh engine (weights from seed 1) restores the
checkpoint (``CheckpointManager.restore``) and takes the same steps. It
saves {mode: {"uninterrupted", "resumed": {"losses", "buffers", "logits"}}}
(eval logits of the batch's first 4 images) to ``out_dir/rank<r>.pt``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

SAVED_STEPS, RESUMED_STEPS = 3, 2
LR = 0.01


def resnet_batch(b=16, hw=32, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, hw, hw).astype(np.float32)
    y = rng.randint(0, classes, (b,)).astype(np.int64)
    return torch.from_numpy(x), torch.from_numpy(y)


def resnet_engine(seed, zero=False, engine_of=None):
    """ResNet-18 (10 classes, weights from ``seed``) and its engine
    (Momentum(LR), loss_fn=CrossEntropyLoss()) on the CPU; ``engine_of``:
    fleet.distributed_engine in a rank (TrainStepEngine by default)."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.vision.models import resnet18

    m = resnet18(num_classes=10, device="cpu", seed=seed)
    opt = optimizer.Momentum(learning_rate=LR, momentum=0.9, parameters=m.named_parameters())
    return (engine_of or TrainStepEngine)(m, opt, loss_fn=nn.CrossEntropyLoss(),
                                          zero_update=zero)


def outcome(engine, x, y, steps):
    """``steps`` more steps: their losses, then the model's buffers and its
    eval logits of ``x[:4]``."""
    losses = [engine.step(x, y).item() for _ in range(steps)]
    m = engine.model
    m.eval()
    with torch.no_grad():
        logits = m(x[:4]).clone()
    m.train()
    return {"losses": losses, "logits": logits,
            "buffers": {n: b.clone() for n, b in m.named_buffers()}}


def resnet_resume(out_dir, ckpt_root):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.elastic import CheckpointManager

    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    x, y = resnet_batch()
    out = {}
    for mode in ("replicated", "zero"):
        zero = mode == "zero"
        mgr = CheckpointManager(os.path.join(ckpt_root, mode), async_save=False)
        eng = resnet_engine(0, zero, fleet.distributed_engine)
        for _ in range(SAVED_STEPS):
            eng.step(x, y)
        mgr.save(eng, block=True)
        uninterrupted = outcome(eng, x, y, RESUMED_STEPS)
        fresh = resnet_engine(1, zero, fleet.distributed_engine)
        step = mgr.restore(fresh)
        resumed = outcome(fresh, x, y, RESUMED_STEPS)
        mgr.close()
        out[mode] = {"uninterrupted": uninterrupted, "resumed": resumed, "step": step}
    torch.save(out, os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.pt"))
