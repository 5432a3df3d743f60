"""Rank bodies of tests/test_torch_vision.py's and tests/test_torch_ernie.py's
multi-rank checks (a helper module: pytest does not collect it). It
imports torch and the port only, never jax: ``spawn`` imports it again in
every rank.

``run_world(out_dir, resnet_state_path, ernie_state_path)`` runs in each of
4 gloo ranks (torch on one intra-op thread), in one world for both checks:

- ``resnet_dp4``: ``fleet.init`` at dp 4, resnet18 (10 classes) from the
  JAX model's state (f64), ``fleet.distributed_engine(model, Momentum(...),
  loss_fn=CrossEntropyLoss())``, ``STEPS`` steps on the global batch
  ``resnet_batch()`` (labels at -100 in unequal counts across the ranks'
  rows): the losses, the model's state (parameters and running statistics)
  of every rank;
- ``ernie_dp2_sh2``: ``fleet.init`` again at dp 2 x sharding 2,
  ernie_tiny from the JAX model's state, AdamW through
  ``fleet.distributed_engine`` (ZeRO), ``STEPS`` steps on
  ``ernie_batch()``: the losses, the gathered state (rank 0) and the
  optimizer state elements the rank holds against the replicated count.

It saves {case: result} to ``out_dir/rank<r>.pt``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

STEPS = 2
RESNET_LR, RESNET_MOMENTUM = 0.01, 0.9
ERNIE_LR = 1e-3


def resnet_batch(b=8, hw=32, classes=10, seed=0, dtype=np.float64):
    """Images [b, 3, hw, hw] and labels; rows 1, 2 and 3 ignored (-100): at
    dp 4 the ranks' rows hold 1, 2, 0 and 0 of them. f64 by default: the
    ResNet steps are compared in f64 (tests/test_torch_vision.py)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 3, hw, hw).astype(dtype)
    y = rng.randint(0, classes, (b,)).astype(np.int64)
    y[[1, 2, 3]] = -100
    return torch.from_numpy(x), torch.from_numpy(y)


def ernie_batch(b=8, s=64, vocab=1024, seed=0):
    """ids, MLM labels (15%, -100 elsewhere), token types, a padding mask
    (each row's tail past a random length) and NSP labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = np.where(rng.rand(b, s) < 0.15, ids, -100).astype(np.int64)
    types = (np.arange(s)[None, :] >= rng.randint(8, s - 8, (b, 1))).astype(np.int64)
    lengths = rng.randint(s // 2, s + 1, (b,))
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int64)
    nsp = rng.randint(0, 2, (b,)).astype(np.int64)
    return [torch.from_numpy(a) for a in (ids, labels, types, mask, nsp)]


def _topology(degrees, sharding=False):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    s.sharding = sharding
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return s


def resnet_engine(state, loss_fn=None, **kw):
    """resnet18 (10 classes) with ``state`` and its engine through
    fleet.distributed_engine on the topology fleet.init built last."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import state_from_jax
    from paddle_tpu_torch.vision.models import resnet18

    m = resnet18(num_classes=10, device="cpu")
    if next(iter(state.values())).dtype == np.float64:
        m = m.double()
    m.load_state_dict(state_from_jax(state))
    opt = optimizer.Momentum(learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
                             parameters=m.named_parameters())
    return fleet.distributed_engine(m, opt, loss_fn=loss_fn or nn.CrossEntropyLoss(), **kw)


def ernie_engine(state, **kw):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import ErnieForPretraining, ernie_tiny, load_jax_state

    m = load_jax_state(ErnieForPretraining(ernie_tiny(), device="cpu"), state)
    opt = optimizer.AdamW(learning_rate=ERNIE_LR, parameters=m.named_parameters(),
                          weight_decay=0.01)
    return fleet.distributed_engine(m, opt, **kw)


def _resnet_dp4(state):
    _topology({"dp_degree": 4})
    eng = resnet_engine(state)
    x, y = resnet_batch()
    losses = [eng.step(x, y).item() for _ in range(STEPS)]
    sd = eng.state_dict()["model"]
    return {"losses": losses, "state": {k: v.clone() for k, v in sd.items()}}


def _ernie_dp2_sh2(state):
    _topology({"dp_degree": 2, "sharding_degree": 2}, sharding=True)
    eng = ernie_engine(state)
    batch = ernie_batch()
    losses = [eng.step(*batch).item() for _ in range(STEPS)]
    held = sum(t.numel() for t in eng._zero_opt) if eng._zero_opt is not None else None
    replicated = 2 * sum(p.numel() for p in eng.params.values())
    sd = eng.state_dict()["model"]
    out = {"losses": losses, "opt_elems_held": held, "opt_elems_replicated": replicated,
           "replicas": eng.group.nranks}
    if torch.distributed.get_rank() == 0:
        out["state"] = {k: v.clone() for k, v in sd.items()}
    return out


def run_world(out_dir, resnet_state_path, ernie_state_path):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    results = {"resnet_dp4": _resnet_dp4(dict(np.load(resnet_state_path))),
               "ernie_dp2_sh2": _ernie_dp2_sh2(dict(np.load(ernie_state_path)))}
    torch.save(results, os.path.join(out_dir, f"rank{torch.distributed.get_rank()}.pt"))
