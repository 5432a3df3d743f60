"""Rank bodies of tests/test_torch_fleet_eager.py (a helper module: pytest does
not collect it). It imports torch and the port only, never jax: ``spawn``
imports it again in every rank.

``run_cases(out_dir, state_path)`` runs in each of 2 gloo ranks: it joins
the group through ``fleet.init(device="cpu")`` at dp 2, runs every case of
``CASES`` through the eager entry points (``fleet.distributed_model``,
``fleet.distributed_optimizer``, ``group_sharded_parallel``) on gpt_tiny
(weights from the JAX model's state in ``state_path``) or on ``Branchy``,
and saves {case: result} to ``out_dir/rank<r>.pt``. Each rank takes its
rows ``[4r, 4r + 4)`` of the global ids [8, 128] (``batch``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

STEPS = 3
SGD_LR = 0.05
ADAMW_LR = 1e-3
WORLD = 2


def batch(b=8, s=128, seed=0):
    """The global ids and labels (every row's last label ignored, so every
    row has as many labels and the ranks' mean of means is the global
    mean)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def rows(t, rank, world=WORLD):
    return t.chunk(world)[rank]


def branch_weights(seed=0):
    """Branchy's weights, torch layout ([out, in]), from numpy."""
    rng = np.random.RandomState(seed)
    return {"a.weight": rng.randn(8, 8).astype(np.float32) * 0.5,
            "a.bias": rng.randn(8).astype(np.float32) * 0.1,
            "b.weight": rng.randn(1, 8).astype(np.float32) * 0.5,
            "b.bias": np.zeros(1, np.float32),
            "c.weight": rng.randn(1, 8).astype(np.float32) * 0.5,
            "c.bias": np.zeros(1, np.float32)}


def branch_inputs(seed=1):
    return np.random.RandomState(seed).randn(8, 8).astype(np.float32)


class Branchy(torch.nn.Module):
    """tanh(a x) into two heads b and c; ``use_c`` False skips c."""

    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(8, 8)
        self.b = torch.nn.Linear(8, 1)
        self.c = torch.nn.Linear(8, 1)
        self.load_state_dict({k: torch.from_numpy(v) for k, v in branch_weights().items()})

    def forward(self, x, use_c=True):
        h = torch.tanh(self.a(x))
        out = self.b(h)
        if use_c:
            out = out + self.c(h)
        return (out ** 2).mean()


def _gpt(state, seed_offset=None):
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state

    if seed_offset is not None:   # a fresh init of its own
        return GPTForPretraining(gpt_tiny(), device="cpu", seed=seed_offset)
    return load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)


def _opt(model, rule):
    from paddle_tpu_torch import optimizer

    if rule == "SGD":
        return optimizer.SGD(learning_rate=SGD_LR, parameters=model.named_parameters())
    return optimizer.AdamW(learning_rate=ADAMW_LR, parameters=model.named_parameters(),
                           weight_decay=0.01)


def _strategy(**flags):
    """A dp-2 strategy with ``flags``, given to fleet.init (the group is
    joined once; a second init rebuilds only the topology)."""
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": WORLD, "mp_degree": 1}
    for k, v in flags.items():
        setattr(s, k, v)
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return s


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _reducer_of(params):
    """The cached Reducer fleet.utils holds for ``params``' trainable set."""
    from paddle_tpu_torch.distributed.fleet import utils

    key = (tuple(id(p) for p in params if p.requires_grad and p.numel()), False)
    for slots in utils._reducer_cache.values():
        if key in slots:
            return slots[key]
    return None


def _global_mean(x):
    from paddle_tpu_torch.distributed import collective

    t = torch.tensor([x], dtype=torch.float64)
    collective.all_reduce(t, op=collective.ReduceOp.AVG)
    return t.item()


def _eager(state, rank, rule, steps=STEPS, **flags):
    """gpt_tiny through distributed_model and distributed_optimizer:
    ``steps`` of loss.backward(); opt.step(); opt.clear_grad() on the rank's
    rows."""
    from paddle_tpu_torch.distributed import fleet

    s = _strategy(**flags)
    m = _gpt(state)
    dp = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(_opt(m, rule), s)
    ids, labels = batch()
    losses, global_losses = [], []
    for _ in range(steps):
        loss = dp(rows(ids, rank), rows(labels, rank))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        global_losses.append(_global_mean(loss.item()))
    red = _reducer_of(m.parameters())
    return {"losses": losses, "global_losses": global_losses, "params": _params(m),
            "wrapper": type(dp).__name__, "applied": list(fleet.fleet._applied_meta_list),
            "n_collectives": None if red is None else red.n_collectives,
            "n_buckets": None if red is None else len(red._buckets)}


def case_sgd(state, rank):
    return _eager(state, rank, "SGD")


def case_adamw(state, rank):
    return _eager(state, rank, "AdamW")


def case_engine(state, rank):
    """The engine's replicated step on the global batch, the eager AdamW
    run's yardstick."""
    from paddle_tpu_torch.distributed import fleet

    s = _strategy()
    m = _gpt(state)
    eng = fleet.distributed_engine(m, fleet.distributed_optimizer(_opt(m, "AdamW"), s))
    ids, labels = batch()
    losses = [eng.step(ids, labels).item() for _ in range(STEPS)]
    return {"losses": losses, "params": _params(m)}


def case_no_sync(state, rank):
    """Two backward passes, the first under no_sync, then one step (SGD)."""
    from paddle_tpu_torch.distributed import fleet

    s = _strategy()
    m = _gpt(state)
    dp = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(_opt(m, "SGD"), s)
    ids, labels = (rows(t, rank) for t in batch())
    with dp.no_sync():
        dp(ids[:2], labels[:2]).backward()
        enabled_inside = dp._enable_sync
    dp(ids[2:], labels[2:]).backward()
    opt.step()
    red = _reducer_of(m.parameters())
    return {"params": _params(m), "enabled_inside": enabled_inside,
            "enabled_after": dp._enable_sync, "n_collectives": red.n_collectives,
            "n_buckets": len(red._buckets)}


def case_unused(state, rank):
    """Branchy with rank 1 skipping head c, find_unused_parameters on: the
    gradients after the HybridParallelOptimizer's sync, and after
    DataParallel.sync_gradients on the same backward."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet

    x = torch.from_numpy(branch_inputs())
    out = {}
    for path in ("optimizer", "sync_gradients"):
        s = _strategy(find_unused_parameters=True)
        m = Branchy()
        dp = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(
            optimizer.SGD(learning_rate=0.0, parameters=m.named_parameters()), s)
        dp(rows(x, rank), use_c=rank == 0).backward()
        if path == "optimizer":
            opt.step()
        else:
            dp.sync_gradients()
        out[path] = {n: p.grad.clone() for n, p in m.named_parameters()}
        out[f"{path}_find_unused"] = dp.find_unused_parameters
    return out


def case_broadcast(state, rank):
    """Divergent inits (a seed a rank) made equal by broadcast_dp_parameters."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.utils import broadcast_dp_parameters

    m = _gpt(state, seed_offset=100 + rank)
    before = _params(m)
    broadcast_dp_parameters(m, fleet.get_hybrid_communicate_group())
    return {"before": before, "after": _params(m)}


def case_localsgd(state, rank):
    """LocalSGD, k = 2, SGD: 4 steps on the rank's rows."""
    from paddle_tpu_torch.distributed import fleet

    s = _strategy(localsgd=True)
    s.localsgd_configs = {"k_steps": 2, "begin_step": 1}
    m = _gpt(state)
    dp = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(_opt(m, "SGD"), s)
    ids, labels = (rows(t, rank) for t in batch())
    after = []
    for _ in range(4):
        dp(ids, labels).backward()
        opt.step()
        opt.clear_grad()
        after.append(_params(m))
    return {"after_step": after, "applied": list(fleet.fleet._applied_meta_list)}


def case_gradient_merge(state, rank):
    """Gradient merge, k = 2 with avg, SGD: 4 micro-steps on the halves of
    the rank's rows (2 updates)."""
    from paddle_tpu_torch.distributed import fleet

    s = _strategy(gradient_merge=True)
    s.gradient_merge_configs = {"k_steps": 2, "avg": True}
    m = _gpt(state)
    dp = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(_opt(m, "SGD"), s)
    ids, labels = (rows(t, rank) for t in batch())
    for i in range(4):
        half = slice(0, 2) if i % 2 == 0 else slice(2, 4)
        dp(ids[half], labels[half]).backward()
        opt.step()
        opt.clear_grad()
    return {"params": _params(m), "applied": list(fleet.fleet._applied_meta_list)}


def _sharded(state, rank, level, offload):
    from paddle_tpu_torch.distributed import group_sharded_parallel

    _strategy()
    m = _gpt(state)
    model, opt = group_sharded_parallel(m, _opt(m, "AdamW"), level, offload=offload)
    ids, labels = (rows(t, rank) for t in batch())
    losses = []
    for _ in range(STEPS):
        loss = model(ids, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    states = [s for st in opt._states.values() for s in st]
    return {"losses": losses, "params": _params(m), "wrapper": type(model).__name__,
            "state_devices": sorted({s.device.type for s in states}),
            "n_state": len(states)}


def case_stage2_offload(state, rank):
    return _sharded(state, rank, "os_g", True)


def case_stage3(state, rank):
    return _sharded(state, rank, "p_g_os", False)


CASES = {"sgd": case_sgd, "adamw": case_adamw, "engine": case_engine,
         "no_sync": case_no_sync, "unused": case_unused, "broadcast": case_broadcast,
         "localsgd": case_localsgd, "gradient_merge": case_gradient_merge,
         "stage2_offload": case_stage2_offload, "stage3": case_stage3}


def run_cases(out_dir, state_path):
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    state = dict(np.load(state_path))
    _strategy()
    rank = fleet.worker_index()
    results = {name: case(state, rank) for name, case in CASES.items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
