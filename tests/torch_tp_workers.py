"""Rank bodies of tests/test_torch_tp_sp.py (a helper module: pytest does
not collect it). It imports torch and the port only, never jax: ``spawn``
imports it again in every rank.

``run_world(out_dir, state_path, world)`` runs in each of ``world`` gloo
ranks (torch on one intra-op thread): each case builds its topology with
``fleet.init(strategy, device="cpu")`` (the first call joins the group),
its model after it (weights from the JAX model's state in ``state_path``,
each rank taking its mp shards) and its engine with
``fleet.distributed_engine``; the training cases run gpt_tiny on the global
batch ``batch()``. It saves {case: result} to ``out_dir/rank<r>.pt``. The
tests read the files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

LR = 1e-3
SGD_LR = 0.1
STEPS = 3
RESUME_STEPS = 2


def batch(b=4, s=64, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(np.roll(ids, -1, 1))


def qkv(sp=4):
    """test_sequence_parallel.py's fixture: q, k, v [2, 64, 4, 16] f32."""
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(2, 64, 4, 16).astype(np.float32)) for _ in range(3)]


def ce_inputs():
    """Logits [12, 32] and labels with two positions at ignore_index."""
    rng = np.random.RandomState(7)
    logits = rng.randn(12, 32).astype(np.float32) * 3
    labels = rng.randint(0, 32, (12,)).astype(np.int64)
    labels[[2, 9]] = -100
    return logits, labels


def _topology(degrees, impl="ulysses"):
    from paddle_tpu_torch.distributed import fleet

    fleet.init(is_collective=True, strategy=_strategy(degrees, impl), device="cpu")
    return fleet.get_hybrid_communicate_group()


def _strategy(degrees, impl="ulysses"):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    s.sep_impl = impl
    return s


def _engine(state, rule="AdamW", clip=None, zero=False, k=1, **cfg):
    """gpt_tiny from ``state`` and its engine on the topology fleet.init
    built last."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state

    m = load_jax_state(GPTForPretraining(gpt_tiny(**cfg), device="cpu"), state)
    if rule == "SGD":
        opt = optimizer.SGD(learning_rate=SGD_LR, parameters=m.named_parameters(),
                            grad_clip=clip)
    else:
        opt = optimizer.AdamW(learning_rate=LR, parameters=m.named_parameters(),
                              weight_decay=0.01, grad_clip=clip)
    return fleet.distributed_engine(m, opt, zero_update=zero, microbatches=k)


def _train(state, degrees, impl="ulysses", rule="AdamW", clip=None, zero=False, k=1,
           steps=STEPS, resume=False, ckpt_dir=None, **cfg):
    """``steps`` steps on the global batch; the losses and (rank 0) the
    gathered logical parameters; ``resume``: also the gathered state after
    them and the losses of RESUME_STEPS more steps; ``ckpt_dir``: a blocking
    checkpoint there after the ``steps``."""
    from paddle_tpu_torch.distributed.elastic import CheckpointManager

    _topology(degrees, impl)
    eng = _engine(state, rule, clip, zero, k, **cfg)
    out = {"zero": None}
    ids, labels = batch()
    out["losses"] = [eng.step(ids, labels).item() for _ in range(steps)]
    out["zero"] = eng._zero_opt is not None
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir, async_save=False).save(eng, block=True)
    sd = eng.state_dict()
    if torch.distributed.get_rank() == 0:
        out["params"] = {k: v.clone() for k, v in sd["model"].items()}
    if resume:
        local = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
        eng.set_state_dict(sd)   # the logical state sliced back: the same shards
        out["set_state_dict_same"] = all(
            torch.equal(local[n], p) for n, p in eng.model.named_parameters())
        if torch.distributed.get_rank() == 0:
            out["state"] = sd
        out["resumed"] = [eng.step(ids, labels).item() for _ in range(RESUME_STEPS)]
    return out


def _attention(world):
    """Ring (causal and not) and Ulysses at sp = world on qkv(): the rank's
    output block and its gradients of sum(out * v)."""
    from paddle_tpu_torch.distributed.meta_parallel import sequence_parallel as sp

    hcg = _topology({"sep_degree": world})
    group = hcg.get_sep_parallel_group()
    r = group.rank
    out = {}
    for impl, fn in (("ring", sp.ring_attention), ("ulysses", sp.ulysses_attention)):
        for causal in (False, True):
            q, k, v = (x.chunk(world, dim=1)[r].clone().requires_grad_() for x in qkv())
            o = fn(q, k, v, group=group, causal=causal)
            (o * v).sum().backward()
            out[(impl, causal)] = [t.detach().clone() for t in (o, q.grad, k.grad, v.grad)]
    return out


def _parallel_ce(world):
    """ParallelCrossEntropy at mp = world: the loss and the rank's slice of
    the gradient of its mean."""
    from paddle_tpu_torch.distributed.meta_parallel import ParallelCrossEntropy

    hcg = _topology({"mp_degree": world})
    r = hcg.get_model_parallel_rank()
    logits, labels = ce_inputs()
    x = torch.from_numpy(logits).chunk(world, dim=-1)[r].clone().requires_grad_()
    loss = ParallelCrossEntropy()(x, torch.from_numpy(labels))
    loss.mean().backward()
    return {"loss": loss.detach().clone(), "grad": x.grad.clone()}


def _rng_tracker():
    """dp 2 x mp 2: a dropout mask drawn inside the tracker's mp state, and
    one outside it."""
    from paddle_tpu_torch.distributed.meta_parallel import (get_rng_state_tracker,
                                                            model_parallel_random_seed)
    from paddle_tpu_torch.ops import nn_functional as F

    hcg = _topology({"dp_degree": 2, "mp_degree": 2})
    model_parallel_random_seed(1234)
    with get_rng_state_tracker().rng_state():
        inside = F.dropout(torch.ones(256), 0.5, training=True) != 0
    outside = F.dropout(torch.ones(256), 0.5, training=True) != 0
    return {"inside": inside, "outside": outside,
            "mp_rank": hcg.get_model_parallel_rank(), "dp_rank": hcg.get_data_parallel_rank()}


def _refusals(state):
    """What still raises at mp 2 (ROADMAP.md Queue 1 item 9)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.clip import ClipGradByNorm

    _topology({"dp_degree": 2, "mp_degree": 2})
    ids, labels = batch()
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)

    eng = _engine(state)
    attempt("health", lambda: (eng.enable_health(interval=1), eng.step(ids, labels)))
    eng = _engine(state)
    P.set_flags({"grad_comm_dtype": "bf16"})
    try:
        attempt("bf16", lambda: eng.step(ids, labels))
    finally:
        P.set_flags({"grad_comm_dtype": "f32"})
    eng = _engine(state)
    eng.fsdp = True
    attempt("fsdp", lambda: eng.step(ids, labels))
    attempt("clip_by_norm", lambda: _engine(state, "SGD", ClipGradByNorm(1.0)))
    attempt("generate", lambda: eng.model.generate(ids[:1, :4], max_new_tokens=2))
    attempt("distributed_model", lambda: fleet.fleet.distributed_model(eng.model))
    return out


def _world4(state, out_dir):
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    mp2 = {"dp_degree": 2, "mp_degree": 2}
    return {
        "dp2mp2_sgd": _train(state, mp2, rule="SGD"),
        "dp2mp2_adamw": _train(state, mp2, resume=True,
                               ckpt_dir=os.path.join(out_dir, "ckpt_mp2")),
        "dp2mp2_zero": _train(state, mp2, zero=True),
        "dp2mp2_clip": _train(state, mp2, rule="SGD", clip=ClipGradByGlobalNorm(0.5)),
        "dp2mp2_zero_clip": _train(state, mp2, rule="SGD", clip=ClipGradByGlobalNorm(0.5),
                                   zero=True),
        "dp4_clip": _train(state, {"dp_degree": 4}, rule="SGD",
                           clip=ClipGradByGlobalNorm(0.5)),
        "dp2sp2_ring": _train(state, {"dp_degree": 2, "sep_degree": 2}, impl="ring"),
        "sharding2sp2_ring_k2": _train(state, {"sharding_degree": 2, "sep_degree": 2},
                                       impl="ring", k=2),
        **{f"dp2sp2_ring_{g}": _train(state, {"dp_degree": 2, "sep_degree": 2}, impl="ring",
                                      use_recompute=True, recompute_granularity=g)
           for g in ("full", "selective")},
        "attention": _attention(4),
        "parallel_ce": _parallel_ce(4),
        "rng": _rng_tracker(),
        "refusals": _refusals(state),
    }


def _world8(state, out_dir):
    return {
        "dp2mp2sp2": _train(state, {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}),
        "dp2mp2sp2_ring": _train(state, {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2},
                                 impl="ring"),
        "dp2mp4_sgd": _train(state, {"dp_degree": 2, "mp_degree": 4}, rule="SGD"),
        "dp2mp4_adamw": _train(state, {"dp_degree": 2, "mp_degree": 4}),
        "dp2sp4_ulysses": _train(state, {"dp_degree": 2, "sep_degree": 4}),
    }


# a topology of each world to report, then the cases
WORLDS = {4: ({"dp_degree": 2, "mp_degree": 2}, _world4),
          8: ({"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}, _world8)}


def run_world(out_dir, state_path, world):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    state = dict(np.load(state_path))
    degrees, cases = WORLDS[world]
    hcg = _topology(degrees)
    rank = fleet.worker_index()
    results = {"topology": {"mode": hcg.get_parallel_mode(),
                            "mp_rank": hcg.get_model_parallel_rank(),
                            "mp_world": hcg.get_model_parallel_world_size(),
                            "mp_group": hcg.get_model_parallel_group().ranks,
                            "sp_world": hcg.get_sep_parallel_world_size(),
                            "sp_group": hcg.get_sep_parallel_group().ranks,
                            "replica_group": hcg.replica_group().ranks},
               **cases(state, out_dir)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
