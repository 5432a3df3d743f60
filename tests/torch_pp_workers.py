"""Rank bodies of tests/test_torch_pipeline.py (a helper module: pytest does
not collect it). It imports torch and the port only, never jax: ``spawn``
imports it again in every rank.

``run_world(out_dir, state_path, world)`` runs in each of ``world`` gloo
ranks (torch on one intra-op thread, deterministic algorithms): each case
builds its topology with ``fleet.init(strategy, device="cpu")``, its
``GPTForPretrainingPipe`` after it (weights from the JAX Pipe's state in
``state_path``, stacked [L, ...] and reshaped to the case's stages, each
rank taking its stage and mp shards) and its engine with
``fleet.distributed_engine``; the training cases run the small config on
the global batch ``batch()``. It saves {case: result} to
``out_dir/rank<r>.pt``. The tests read the files.
"""
from __future__ import annotations

import os

import numpy as np
import torch

LR = 1e-3
SGD_LR = 0.1
STEPS = 3
SGD_STEPS = 2
RESUME_STEPS = 2
MICRO = 4
CFG = dict(vocab_size=256, hidden_size=64, num_layers=4, num_heads=4, max_seq_len=64,
           dropout=0.0, attention_dropout=0.0)
MOE = dict(d_model=16, d_hidden=32, num_experts=4)


def batch(b=8, s=64, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (b, s)).astype(np.int64)
    return torch.from_numpy(ids), torch.from_numpy(np.roll(ids, -1, 1))


def stacked_state(state, stages, virtual=1):
    """The [L, ...] stacked leaves of ``state`` (a one-stage Pipe's, leading
    [1, L]) reshaped to ``stages`` x ``virtual`` (chunk-major)."""
    from paddle_tpu_torch.models.convert import PIPE_STACKED

    lead = (virtual, stages) if virtual > 1 else (stages,)
    out = {}
    for n, a in state.items():
        if n in PIPE_STACKED:
            n_layers = a.shape[0] * a.shape[1]
            a = a.reshape(lead + (n_layers // (stages * virtual),) + a.shape[2:])
        out[n] = a
    return out


def tanh_case(seed=0, S=2, Lp=2, M=8, mb=2, d=16, V=1):
    """tests/test_pipeline.py's tanh stages: params (numpy) and x [M, mb, d]."""
    rng = np.random.RandomState(seed)
    lead = (V, S) if V > 1 else (S, Lp)
    params = {"w": rng.randn(*lead, d, d).astype(np.float32) * 0.3,
              "b": rng.randn(*lead, d).astype(np.float32) * 0.1}
    return params, rng.randn(M, mb, d).astype(np.float32)


def tanh_body(lp, x):
    """A stage: y = tanh(x w + b) for each of its layers (or its one chunk)."""
    if lp["w"].dim() == 2:
        return torch.tanh(x @ lp["w"] + lp["b"])
    for i in range(lp["w"].shape[0]):
        x = torch.tanh(x @ lp["w"][i] + lp["b"][i])
    return x


def moe_inputs(seed=5, n=24):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, n // 2, MOE["d_model"]).astype(np.float32),
            rng.randn(2, n // 2, MOE["d_model"]).astype(np.float32))


class MoENet(torch.nn.Module):
    """x -> MoELayer -> mean squared error against y (an engine model)."""

    def __init__(self, top_k=2, capacity_factor=1.0):
        super().__init__()
        from paddle_tpu_torch.distributed.meta_parallel import MoELayer

        self.moe = MoELayer(top_k=top_k, capacity_factor=capacity_factor, **MOE)

    def forward(self, x, y):
        return ((self.moe(x) - y) ** 2).mean()


def _topology(degrees):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = degrees
    fleet.init(is_collective=True, strategy=s, device="cpu")
    return fleet.get_hybrid_communicate_group()


def _optimizer(m, rule, clip=None):
    from paddle_tpu_torch import optimizer

    if rule == "SGD":
        return optimizer.SGD(learning_rate=SGD_LR, parameters=m.named_parameters(),
                             grad_clip=clip)
    return optimizer.AdamW(learning_rate=LR, parameters=m.named_parameters(),
                           weight_decay=0.01, grad_clip=clip)


def _pipe(state, virtual=1, micro=MICRO):
    """The Pipe of the topology fleet.init built last, from ``state``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTConfig, GPTForPretrainingPipe, load_jax_state

    hcg = fleet.get_hybrid_communicate_group()
    m = GPTForPretrainingPipe(GPTConfig(**CFG), num_microbatches=micro,
                              num_virtual_stages=virtual, device="cpu")
    m = load_jax_state(m, stacked_state(state, hcg.get_pipe_parallel_world_size(), virtual))
    return fleet.distributed_model(m)


def _train(state, degrees, virtual=1, rule="AdamW", clip=None, zero=False, k=1,
           steps=None, resume=False, ckpt_dir=None, micro=MICRO):
    """Steps on the global batch; the losses and (rank 0) the gathered
    logical parameters; ``resume``: also the gathered state, whether
    set_state_dict gives the shards back bit for bit, and the losses of
    RESUME_STEPS more steps; ``ckpt_dir``: a blocking checkpoint there."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.elastic import CheckpointManager

    _topology(degrees)
    m = _pipe(state, virtual, micro)
    eng = fleet.distributed_engine(m, _optimizer(m, rule, clip), zero_update=zero,
                                   microbatches=k)
    ids, labels = batch()
    steps = steps or (SGD_STEPS if rule == "SGD" else STEPS)
    out = {"losses": [eng.step(ids, labels).item() for _ in range(steps)],
           "zero": eng._zero_opt is not None}
    if ckpt_dir is not None:
        CheckpointManager(ckpt_dir, async_save=False).save(eng, block=True)
    sd = eng.state_dict()
    if torch.distributed.get_rank() == 0:
        out["params"] = {n: v.clone() for n, v in sd["model"].items()}
    if resume:
        local = {n: p.detach().clone() for n, p in eng.model.named_parameters()}
        eng.set_state_dict(sd)
        out["set_state_dict_same"] = all(
            torch.equal(local[n], p) for n, p in eng.model.named_parameters())
        if torch.distributed.get_rank() == 0:
            out["state"] = sd
        out["resumed"] = [eng.step(ids, labels).item() for _ in range(RESUME_STEPS)]
    return out


def _tanh_pipelines(world):
    """spmd_pipeline (S = world) and the interleaved pipeline (P = world,
    V = 2; and V = 4 at P = 2) over the pp group: the output and the
    gradients of sum(out ** 2), this rank's stage slice of the parameters'
    gradients, and x's."""
    from paddle_tpu_torch.distributed.pipeline_schedule import (spmd_pipeline,
                                                                spmd_pipeline_interleaved)

    hcg = _topology({"pp_degree": world})
    group, r = hcg.get_pipe_parallel_group(), hcg.get_stage_id()
    out = {}
    cases = [("plain", 1)] + [(f"v{v}", v) for v in ((2, 4) if world == 2 else (2,))]
    for name, V in cases:
        params, x = tanh_case(S=world, V=V)
        sl = (slice(None), slice(r, r + 1)) if V > 1 else (slice(r, r + 1),)
        p = {n: torch.from_numpy(a[sl].copy()).requires_grad_() for n, a in params.items()}
        xt = torch.from_numpy(x).requires_grad_()
        if V > 1:
            y = spmd_pipeline_interleaved(tanh_body, p, xt, group, V)
        else:
            y = spmd_pipeline(tanh_body, p, xt, group)
        (y ** 2).sum().backward()
        out[name] = {"y": y.detach().clone(), "x": xt.grad.clone(),
                     **{n: t.grad.clone() for n, t in p.items()}}
    return out


def _moe(world):
    """ep = world: MoELayer's output and gradients of sum(out * y) (the
    gate's, the rank's experts', x's) at top_k 1 and 2 and with capacity
    overflow; then 2 SGD engine steps of MoENet (losses, rank 0's gathered
    parameters). Every net from torch.manual_seed(0): the experts are drawn
    as the logical tensors and sliced, so each rank holds its experts of
    the one-rank net's."""
    from paddle_tpu_torch.distributed import fleet

    _topology({"ep_degree": world})
    xs, ys = (torch.from_numpy(a) for a in moe_inputs())
    out = {}
    for k, cf in ((1, 2.0), (2, 2.0), (2, 0.5)):
        torch.manual_seed(0)
        net = MoENet(k, cf)
        x = xs.clone().requires_grad_()
        y = net.moe(x)
        (y * ys).sum().backward()
        out[(k, cf)] = {"y": y.detach().clone(), "x": x.grad.clone(),
                        **{n: p.grad.clone() for n, p in net.named_parameters()}}
    torch.manual_seed(0)
    net = MoENet(2, 1.0)
    eng = fleet.distributed_engine(net, _optimizer(net, "SGD"))
    out["engine"] = {"losses": [eng.step(xs, ys).item() for _ in range(SGD_STEPS)]}
    sd = eng.state_dict()
    if torch.distributed.get_rank() == 0:
        out["engine"]["params"] = {n: v.clone() for n, v in sd["model"].items()}
    return out


def _refusals(state):
    """What still raises at pp 2 (ROADMAP.md Queue 1 item 11)."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.nn.clip import ClipGradByNorm

    _topology({"pp_degree": 2})
    ids, labels = batch()
    out = {}

    def attempt(name, fn):
        try:
            fn()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)

    def engine(rule="AdamW", clip=None):
        m = _pipe(state)
        return fleet.distributed_engine(m, _optimizer(m, rule, clip))

    eng = engine()
    attempt("health", lambda: (eng.enable_health(interval=1), eng.step(ids, labels)))
    eng = engine()
    P.set_flags({"grad_comm_dtype": "bf16"})
    try:
        attempt("bf16", lambda: eng.step(ids, labels))
    finally:
        P.set_flags({"grad_comm_dtype": "f32"})
    eng = engine()
    eng.fsdp = True
    attempt("fsdp", lambda: eng.step(ids, labels))
    attempt("clip_by_norm", lambda: engine("SGD", ClipGradByNorm(1.0)))
    try:
        fleet.fleet.distributed_model(torch.nn.Linear(2, 2))
        out["distributed_model"] = None
    except RuntimeError as e:
        out["distributed_model"] = str(e)
    return out


def _world2(state, out_dir):
    pp2 = {"pp_degree": 2}
    return {
        "pp2_adamw": _train(state, pp2, resume=True, ckpt_dir=os.path.join(out_dir, "ckpt_pp2")),
        "pp2_sgd": _train(state, pp2, rule="SGD"),
        "pp2v2_adamw": _train(state, pp2, virtual=2),
        "pp2v2_sgd": _train(state, pp2, virtual=2, rule="SGD"),
        "tanh": _tanh_pipelines(2),
        "moe": _moe(2),
        "refusals": _refusals(state),
    }


def _world4(state, out_dir):
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

    pp2dp2 = {"pp_degree": 2, "dp_degree": 2}
    return {
        "pp4_adamw": _train(state, {"pp_degree": 4}),
        "pp4_sgd": _train(state, {"pp_degree": 4}, rule="SGD"),
        "pp2dp2_adamw": _train(state, pp2dp2),
        "pp2dp2_sgd": _train(state, pp2dp2, rule="SGD"),
        "pp2dp2_zero_k2": _train(state, pp2dp2, zero=True, k=2, micro=2),
        "pp2dp2_zero": _train(state, pp2dp2, zero=True),
        "pp2mp2_clip": _train(state, {"pp_degree": 2, "mp_degree": 2}, rule="SGD",
                              clip=ClipGradByGlobalNorm(0.5)),
        "pp2dp2_zero_clip": _train(state, pp2dp2, rule="SGD",
                                   clip=ClipGradByGlobalNorm(0.5), zero=True),
        "dp4_clip": _train(state, {"dp_degree": 4}, rule="SGD",
                           clip=ClipGradByGlobalNorm(0.5)),
        "tanh": _tanh_pipelines(4),
    }


def _world8(state, out_dir):
    deg = {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}
    return {
        "dp2mp2pp2_adamw": _train(state, deg),
        "dp2mp2pp2_sgd": _train(state, deg, rule="SGD"),
        "dp2mp2pp2v2_adamw": _train(state, deg, virtual=2),
    }


# a topology of each world to report, then the cases
WORLDS = {2: ({"pp_degree": 2}, _world2),
          4: ({"pp_degree": 2, "dp_degree": 2}, _world4),
          8: ({"dp_degree": 2, "mp_degree": 2, "pp_degree": 2}, _world8)}


def run_world(out_dir, state_path, world):
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    state = dict(np.load(state_path))
    degrees, cases = WORLDS[world]
    hcg = _topology(degrees)
    rank = fleet.worker_index()
    results = {"topology": {"mode": hcg.get_parallel_mode(),
                            "stage": hcg.get_stage_id(),
                            "pp_world": hcg.get_pipe_parallel_world_size(),
                            "pp_group": hcg.get_pipe_parallel_group().ranks,
                            "mp_group": hcg.get_model_parallel_group().ranks,
                            "dp_group": hcg.get_data_parallel_group().ranks,
                            "ep_group": hcg.get_expert_parallel_group().ranks,
                            "replica_group": hcg.replica_group().ranks},
               **cases(state, out_dir)}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
