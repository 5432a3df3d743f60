"""Rank bodies of tests/test_torch_dp.py (a helper module: pytest does not
collect it). It imports torch and the port only, never jax: ``spawn``
imports it again in every rank.

``run_cases(out_dir, state_path)`` runs in each of 2 gloo ranks: it joins
the group through ``fleet.init(device="cpu")``, runs every case of
``CASES`` on gpt_tiny (weights from the JAX model's state in
``state_path``; ids [8, 128] from ``RandomState``; AdamW(1e-3, weight
decay 0.01)) and saves {case: result} to ``out_dir/rank<r>.pt``. The
tests read the files.
"""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

LR = 1e-3
STEPS = 3


def batch(b=8, s=128, seed=0, unequal=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    labels = np.roll(ids, -1, 1)
    labels[:, -1] = -100
    if unequal:                 # microbatches with unequal counts of labels
        labels[1, :5] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


def _counters():
    from paddle_tpu_torch.distributed import grad_comm as gc

    return {s.name: s.get() for s in (gc.STEPS, gc.MICROBATCHES, gc.BYTES_MOVED,
                                      gc.LOWP_STEPS, gc.RS_BYTES, gc.AG_BYTES)}


def _digest(params):
    h = hashlib.sha256()
    for n in sorted(params):
        h.update(params[n].numpy().tobytes())
    return h.hexdigest()


# the optimizers of the rule cases: each rule's own hyperparameters, lr LR
RULE_KW = {"Adamax": {}, "Adagrad": {}, "Adadelta": {"learning_rate": 0.5},
           "RMSProp": {"centered": True, "momentum": 0.9}, "Lamb": {}, "Lars": {}}


def make_opt(params, rule="AdamW", opt_kw=None):
    """``rule``'s optimizer over ``params`` at lr LR (AdamW with weight decay
    0.01; the others with RULE_KW's settings), plus ``opt_kw``."""
    from paddle_tpu_torch import optimizer

    kw = {"learning_rate": LR}
    kw.update({"weight_decay": 0.01} if rule == "AdamW" else RULE_KW[rule])
    kw.update(opt_kw or {})
    return getattr(optimizer, rule)(parameters=params, **kw)


def _model(state, **cfg_kw):
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state

    return load_jax_state(GPTForPretraining(gpt_tiny(**cfg_kw), device="cpu"), state)


def train(state, steps=STEPS, k=1, dtype="f32", ef=False, zero=False, unequal=False,
          hcg=None, opt_kw=None, keep_engine=False, rule="AdamW"):
    """A fresh model and engine through fleet.distributed_engine; ``steps``
    steps on the global batch. Returns the losses, the parameters, their
    digest, the counters' increments, the residual's size and max, and the
    warnings raised."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import TrainStepEngine, fleet

    P.set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef,
                 "zero_update": False, "grad_comm_chunk": 1024})
    m = _model(state)
    opt = make_opt(m.named_parameters(), rule, opt_kw)
    if hcg is None:
        e = fleet.distributed_engine(m, opt, microbatches=k, zero_update=zero)
    else:
        e = TrainStepEngine(m, opt, hcg=hcg, microbatches=k, zero_update=zero)
    ids, labels = batch(unequal=unequal)
    c0 = _counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = [e.step(ids, labels).item() for _ in range(steps)]
    c1 = _counters()
    params = {n: p.detach().clone() for n, p in m.named_parameters()}
    res = e._grad_residual
    out = {"losses": losses, "params": params, "digest": _digest(params),
           "counters": {k2: c1[k2] - c0[k2] for k2 in c0},
           "n": e._n_grad_elems(), "zero_engaged": e._zero_opt is not None,
           "residual_numel": None if res is None else res.numel(),
           "residual_absmax": None if res is None else res.abs().max().item(),
           "warnings": [str(w.message) for w in caught
                        if "zero_update" in str(w.message)]}
    if keep_engine:
        out["engine"] = e
    return out


def _strip(r, rank):
    """Rank 0 keeps the parameters; every rank keeps their digest."""
    r = dict(r)
    r.pop("engine", None)
    if rank != 0:
        r.pop("params")
    return r


def case_payloads(state, rank):
    out = {}
    for name, kw in {"f32_k1": {}, "f32_k2": {"k": 2, "unequal": True},
                     "bf16": {"dtype": "bf16"}, "bf16_ef": {"dtype": "bf16", "ef": True},
                     "int8": {"dtype": "int8"}, "int8_ef": {"dtype": "int8", "ef": True},
                     "zero_f32": {"zero": True}, "zero_bf16": {"zero": True, "dtype": "bf16"},
                     "zero_int8_ef": {"zero": True, "dtype": "int8", "ef": True}}.items():
        out[name] = _strip(train(state, **kw), rank)
    return out


def case_zero_vs_replicated(state, rank):
    """5 steps at K = 2, f32: ZeRO and the replicated update; the shard each
    rank owns; the gathered optimizer state against the replicated dict."""
    from paddle_tpu_torch.distributed import grad_comm as gc

    rep = train(state, steps=5, k=2, keep_engine=True)
    zer = train(state, steps=5, k=2, zero=True, keep_engine=True)
    er, ez = rep.pop("engine"), zer.pop("engine")
    lay = ez._flat_layout(gc.chunk_size())
    rep_states = er.optimizer._states
    flat = [torch.cat([rep_states[nm][j].reshape(-1) for nm in lay.names]
                      + [torch.zeros(lay.n_pad - lay.n)]) for j in range(2)]
    lo = rank * lay.shard
    own = [torch.equal(ez._zero_opt[j], flat[j][lo:lo + lay.shard]) for j in range(2)]
    sd_z, sd_r = ez.state_dict()["optimizer"], er.state_dict()["optimizer"]
    same_sd = (sd_z.keys() == sd_r.keys()
               and all(torch.equal(sd_z[key], sd_r[key]) for key in sd_r
                       if key != "_step_count"))
    return {"replicated": _strip(rep, rank), "zero": _strip(zer, rank),
            "names": lay.names, "offsets": dict(lay.offsets), "shard": lay.shard,
            "n": lay.n, "n_pad": lay.n_pad, "own_shard_equal": own,
            "opt_states_left": len(ez.optimizer._states),
            "zero_opt_numel": [s.numel() for s in ez._zero_opt],
            "state_dict_equal": same_sd,
            "memory_model": ez.zero_memory_model()}


def case_fallbacks(state, rank):
    """Each fallback warns once and equals the replicated step; the clips
    ZeRO takes engage."""
    from paddle_tpu_torch.optimizer import (ClipGradByGlobalNorm, ClipGradByNorm,
                                            ClipGradByValue)

    out = {}
    for name, kw in {
            "decay_exclusion": {"apply_decay_param_fun": lambda n: not n.endswith(".bias")},
            "clip_by_norm": {"grad_clip": ClipGradByNorm(0.5)},
            "clip_by_value": {"grad_clip": ClipGradByValue(1e-3)},
            "clip_by_global_norm": {"grad_clip": ClipGradByGlobalNorm(0.5)}}.items():
        out[name] = {"replicated": _strip(train(state, opt_kw=kw), rank),
                     "zero": _strip(train(state, zero=True, opt_kw=kw), rank)}
    return out


def case_rules(state, rank):
    """Each rule of RULE_KW replicated and under ZeRO: the elementwise ones
    engage it, Lamb and Lars warn and fall back."""
    return {rule: {"replicated": _strip(train(state, rule=rule), rank),
                   "zero": _strip(train(state, zero=True, rule=rule), rank)}
            for rule in RULE_KW}


def case_sharding_degree(state, rank):
    """sharding_degree = 2 (dp 1) runs the ZeRO update without the flag."""
    from paddle_tpu_torch.distributed.mesh import HybridCommunicateGroup

    hcg = HybridCommunicateGroup(dp_degree=1, sharding_degree=2)
    r = _strip(train(state, hcg=hcg), rank)
    return {"run": r, "mode": hcg.get_parallel_mode(),
            "sharding_rank": hcg.get_sharding_parallel_rank(),
            "sharding_group": hcg.get_sharding_parallel_group().ranks}


def case_dropout(state, rank):
    """Masks differ across ranks; a run repeats exactly."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    P.set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False})
    ids, labels = batch()
    runs, masks = [], []
    for _ in range(2):
        m = _model(state, dropout=0.1)
        e = fleet.distributed_engine(m, AdamW(LR, parameters=m.named_parameters()),
                                     microbatches=2)
        runs.append([e.step(ids, labels).item() for _ in range(2)])
        e._seed_dropout(0)
        masks.append(torch.rand(4096, generator=m.generator) < 0.5)
    return {"runs": runs, "mask": masks[0], "masks_repeat": torch.equal(*masks)}


def case_divisibility(state, rank):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.optimizer import AdamW

    m = _model(state)
    e = fleet.distributed_engine(m, AdamW(LR, parameters=m.named_parameters()),
                                 microbatches=2)
    ids, labels = batch()
    try:
        e.step(ids[:6], labels[:6])
        msg = None
    except ValueError as err:
        msg = str(err)
    return {"message": msg, "four_rows": e.step(ids[:4], labels[:4]).item()}


def case_collectives(state, rank):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet

    hcg = fleet.get_hybrid_communicate_group()
    out = {"degrees": hcg.topology(), "nranks": hcg.nranks,
           "dp_rank": hcg.get_data_parallel_rank(), "global_rank": hcg.get_global_rank(),
           "dp_world": hcg.get_data_parallel_world_size(),
           "dp_group": hcg.get_data_parallel_group().ranks,
           "sharding_world": hcg.get_sharding_parallel_world_size(),
           "worker_index": fleet.worker_index(), "worker_num": fleet.worker_num(),
           "first": fleet.is_first_worker()}
    x = torch.tensor([rank + 1.0, 10.0])
    out["all_reduce"] = C.all_reduce(x.clone()).tolist()
    out["all_reduce_max"] = C.all_reduce(x.clone(), op=C.ReduceOp.MAX).tolist()
    out["all_reduce_avg"] = C.all_reduce(x.clone(), op=C.ReduceOp.AVG).tolist()
    out["all_gather"] = [t.tolist() for t in C.all_gather(None, x)]
    rs = torch.empty(2)
    out["reduce_scatter"] = C.reduce_scatter(rs, torch.arange(4.0) + rank).tolist()
    out["broadcast"] = C.broadcast(x.clone(), src=1).tolist()
    out["wait"] = C.wait(x).tolist()
    a2a = torch.empty(4, dtype=torch.int8)
    out["all_to_all"] = C.all_to_all_single(
        a2a, torch.arange(4, dtype=torch.int8) + 10 * rank).tolist()
    C.barrier()
    fleet.barrier_worker()
    return out


CASES = {"payloads": case_payloads, "zero_vs_replicated": case_zero_vs_replicated,
         "fallbacks": case_fallbacks, "rules": case_rules,
         "sharding_degree": case_sharding_degree,
         "dropout": case_dropout, "divisibility": case_divisibility,
         "collectives": case_collectives}


def run_cases(out_dir, state_path):
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    state = dict(np.load(state_path))
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    rank = fleet.worker_index()
    results = {name: case(state, rank) for name, case in CASES.items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def fail_on_rank(rank_to_fail, code):
    """A rank body for the spawn tests: the chosen rank exits with ``code``,
    the others wait in a barrier for it (and are ended by spawn)."""
    from paddle_tpu_torch.distributed import collective, init_parallel_env

    init_parallel_env(device="cpu")
    if int(os.environ["PADDLE_TRAINER_ID"]) == rank_to_fail:
        os._exit(code)
    collective.barrier()


def write_env(out_dir):
    """A rank body for the spawn tests: writes the rank's environment."""
    keys = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM", "PADDLE_LOCAL_RANK",
            "FLAGS_selected_gpus", "MASTER_ADDR", "MASTER_PORT",
            "TORCHELASTIC_USE_AGENT_STORE")
    rank = os.environ["PADDLE_TRAINER_ID"]
    with open(os.path.join(out_dir, f"env{rank}.txt"), "w") as f:
        f.write("\n".join(f"{k}={os.environ.get(k)}" for k in keys))


def hang():
    """A rank body for the spawn tests: never ends by itself."""
    import time

    time.sleep(3600)


def cuda_dp_case(out_dir):
    """The card tests' rank body (tests/test_torch_cuda.py): gpt_tiny on the
    rank's card, f32, ids [8, 128], AdamW(1e-3, weight decay 0.01), 3 steps
    a run: at world 1 the single-GPU engine first, then through fleet on
    NCCL the replicated f32 reduce, ZeRO, and the bf16 and int8 payloads
    with and without error feedback. Saves {run: {losses, params}} to
    ``out_dir/rank<r>.pt``."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch.distributed import TrainStepEngine, fleet
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    ids, labels = batch()

    def run(engine_of, dtype="f32", ef=False):
        P.set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef,
                     "zero_update": False, "grad_comm_chunk": 1024})
        m = GPTForPretraining(gpt_tiny(), seed=7)
        e = engine_of(m, AdamW(LR, parameters=m.named_parameters(), weight_decay=0.01))
        losses = [e.step(ids, labels).item() for _ in range(STEPS)]
        return {"losses": losses,
                "params": {n: p.detach().cpu() for n, p in m.named_parameters()}}

    out = {}
    if world == 1:
        out["plain"] = run(TrainStepEngine)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    out["f32"] = run(fleet.distributed_engine)
    out["zero"] = run(lambda m, o: fleet.distributed_engine(m, o, zero_update=True))
    for dtype in ("bf16", "int8"):
        for ef in (False, True):
            out[f"{dtype}{'_ef' if ef else ''}"] = run(fleet.distributed_engine, dtype, ef)
    torch.save(out, os.path.join(out_dir, f"rank{fleet.worker_index()}.pt"))
