"""Rank bodies of tests/test_torch_fsdp.py (a helper module: pytest does not
collect it). It imports torch and the port only, never jax: ``spawn``
imports it again in every rank.

``save_world4(out_dir, state_path)`` runs in 4 gloo ranks: an FSDP engine on
gpt_tiny saves a checkpoint at step 2 through ``enable_checkpointing``
(async), and rank 0 writes the saved parameters to ``out_dir/saved4.pt``.
``run_cases(out_dir, state_path, ckpt_dir)`` runs in 2 gloo ranks: every
case of ``CASES`` (FSDP on gpt_tiny with the JAX model's weights, ids [8,
128], AdamW(1e-3, weight decay 0.01)), then the world-4 checkpoint restored
into FSDP, ZeRO and replicated engines; each rank saves {case: result} to
``out_dir/rank<r>.pt``.
"""
from __future__ import annotations

import os
import warnings

import torch

import torch_dp_workers as W

STEPS = W.STEPS


def _flags(**kw):
    import paddle_tpu_torch as P

    base = {"grad_comm_dtype": "f32", "grad_comm_error_feedback": False,
            "zero_update": False, "fsdp": False, "fsdp_prefetch": 2,
            "grad_comm_chunk": 1024}
    base.update(kw)
    P.set_flags(base)


def _engine(state, fsdp=True, zero=False, k=1, opt_kw=None, rule="AdamW"):
    from paddle_tpu_torch.distributed import fleet

    m = W._model(state)
    opt = W.make_opt(m.named_parameters(), rule, opt_kw)
    return m, fleet.distributed_engine(m, opt, microbatches=k, zero_update=zero, fsdp=fsdp)


def _full(e):
    """The engine's full parameters and optimizer state (gathered under
    FSDP and ZeRO: every rank calls it)."""
    return ({n: t.clone() for n, t in e._full_params().items()},
            {n: tuple(s.clone() for s in slots) for n, slots in e._full_opt().items()})


def train(state, steps=STEPS, k=1, dtype="f32", ef=False, fsdp=True, zero=False,
          unequal=False, prefetch=2, opt_kw=None, flag=False, rule="AdamW"):
    """A fresh FSDP (or other) engine's ``steps`` steps on the global batch:
    losses, gathered parameters and state, their digest, the counters'
    increments, the memory model, what each rank holds, warnings."""
    _flags(grad_comm_dtype=dtype, grad_comm_error_feedback=ef, fsdp_prefetch=prefetch,
           fsdp=flag)
    m, e = _engine(state, fsdp=fsdp and not flag, zero=zero, k=k, opt_kw=opt_kw,
                   rule=rule)
    ids, labels = W.batch(unequal=unequal)
    c0 = W._counters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        losses = [e.step(ids, labels).item() for _ in range(steps)]
    c1 = W._counters()
    params, opt = _full(e)
    engaged = e._fsdp_params is not None
    out = {"losses": losses, "params": params, "opt": opt, "digest": W._digest(params),
           "counters": {key: c1[key] - c0[key] for key in c0},
           "n": e._n_grad_elems(), "fsdp_engaged": engaged,
           "zero_engaged": e._zero_opt is not None,
           "warnings": [str(w.message) for w in caught
                        if "fsdp" in str(w.message) or "zero_update" in str(w.message)],
           "residual_numel": None if e._grad_residual is None else e._grad_residual.numel()}
    if engaged:
        out["memory_model"] = e.fsdp_memory_model()
        out["held"] = {"model_numel": sum(p.numel() for p in m.parameters()),
                       "opt_states": len(e.optimizer._states),
                       "param_shards": [s.numel() for s in e._fsdp_params],
                       "opt_shards": [[s.numel() for s in col] for col in e._fsdp_opt],
                       "order": list(e._fsdp_order),
                       "prefetch": e._fsdp_prefetch()}
    return out


def _strip(r, rank):
    """Rank 0 keeps the tensors; every rank keeps their digest."""
    r = dict(r)
    if rank != 0:
        r.pop("params", None)
        r.pop("opt", None)
    return r


def case_payloads(state, rank):
    out = {}
    for name, kw in {"f32_k1": {}, "f32_k2": {"k": 2, "unequal": True},
                     "bf16_ef": {"dtype": "bf16", "ef": True},
                     "int8_ef": {"dtype": "int8", "ef": True}}.items():
        out[name] = _strip(train(state, **kw), rank)
    return out


def case_vs_replicated(state, rank):
    """5 steps at K = 2, f32: FSDP against the replicated update."""
    return {"replicated": _strip(train(state, steps=5, k=2, fsdp=False), rank),
            "fsdp": _strip(train(state, steps=5, k=2), rank)}


def case_prefetch(state, rank):
    return {d: _strip(train(state, prefetch=d), rank) for d in (0, 1, 2, 3)}


def case_modes(state, rank):
    """FSDP supersedes ZeRO; FLAGS_fsdp engages it; an ineligible clip warns
    once and runs the replicated update."""
    from paddle_tpu_torch.optimizer import ClipGradByNorm

    clip = {"grad_clip": ClipGradByNorm(0.5)}
    return {"with_zero": _strip(train(state, zero=True), rank),
            "flag": _strip(train(state, flag=True), rank),
            "clip_fsdp": _strip(train(state, opt_kw=clip), rank),
            "clip_replicated": _strip(train(state, fsdp=False, opt_kw=clip), rank)}


def case_rules(state, rank):
    """Each rule of RULE_KW replicated and under FSDP: the elementwise ones
    engage it, Lamb and Lars warn and fall back."""
    return {rule: {"replicated": _strip(train(state, fsdp=False, rule=rule), rank),
                   "fsdp": _strip(train(state, rule=rule), rank)}
            for rule in W.RULE_KW}


def case_restore_world4(state, rank, ckpt_dir):
    """The world-4 FSDP checkpoint restored at world 2 into FSDP, ZeRO and
    replicated engines: the restored parameters, then 3 more steps each."""
    from paddle_tpu_torch.distributed import elastic

    out = {}
    for mode, kw in {"fsdp": {}, "zero": {"fsdp": False, "zero": True},
                     "replicated": {"fsdp": False}}.items():
        _flags()
        m, e = _engine(state, **kw)
        ids, labels = W.batch()
        e.step(ids, labels)       # engage the target's own layout first
        step = elastic.restore_latest(e, ckpt_dir)
        params, opt = _full(e)
        cont = [e.step(ids, labels).item() for _ in range(STEPS)]
        out[mode] = _strip({"step": step, "params": params, "opt": opt,
                            "continued": cont, "engine_step": e._step_count,
                            "fsdp_engaged": e._fsdp_params is not None,
                            "zero_engaged": e._zero_opt is not None,
                            "digest": W._digest(e._full_params())}, rank)
    return out


CASES = {"payloads": case_payloads, "vs_replicated": case_vs_replicated,
         "prefetch": case_prefetch, "modes": case_modes, "rules": case_rules}


def _join(world):
    torch.set_num_threads(2)
    torch.use_deterministic_algorithms(True)  # the embedding's backward in one order
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    return fleet.worker_index()


def run_cases(out_dir, state_path, ckpt_dir):
    import numpy as np

    rank = _join(2)
    state = dict(np.load(state_path))
    results = {name: case(state, rank) for name, case in CASES.items()}
    results["restore_world4"] = case_restore_world4(state, rank, ckpt_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def save_world4(out_dir, state_path, ckpt_dir):
    import numpy as np

    rank = _join(4)
    state = dict(np.load(state_path))
    _flags()
    m, e = _engine(state)
    e.enable_checkpointing(ckpt_dir, interval=2, keep=3, async_save=True)
    ids, labels = W.batch()
    losses = [e.step(ids, labels).item() for _ in range(2)]
    e._ckpt.wait()
    params, opt = _full(e)
    e.disable_checkpointing()
    if rank == 0:
        torch.save({"losses": losses, "params": params, "opt": opt,
                    "fsdp_engaged": e._fsdp_params is not None},
                   os.path.join(out_dir, "saved4.pt"))


def cuda_fsdp_case(out_dir):
    """The card tests' rank body (tests/test_torch_cuda.py): gpt_tiny on the
    rank's card, f32, ids [8, 128], AdamW(1e-3, weight decay 0.01), 3 steps a
    run through fleet on NCCL: the replicated f32 reduce, FSDP at prefetch
    depths 0 and 2, FSDP's bf16 and int8 payloads with error feedback; then
    an FSDP checkpoint taken at step 2 of a fresh run and restored into a
    new FSDP engine, which takes steps 3 and 4. Saves {run: {losses, params}}
    to ``out_dir/rank<r>.pt``."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    ids, labels = W.batch()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)

    def engine(fsdp):
        m = GPTForPretraining(gpt_tiny(), seed=7)
        return fleet.distributed_engine(
            m, AdamW(W.LR, parameters=m.named_parameters(), weight_decay=0.01), fsdp=fsdp)

    def run(fsdp=True, steps=STEPS, **flags):
        _flags(**flags)
        e = engine(fsdp)
        losses = [e.step(ids, labels).item() for _ in range(steps)]
        return e, {"losses": losses, "engaged": e._fsdp_params is not None,
                   "params": {n: t.cpu() for n, t in e._full_params().items()}}

    out = {"f32": run(fsdp=False)[1], "fsdp_pf0": run(fsdp_prefetch=0)[1],
           "fsdp_pf2": run(fsdp_prefetch=2)[1],
           "fsdp_bf16_ef": run(grad_comm_dtype="bf16", grad_comm_error_feedback=True)[1],
           "fsdp_int8_ef": run(grad_comm_dtype="int8", grad_comm_error_feedback=True)[1]}
    ckpt_dir = os.path.join(out_dir, "ckpt")
    _flags()
    e, out["fsdp_4"] = run(steps=4)
    e2 = engine(True)
    e2.enable_checkpointing(ckpt_dir, interval=2, async_save=True)
    [e2.step(ids, labels) for _ in range(2)]
    e2.disable_checkpointing()
    e3 = engine(True)
    e3.enable_checkpointing(ckpt_dir, interval=100, resume=True)
    out["resumed_step"] = e3._step_count
    out["resumed"] = {"losses": [e3.step(ids, labels).item() for _ in range(2)],
                      "params": {n: t.cpu() for n, t in e3._full_params().items()}}
    e3.disable_checkpointing()
    torch.save(out, os.path.join(out_dir, f"rank{fleet.worker_index()}.pt"))
