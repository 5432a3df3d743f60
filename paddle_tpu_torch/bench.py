"""Training benchmark of the port (counterpart of the repository's bench.py):
GPT causal-LM training throughput per card.

    python -m paddle_tpu_torch.bench                                # base, on the card
    PADDLE_TPU_BENCH_MODEL=medium python -m paddle_tpu_torch.bench
    PADDLE_TPU_BENCH_DEVICE=cpu python -m paddle_tpu_torch.bench   # gpt_tiny, plain path
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 -m paddle_tpu_torch.bench

Prints ONE JSON line, bench.py's: {"metric":
"gpt_pretrain_tokens_per_sec_per_chip", "value": N, "unit": "tokens/s/chip",
"vs_baseline": null, "extra": {...}}. The step is bench.py's:
``TrainStepEngine`` with AdamW(1e-4, weight_decay 0.01) under the port's
bf16 ``auto_cast`` (f32 on the CPU), on one batch of ids from
``RandomState(0)``, after warm-up steps, timed in windows that each end in a
device read. ``extra`` has the windows and their spread, the first and final
loss, MFU against the H100's dense bf16 peak (bench.py's accounting,
observability/flops.py), the peak memory allocated, the decode tokens/s of
``generate`` (``PADDLE_TPU_BENCH_DECODE=1``), and the card's name and power
limit.

Under the launcher (``PADDLE_TRAINERS_NUM`` set) the run is bench.py's
data-parallel one: every rank joins the group through ``fleet.init`` with
``dp_degree`` = the world size, builds the engine with
``fleet.distributed_engine``, rounds the global batch to a multiple of the
world as bench.py does, and steps on the global batch (each rank takes its
rows). ``value`` is then the global tokens/s divided by the world size,
``devices`` the world size, the timing windows stay global tokens/s (as
bench.py's), MFU stays per card, ``max_memory_allocated_bytes``
is the largest over the ranks (each rank's in ``..._per_rank``), and
``grad_comm`` gives the payload, ZeRO, FSDP, the bytes a rank hands the
gradient collectives a step and each rank's allocated bytes after the
last step (``resident_bytes_per_rank``: FSDP's sharded state).
``FLAGS_grad_comm_dtype``, ``FLAGS_grad_comm_error_feedback``,
``FLAGS_grad_comm_chunk``, ``FLAGS_zero_update`` and ``FLAGS_fsdp`` reach it
through the environment. Only rank 0 prints,
and decodes.

The environment knobs are bench.py's: ``PADDLE_TPU_BENCH_MODEL`` (base or
medium), ``_BATCH``, ``_STEPS``, ``_SEQ``, ``_WINDOWS``, ``_RECOMPUTE``
("selective", or any other value for full), ``_ACCUM`` (in-program
microbatches), ``_SCAN`` ("1": warm-up and timed steps each one
``engine.run_steps`` call, the timed region one window), ``_PREFETCH``
("1": the steps fed through ``engine.prefetch``, each window ended by a
device read), ``_DECODE`` and ``_DECODE_INT8`` (the decode model's
projections weight-only int8). ``extra`` records ``scan`` and
``prefetch`` as bench.py does. The knobs whose machinery the port does not
have yet stop the script (``UNPORTED``). Unlike bench.py there is no
degraded retry and no history file: a failure fails the run, and nothing is
written.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from .amp import auto_cast
from .device import resolve_device
from .distributed import TrainStepEngine, collective, fleet
from .distributed import grad_comm as _gc
from .incubate.quantization import quantize_model
from .models import GPTConfig, GPTForPretraining, gpt_tiny
from .observability import card_peak_flops_per_sec, transformer_flops_per_token
from .optimizer import AdamW

#: bench.py's knobs whose machinery the port lacks, with the ROADMAP.md item
#: that brings it; any value stops the script
UNPORTED = {
    "PADDLE_TPU_BENCH_AUTOTUNE": "a block-size autotune of the flash kernels, "
                                 "whose tiles are fixed (ROADMAP.md Queue 2 "
                                 "follow-up 2)",
    "PADDLE_TPU_BENCH_AUTOTUNE_CACHE": "a block-size autotune of the flash "
                                       "kernels (ROADMAP.md Queue 2 follow-up 2)",
    "PADDLE_TPU_BENCH_CE_CHUNK": "a setting of the fused loss's chunk, which "
                                 "ops/fused.py fixes (ROADMAP.md Queue 1 item 6)",
}


def bench_config(model_name="base"):
    """bench.py's on-chip configs: (cfg, batch, seq, steps, warmup)."""
    if model_name == "medium":
        return (GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24,
                          num_heads=16, max_seq_len=1024), 8, 1024, 10, 2)
    # base = GPT-2 124M
    return (GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                      num_heads=12, max_seq_len=1024), 8, 1024, 20, 3)


def _window_plan(steps, n_windows):
    """Split the timed region into n window lengths (first windows take the
    remainder) so per-window throughput exposes run variance."""
    n = max(1, min(n_windows, steps))
    base, rem = divmod(steps, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _window_stats(window_dts, batch, seq):
    """Per-window tokens/s + median + relative spread.
    window_dts: list of (wall_seconds, steps_in_window)."""
    rates = [n * batch * seq / d for d, n in window_dts if n and d > 0]
    if not rates:
        return None
    med = statistics.median(rates)
    return {
        "windows": len(rates),
        "window_tokens_per_sec": [round(r, 1) for r in rates],
        "median_tokens_per_sec": round(med, 1),
        # (max-min)/median across windows; None needs >= 2 windows
        "rel_spread": (round((max(rates) - min(rates)) / med, 4)
                       if len(rates) > 1 else None),
    }


def card_name_and_power_limit():
    """nvidia-smi's ``name, power.limit`` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def run(cfg, batch, seq, steps, warmup, *, windows=3, recompute=None, accum=1,
        decode=False, decode_int8=False, device=None, dp=False, scan=False,
        prefetch=False):
    """bench.py's run on the port: returns the payload of its JSON line.

    cfg: a GPTConfig (copied; its max_seq_len follows seq). recompute: None,
    "full" or "selective". accum: microbatches a step. scan: the warm-up
    and the timed steps each one ``run_steps`` call (one window); prefetch:
    the steps fed through ``engine.prefetch`` (module docstring). decode: also time
    greedy ``generate`` of 64 tokens after a prompt of up to 128;
    decode_int8: of the decode model with every projection weight-only int8
    (``incubate.quantization.quantize_model``). device:
    None (the card; raises without one) or "cpu" (f32, no MFU). dp: the
    data-parallel run over the launcher's ranks (module docstring)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    n_dev, rank = 1, 0
    if dp:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": -1, "mp_degree": 1}
        fleet.init(is_collective=True, strategy=strategy, device=device)
        n_dev, rank = fleet.worker_num(), fleet.worker_index()
        if on_card:
            dev = torch.device("cuda", torch.cuda.current_device())
        if batch % n_dev:  # the batch dim shards over dp_degree = n_dev
            batch = max(n_dev, batch - batch % n_dev)
    cfg = copy.copy(cfg)
    if seq != cfg.max_seq_len:
        cfg.max_seq_len = seq
    if recompute is not None:
        cfg.use_recompute, cfg.recompute_granularity = True, recompute
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    labels = np.roll(ids, -1, 1)

    model = GPTForPretraining(cfg, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    engine = (fleet.distributed_engine(model, opt) if dp
              else TrainStepEngine(model, opt))
    k = engine.microbatches = max(1, int(accum))
    bytes0 = _gc.BYTES_MOVED.get()
    t_ids, t_labels = (torch.from_numpy(a).to(dev) for a in (ids, labels))
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    window_dts = []

    def repeat_batch(n):   # bench.py's: the batch already on the card passes through
        for _ in range(n):
            yield t_ids, t_labels

    with auto_cast(enable=on_card, dtype="bfloat16"):
        first_loss = None
        if scan:
            loss = engine.run_steps(t_ids, t_labels, steps=warmup)
            first_loss = float(loss[0].item())
        elif prefetch:
            for pb in engine.prefetch(repeat_batch(warmup)):
                loss = engine.step(*pb)
                if first_loss is None:
                    first_loss = float(loss.item())
        else:
            for _ in range(warmup):
                loss = engine.step(t_ids, t_labels)
                if first_loss is None:
                    first_loss = float(loss.item())
        if on_card:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if scan:   # one call: one window
            final_loss = float(engine.run_steps(t_ids, t_labels, steps=steps)[-1].item())
            window_dts.append((time.perf_counter() - t0, steps))
        elif prefetch:
            ends, acc = set(), 0
            for wn in _window_plan(steps, windows):
                acc += wn
                ends.add(acc)
            tw, done_prev, done = t0, 0, 0
            for pb in engine.prefetch(repeat_batch(steps)):
                loss = engine.step(*pb)
                done += 1
                if done in ends:
                    final_loss = float(loss.item())   # the window boundary's read
                    now = time.perf_counter()
                    window_dts.append((now - tw, done - done_prev))
                    tw, done_prev = now, done
        else:
            for wn in _window_plan(steps, windows):
                tw = time.perf_counter()
                for _ in range(wn):
                    loss = engine.step(t_ids, t_labels)
                final_loss = float(loss.item())   # the device read ends the window
                window_dts.append((time.perf_counter() - tw, wn))
        dt = time.perf_counter() - t0
    comm = None
    if dp:
        comm = {"dtype": _gc.comm_dtype(), "error_feedback": _gc.error_feedback(),
                "zero_update": engine._zero_opt is not None,
                "fsdp": engine._fsdp_params is not None,
                "bytes_per_step": (_gc.BYTES_MOVED.get() - bytes0) // (warmup + steps)}
        if on_card:
            comm["resident_bytes_per_rank"] = [int(t.item()) for t in collective.all_gather(
                None, torch.tensor([torch.cuda.memory_allocated(dev)], dtype=torch.int64,
                                   device=dev))]
    peak_bytes = peaks = None
    if on_card:
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        if dp:
            peaks = [int(t.item()) for t in collective.all_gather(
                None, torch.tensor([peak_bytes], dtype=torch.int64, device=dev))]
            peak_bytes = max(peaks)
    del engine, model, loss

    decode_tps = None
    if decode and rank == 0:
        dm = GPTForPretraining(cfg, device=dev, seed=0).eval()
        if decode_int8:
            quantize_model(dm)
        n_new = 64
        p_len = max(1, min(128, cfg.max_seq_len - n_new))
        prompt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, p_len))
                                  .astype(np.int64)).to(dev)
        with auto_cast(enable=on_card, dtype="bfloat16"):
            int(dm.generate(prompt, max_new_tokens=n_new, temperature=0)[0, -1])
            t0 = time.perf_counter()
            out = dm.generate(prompt, max_new_tokens=n_new, temperature=0)
            int(out[0, -1])                   # the device read ends the region
        decode_tps = round(batch * n_new / (time.perf_counter() - t0), 1)
        del dm, out

    tokens_per_sec = steps * batch * seq / dt / n_dev   # per card
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    # MFU with bench.py's accounting (PaLM appendix B: 6N + 12*L*h*s model
    # FLOPs a token; no recompute) against the H100's dense bf16 peak
    peak = card_peak_flops_per_sec(name) if on_card else None
    flops_tok = transformer_flops_per_token(n_params, cfg.num_layers,
                                            cfg.hidden_size, seq)
    mfu = flops_tok * tokens_per_sec / peak if peak else None
    mfu_param = transformer_flops_per_token(n_params) * tokens_per_sec / peak if peak else None
    return {
        "metric": "gpt_pretrain_tokens_per_sec_per_chip",
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/s/chip",
        "vs_baseline": None,
        "extra": {
            "model_params": int(n_params),
            "hidden": cfg.hidden_size, "layers": cfg.num_layers,
            "heads": cfg.num_heads, "batch": batch, "seq": seq,
            "steps": steps, "warmup": warmup,
            "first_loss": round(first_loss, 4) if first_loss is not None else None,
            "final_loss": round(final_loss, 4),
            "timing": _window_stats(window_dts, batch, seq),
            "platform": "gpu" if on_card else "cpu", "device": name, "devices": n_dev,
            "card": card_name_and_power_limit() if on_card else None,
            "amp": "bfloat16 O1" if on_card else None,
            "mfu_vs_h100_bf16_peak": round(mfu, 4) if mfu else None,
            "mfu_param_flops_only": round(mfu_param, 4) if mfu_param else None,
            "max_memory_allocated_bytes": peak_bytes,
            "max_memory_allocated_bytes_per_rank": peaks,
            "grad_comm": comm,
            "decode_tokens_per_sec": decode_tps,
            "recompute": recompute,
            "scan": "1" if scan else None,
            "prefetch": "1" if prefetch else None,
            "microbatches": k if k > 1 else None,
        },
    }


def main():
    env = os.environ
    for knob, needs in UNPORTED.items():
        if env.get(knob):
            raise SystemExit(f"{knob} is not ported: it needs {needs}")
    device = None
    if env.get("PADDLE_TPU_BENCH_DEVICE") == "cpu":
        device = "cpu"
        cfg, batch, seq, steps, warmup = gpt_tiny(), 8, 128, 5, 1
    else:
        model_name = env.get("PADDLE_TPU_BENCH_MODEL", "base")
        if model_name not in ("base", "medium"):
            raise SystemExit(f"PADDLE_TPU_BENCH_MODEL must be 'base' or "
                             f"'medium', got {model_name!r}")
        cfg, batch, seq, steps, warmup = bench_config(model_name)
    batch = int(env.get("PADDLE_TPU_BENCH_BATCH", batch))
    steps = int(env.get("PADDLE_TPU_BENCH_STEPS", steps))
    seq = int(env.get("PADDLE_TPU_BENCH_SEQ", seq))
    recompute = env.get("PADDLE_TPU_BENCH_RECOMPUTE") or None
    if recompute is not None and recompute != "selective":
        recompute = "full"
    payload = run(cfg, batch, seq, steps, warmup,
                  windows=int(env.get("PADDLE_TPU_BENCH_WINDOWS", "3")),
                  recompute=recompute,
                  accum=int(env.get("PADDLE_TPU_BENCH_ACCUM", "0") or 0),
                  decode=env.get("PADDLE_TPU_BENCH_DECODE") == "1",
                  decode_int8=env.get("PADDLE_TPU_BENCH_DECODE_INT8") == "1", device=device,
                  dp="PADDLE_TRAINERS_NUM" in env,
                  scan=env.get("PADDLE_TPU_BENCH_SCAN") == "1",
                  prefetch=env.get("PADDLE_TPU_BENCH_PREFETCH") == "1")
    if fleet.worker_index() == 0:
        print(json.dumps(payload), flush=True)


if __name__ == "__main__":
    main()
