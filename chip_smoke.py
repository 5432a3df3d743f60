#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check every kernel it uses.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; the kernels
are built from the checkout's sources at first use. Phases, one JSON line
each:

1. environment: the card (nvidia-smi's name and power limit), torch and
   CUDA versions, then the kernel build time and ptxas's report.
2. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and a few edge cases, with kernel, plain, bound and
   library (yardstick only) times: the flash forward, then the FA2
   backward's dK/dV and dQ kernels.
3. scoring forward of GPT-2 124M (random weights from a seed), ids [8, 1024]:
   the flash kernel must launch exactly once per layer, the logits must be
   finite and the last position of one sequence must match the same
   weights run on the CPU.
4. serving: ServingEngine answers 8 greedy requests of 17-500 prompt tokens;
   requests re-run solo give the same tokens, and the bucketed prefill's
   logits (dense masked attention) match the scoring forward's (kernel).
5. profile: torch.profiler's CUDA kernel time in one scoring forward and in
   one decode chunk, over their untraced wall time (the device's busy
   share), with the kernels that take the most time.
6. train: TrainStepEngine steps of GPT-2 124M on ids [8, 1024] with
   labels = roll(ids, -1), AdamW(1e-4, weight_decay 0.01), under the port's
   bf16 auto_cast (bench.py's step): 3 warm-up and 10 timed steps on one
   batch. Every step launches each of the three kernels once per layer;
   the loss is finite and falls; every gradient is finite and not all zero.
   Step time, tokens/s, peak memory, and one profiled step's busy share;
   then 1 + 3 steps of the same step in f32 (step time only).
7. train_vs_cpu: one f32 step at full width and 2 layers, ids [1, 1024], on
   the card and on the CPU (plain path): loss and every gradient.
8. the ``kernels`` line: every ported kernel with its launches on the
   training main path (phase 6's timed steps) and its numbers from phase 2
   at that path's shape and dtype (bf16).

Any failure raises (exit code 1). Without a CUDA card, or without the
package beside it, the script exits non-zero before printing a result. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core rate
              torch.float32: 67e12}          # FP32 units (no TF32)

F32_TOL = 1e-4          # kernel vs plain, f32: summation order only
BF16_TOL = 2e-2         # kernel vs plain, bf16: times max|o| (p rounds to bf16
                        # against a running, not final, max)
LOGITS_TOL = 2e-3       # card vs CPU, or kernel vs dense masked path, f32
                        # logits of ~0.5 scale after 12 layers
GRAD_F32_TOL = 1e-4     # backward kernels vs plain, f32: times max(1, max|ref|)
TRAIN_LOSS_RTOL = 1e-5  # card vs CPU f32 train step: the loss
TRAIN_GRAD_TOL = 1e-3   # ... and each gradient, times max|grad| of that tensor
                        # (f32 sums in other orders through 2 layers and the
                        # 50304-row LM head; a wrong gradient is off by O(1))


def emit(**rec):
    print(json.dumps(rec), flush=True)


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, sq, sk, d, causal, dtype, products=2, seq_tensors=None):
    """Least time of the card for attention work: each input read once, each
    output written once, and ``products`` matrix products over the (q, k)
    pairs these inputs need (the causal half only). ``seq_tensors`` =
    (tensors of length sq, of length sk, f32 rows of length sq) moved; the
    forward's (q and o, k and v, lse) by default."""
    if causal:
        pairs = (sq * (sq + 1) // 2 if sq <= sk
                 else sk * (sk + 1) // 2 + (sq - sk) * sk)
    else:
        pairs = sq * sk
    flops = 2 * products * d * b * h * pairs
    n_q, n_k, n_rows = seq_tensors or (2, 2, 1)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * b * h * (n_q * sq + n_k * sk) + 4 * b * h * sq * n_rows
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def phase_env():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit(phase="env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))
    from paddle_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    per_source = _build.build()
    report = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                     if "registers" in ln or "spill" in ln]
              for name in per_source}
    emit(phase="build", seconds=time.perf_counter() - t0, per_source=per_source,
         ptxas=report)
    return card


def phase_kernels_fwd():
    """Flash forward vs its plain version; returns the records by case."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (name, b, sq, sk, h, d, causal, dtype)
        ("slice_f32_causal", 8, 1024, 1024, 12, 64, True, torch.float32),
        ("slice_bf16_causal", 8, 1024, 1024, 12, 64, True, torch.bfloat16),
        ("slice_f32_noncausal", 8, 1024, 1024, 12, 64, False, torch.float32),
        ("sq128_sk1024_f32_causal", 8, 128, 1024, 12, 64, True, torch.float32),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, torch.float32),
    ]
    recs = {}
    for name, b, sq, sk, h, d, causal, dtype in cases:
        q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
        k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
        v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
        o, lse = fa.flash_attention_with_lse(q, k, v, causal=causal)
        torch.cuda.synchronize()
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        if dtype == torch.float32:
            tol_o = tol_lse = F32_TOL
        else:
            tol_o = BF16_TOL * po.float().abs().max().item()
            tol_lse = BF16_TOL * plse.abs().max().item()
        if not (err_o <= tol_o and err_lse <= tol_lse):
            raise AssertionError(f"flash kernel disagrees with its plain version "
                                 f"on {name}: |do| {err_o} (tol {tol_o}), "
                                 f"|dlse| {err_lse} (tol {tol_lse})")
        kernel_ms = cuda_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=causal))
        plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                           iters=5)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype)
        rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err_o=err_o,
                   max_abs_err_lse=err_lse, tol_o=tol_o, tol_lse=tol_lse,
                   kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        emit(phase="kernel_vs_plain", kernel="flash_attention_fwd", **rec)
        recs[name] = rec
        del q, k, v, o, lse, po, plse, qt, kt, vt
    torch.cuda.empty_cache()
    return recs


def phase_kernels_bwd():
    """The FA2 backward's dK/dV and dQ kernels vs their plain version, with
    SDPA's backward (all three gradients at once) as the library yardstick.
    Returns {case: {"dkdv": rec, "dq": rec}}."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [  # (name, b, sq, sk, h, d, causal, dtype)
        ("train_bf16_causal", 8, 1024, 1024, 12, 64, True, torch.bfloat16),
        ("train_f32_causal", 8, 1024, 1024, 12, 64, True, torch.float32),
        ("sq512_sk1024_f32_noncausal", 8, 512, 1024, 12, 64, False, torch.float32),
        ("d128_bf16_causal", 8, 1024, 1024, 6, 128, True, torch.bfloat16),
    ]
    out = {}
    for name, b, sq, sk, h, d, causal, dtype in cases:
        q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, causal)
        dk, dv = fa.flash_attention_bwd_dkdv(*args)
        dq = fa.flash_attention_bwd_dq(*args)
        torch.cuda.synchronize()
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args)))
        got = {"dq": dq, "dk": dk, "dv": dv}
        err, tol = {}, {}
        for g in got:
            scale = want[g].float().abs().max().item()
            tol[g] = (GRAD_F32_TOL * max(1.0, scale) if dtype == torch.float32
                      else BF16_TOL * scale)
            err[g] = (got[g].float() - want[g].float()).abs().max().item()
            if not err[g] <= tol[g]:
                raise AssertionError(f"flash backward kernel disagrees with its "
                                     f"plain version on {name}: |{g}| error "
                                     f"{err[g]} (tol {tol[g]})")
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=3)
        qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_()
                      for x in (q, k, v))
        ot = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                              is_causal=causal)
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                         retain_graph=True))
        rows = {}
        for kernel, fn, grads, products, moved in (
                ("dkdv", lambda: fa.flash_attention_bwd_dkdv(*args), ("dk", "dv"),
                 4, (2, 4, 2)),    # q, dO in; k, v in, dk, dv out; lse, delta
                ("dq", lambda: fa.flash_attention_bwd_dq(*args), ("dq",),
                 3, (3, 2, 2))):   # q, dO in, dq out; k, v in; lse, delta
            bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype,
                                                 products, moved)
            rows[kernel] = dict(
                case=name, shape=[b, sq, sk, h, d], causal=causal,
                dtype=str(dtype).replace("torch.", ""),
                max_abs_err=max(err[g] for g in grads),
                tol=min(tol[g] for g in grads), kernel_ms=cuda_ms(fn),
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)
            emit(phase="kernel_vs_plain", kernel=f"flash_attention_bwd_{kernel}",
                 **rows[kernel], plain="flash_attention_bwd_plain (dq, dk, dv)",
                 library="scaled_dot_product_attention backward (dq, dk, dv)")
        out[name] = rows
        del q, k, v, do, o, lse, delta, dk, dv, dq, want, got, qt, kt, vt, ot, dot
    torch.cuda.empty_cache()
    return out


def phase_score(model, cpu_model, ids):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = model.config
    fa.launches = 0
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    launches = fa.launches
    if launches != cfg.num_layers:
        raise AssertionError(f"scoring forward launched the flash kernel "
                             f"{launches} times, expected {cfg.num_layers}")
    if tuple(logits.shape) != (*ids.shape, cfg.vocab_size):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("scoring forward produced non-finite logits")

    with torch.no_grad():
        ref = cpu_model(ids[:1].cpu())[0, -1]
    err = (logits[0, -1].cpu() - ref).abs().max().item()
    if not err <= LOGITS_TOL:
        raise AssertionError(f"card vs CPU last-position logits differ by {err}")

    iters = 3
    with torch.no_grad():
        ms = cuda_ms(lambda: model(ids), iters=iters, warmup=1)
    tokens = ids.numel()
    emit(phase="score", model="gpt2-124m", batch=list(ids.shape), launches=launches,
         logits_max_abs_err_vs_cpu=err, tol=LOGITS_TOL, forward_ms=ms,
         tokens_per_s=tokens / (ms / 1e3))
    return logits, launches, ms


def device_profile(fn, top=5):
    """Run fn under torch.profiler; returns (traced wall ms, summed CUDA
    kernel ms, the ``top`` kernels with the most time). One stream, so
    kernel times do not overlap."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / 1e3
    total = sum(per_kernel.values())
    if not total > 0:
        raise AssertionError("the profiler recorded no device time")
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]
    return wall, total, [[name[:80], ms] for name, ms in ranked]


def phase_profile(model, ids, forward_ms):
    from paddle_tpu_torch.serving import ServingEngine

    with torch.no_grad():
        wall, kernel_ms, top = device_profile(lambda: model(ids))
    emit(phase="profile", what="score_forward", batch=list(ids.shape),
         wall_ms_untraced=forward_ms, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / forward_ms, top_kernels=top)

    eng = ServingEngine(model, slot_count=4, ladder=(64, 128, 256, 512),
                        max_new_cap=32, steps_per_dispatch=8)
    for n in (17, 60, 100, 150):
        eng.submit(ids[0, :n].cpu().numpy(), max_new_tokens=32, temperature=0.0)
    eng.step()                       # admits all four, runs the first chunk
    t0 = time.perf_counter()
    eng.step()                       # a decode chunk alone (ends in a device read)
    chunk_ms = (time.perf_counter() - t0) * 1e3
    wall, kernel_ms, top = device_profile(eng.step)
    eng.run()
    emit(phase="profile", what="decode_chunk", slots=4,
         steps=eng.steps_per_dispatch, wall_ms_untraced=chunk_ms,
         wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / chunk_ms, top_kernels=top)


def phase_serve(model, ids, logits):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, slot_count=4, ladder=(64, 128, 256, 512),
                        max_new_cap=32, steps_per_dispatch=8)
    lengths = [17, 60, 100, 150, 220, 300, 400, 500]
    prompts = [ids[i % ids.shape[0], :n].cpu().numpy() for i, n in enumerate(lengths)]
    fa.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32, temperature=0.0) for p in prompts]
    eng.run()
    wall = time.perf_counter() - t0
    serve_launches = fa.launches
    decode_tokens, decode_s = eng.decode_tokens, eng.decode_seconds
    if not all(r.done and r.outcome == "length" and len(r.tokens) == 32
               for r in reqs):
        raise AssertionError(f"not every request completed: {reqs}")
    vocab = model.config.vocab_size
    if not all(0 <= t < vocab for r in reqs for t in r.tokens):
        raise AssertionError("a token id is out of the vocabulary")

    # slot independence: the same request alone on the engine
    for i in (1, 6):
        solo = eng.submit(prompts[i], max_new_tokens=32, temperature=0.0)
        eng.run()
        if solo.tokens != reqs[i].tokens:
            raise AssertionError(f"request {i} solo gave other tokens")

    # dense masked prefill vs the kernel's scoring forward at the same position
    prefill_err = 0.0
    for i in (0, 7):
        got = eng.score_prompt(prompts[i])
        want = logits[i % ids.shape[0], lengths[i] - 1]
        prefill_err = max(prefill_err, (got - want).abs().max().item())
    if not prefill_err <= LOGITS_TOL:
        raise AssertionError(f"prefill logits differ from the scoring forward "
                             f"by {prefill_err}")
    ttft = [r.ttft_s * 1e3 for r in reqs]
    emit(phase="serve", requests=len(reqs), completed=sum(r.done for r in reqs),
         prompt_lengths=lengths, new_tokens=[len(r.tokens) for r in reqs],
         ttft_ms_p50=statistics.median(ttft), ttft_ms_max=max(ttft),
         decode_tokens_per_s=decode_tokens / decode_s,
         decode_tokens=decode_tokens, decode_s=decode_s, wall_s=wall,
         prefill_logits_max_abs_err_vs_score=prefill_err, tol=LOGITS_TOL,
         flash_launches=serve_launches)


def _launch_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dkdv": fa.launches_dkdv,
            "flash_attention_bwd_dq": fa.launches_dq}


def _reset_launch_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    fa.launches = fa.launches_dkdv = fa.launches_dq = 0


def _train_engine(cfg, device, seed=0):
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForPretraining(cfg, device=device, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                weight_decay=0.01)
    return model, TrainStepEngine(model, opt)


def _steps(engine, ids, labels, n):
    """n engine steps; returns (losses, host ms of each, ending in a device
    read)."""
    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(engine.step(ids, labels).item())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


def phase_train(ids):
    """bench.py's step on the port: GPT-2 124M, bf16 auto_cast, AdamW; then
    the same step in f32. Returns the launch counts of the timed bf16 steps
    (the main path's run)."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig()
    model, engine = _train_engine(cfg, "cuda")
    labels = torch.roll(ids, -1, 1)
    warmup, steps = 3, 10
    torch.cuda.reset_peak_memory_stats()
    with auto_cast(dtype="bfloat16"):
        losses, _ = _steps(engine, ids, labels, warmup)
        _reset_launch_counts()
        timed, step_ms = _steps(engine, ids, labels, steps)
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        losses += timed
        for name, n in launches.items():
            if n != steps * cfg.num_layers:
                raise AssertionError(f"{steps} train steps launched {name} {n} "
                                     f"times, expected {steps * cfg.num_layers}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite training loss: {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        for name, p in model.named_parameters():
            g = p.grad
            if g is None or not bool(torch.isfinite(g).all()) or not bool(g.any()):
                raise AssertionError(f"the gradient of {name} is missing, "
                                     f"non-finite or all zero")
        median_ms = statistics.median(step_ms)
        wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels),
                                              top=10)
    emit(phase="train", model="gpt2-124m", batch=list(ids.shape), amp="bfloat16 O1",
         optimizer="AdamW(lr=1e-4, weight_decay=0.01)", warmup_steps=warmup,
         timed_steps=steps, losses=losses, step_ms=step_ms, step_ms_median=median_ms,
         tokens_per_s=ids.numel() / (median_ms / 1e3),
         launches=launches, launches_per_step={k: v // steps for k, v in launches.items()},
         max_memory_allocated_bytes=peak)
    emit(phase="profile", what="train_step", batch=list(ids.shape),
         wall_ms_untraced=median_ms, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / median_ms, top_kernels=top)

    # the same step without autocast: every product in f32 (no TF32)
    f32_losses, f32_ms = _steps(engine, ids, labels, 4)
    if not all(math.isfinite(x) for x in f32_losses):
        raise AssertionError(f"non-finite f32 training loss: {f32_losses}")
    f32_median = statistics.median(f32_ms[1:])
    emit(phase="train_f32", model="gpt2-124m", batch=list(ids.shape),
         warmup_steps=1, timed_steps=3, losses=f32_losses, step_ms=f32_ms[1:],
         step_ms_median=f32_median, tokens_per_s=ids.numel() / (f32_median / 1e3))
    return launches


def phase_train_vs_cpu():
    """One f32 step at full width, 2 layers, [1, 1024]: card vs CPU."""
    from paddle_tpu_torch.models import GPTConfig

    cfg = GPTConfig(num_layers=2)
    gen = torch.Generator().manual_seed(3)
    ids = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen)
    labels = torch.roll(ids, -1, 1)
    out = {}
    for device in ("cuda", "cpu"):
        model, engine = _train_engine(cfg, device, seed=1)
        _reset_launch_counts()
        loss = engine.step(ids, labels).item()
        out[device] = (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
                       _launch_counts())
        del model, engine
    (l_gpu, g_gpu, n_gpu), (l_cpu, g_cpu, n_cpu) = out["cuda"], out["cpu"]
    if set(n_gpu.values()) != {cfg.num_layers} or set(n_cpu.values()) != {0}:
        raise AssertionError(f"launches: card {n_gpu}, CPU {n_cpu}")
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU loss {l_gpu} vs {l_cpu}")
    worst = {}
    for name, g in g_cpu.items():
        scale = g.abs().max().item()
        err = (g_gpu[name] - g).abs().max().item()
        worst[name] = err / scale if scale else err
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"card vs CPU gradient of {name}: {err} "
                                 f"(max|g| {scale})")
    name = max(worst, key=worst.get)
    emit(phase="train_vs_cpu", model="gpt2-124m width, 2 layers", batch=[1, 1024],
         dtype="float32", loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, params=len(g_cpu),
         grad_worst_rel_err=worst[name], grad_worst_param=name,
         grad_tol=TRAIN_GRAD_TOL)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    # f32 parity on the card: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_env()
    fwd = phase_kernels_fwd()
    bwd = phase_kernels_bwd()

    cfg = GPTConfig()      # GPT-2 124M at full width and depth
    model = GPTForPretraining(cfg, seed=0)
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    logits, _, forward_ms = phase_score(model, cpu_model, ids)
    del cpu_model
    phase_serve(model, ids, logits)
    del logits
    phase_profile(model, ids, forward_ms)
    del model
    torch.cuda.empty_cache()

    launches = phase_train(ids)
    torch.cuda.empty_cache()
    phase_train_vs_cpu()

    # the training main path runs attention in bf16 at [8, 1024, 12, 64]
    main = {"flash_attention_fwd": fwd["slice_bf16_causal"],
            "flash_attention_bwd_dkdv": bwd["train_bf16_causal"]["dkdv"],
            "flash_attention_bwd_dq": bwd["train_bf16_causal"]["dq"]}
    sources = {"flash_attention_fwd": ("flash_attention_fwd.cu",
                                       "paddle_tpu/ops/pallas/flash_attention.py:114"),
               "flash_attention_bwd_dkdv": ("flash_attention_bwd.cu",
                                            "paddle_tpu/ops/pallas/flash_attention.py:242"),
               "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                                          "paddle_tpu/ops/pallas/flash_attention.py:268")}
    kernels = []
    for name, rec in main.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": rec.get("max_abs_err", rec.get("max_abs_err_o")),
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
