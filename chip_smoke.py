#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one NVIDIA card and check every kernel it uses.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card; the kernels
are built from the checkout's sources at first use. Phases, one JSON line
each:

1. environment: the card (nvidia-smi's name and power limit), torch and
   CUDA versions, then the kernel build time and ptxas's report.
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and a few edge cases, with kernel, plain, bound and
   library (yardstick only) times.
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
6. the ``kernels`` line: every ported kernel with its launches on the main
   path (phase 3) and its numbers from phase 2.

Any failure raises (exit code 1). Without a CUDA card, or without the
package beside it, the script exits non-zero before printing a result. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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


def attention_bound(b, h, sq, sk, d, causal, dtype):
    """Least time of the card for this attention: each input read once, each
    output written once, and the products these inputs need (the causal
    half only)."""
    if causal:
        pairs = (sq * (sq + 1) // 2 if sq <= sk
                 else sk * (sk + 1) // 2 + (sq - sk) * sk)
    else:
        pairs = sq * sk
    flops = 4 * d * b * h * pairs
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * b * h * (2 * sq + 2 * sk) + 4 * b * h * sq
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


def phase_kernels():
    """Flash forward vs its plain version; returns the main path's entry."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (name, b, sq, sk, h, d, causal, dtype)
        ("slice_f32_causal", 8, 1024, 1024, 12, 64, True, torch.float32),
        ("slice_bf16_causal", 8, 1024, 1024, 12, 64, True, torch.bfloat16),
        ("slice_f32_noncausal", 8, 1024, 1024, 12, 64, False, torch.float32),
        ("sq128_sk1024_f32_causal", 8, 128, 1024, 12, 64, True, torch.float32),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, torch.float32),
    ]
    main = None
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
        if name == "slice_f32_causal":   # the dtype and shape of the main path
            main = rec
        del q, k, v, o, lse, po, plse, qt, kt, vt
    torch.cuda.empty_cache()
    return main


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


def device_profile(fn):
    """Run fn under torch.profiler; returns (traced wall ms, summed CUDA
    kernel ms, the five kernels with the most time). One stream, so kernel
    times do not overlap."""
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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
    return wall, total, [[name[:80], ms] for name, ms in top]


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
    main_rec = phase_kernels()

    cfg = GPTConfig()      # GPT-2 124M at full width and depth
    model = GPTForPretraining(cfg, seed=0)
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    logits, launches, forward_ms = phase_score(model, cpu_model, ids)
    del cpu_model
    phase_serve(model, ids, logits)
    del logits
    phase_profile(model, ids, forward_ms)

    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:114",
        "launches": launches,
        "max_abs_err": main_rec["max_abs_err_o"],
        "ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_ms"],
        "bound_by": main_rec["bound_by"],
        "library_ms": main_rec["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
