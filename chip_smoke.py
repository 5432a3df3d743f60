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
   library (yardstick only) times: the flash forward (bf16 on the bf16
   tensor cores, f32 on the TF32 tensor cores in 3xTF32, each with its FMA
   predecessor checked and timed beside it), then the FA2 backward's dK/dV
   and dQ kernels (the same routes, each with the FMA pair checked and
   timed beside it), with SDPA's FA2 (flash backend) forward and backward
   pinned as the bf16 yardstick and SDPA's default dispatch as the f32 one;
   the bf16 kernels also at gpt_1p3b's [4, 2048, 16, 128], timed.
3. scoring forward of GPT-2 124M (random weights from a seed), ids [8, 1024]:
   the flash kernel (the 3xTF32 one: scoring is f32) must launch exactly
   once per layer, the logits must be
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
   batch. Every step launches each of the three kernels once per layer
   (all three on the tensor cores);
   the loss is finite and falls; every gradient is finite and not all zero.
   Step time, tokens/s, peak memory, and one profiled step's busy share;
   then 1 + 3 steps of the same step in f32 (train_f32: 12 launches a step
   of each 3xTF32 kernel, the forward and the backward pair), its step time
   and one profiled f32 step.
7. train_vs_cpu: one f32 step at full width and 2 layers, ids [1, 1024], on
   the card (the 3xTF32 forward and backward pair) and on the CPU (plain
   path): loss and every gradient.
7a. dp: data parallelism (phase_dp) at one rank a card, in processes of
   the port's spawn with a deadline of their own: GPT-2 124M, global ids
   [8, 1024], through fleet.init -> fleet.distributed_engine: the
   replicated f32 reduce (at world 1 the single-GPU engine's steps bit for
   bit), ZeRO (bit for bit up to 2 ranks), the bf16 and int8 payloads with
   and without error feedback and ZeRO's bf16 and int8 (losses within 2e-2
   of the f32 trajectory; the first step's reduced gradient within the
   payload's rounding of the f32 run's, element by element), 12
   tensor-core launches of each flash kernel a step a rank, the byte
   counters against the payload functions, ZeRO's peak memory past one
   rank; step ms, tokens/s per chip, payload bytes, the f32 payload's
   all_reduce time and bus bandwidth.
7b. bench: the port's bench.py counterpart (paddle_tpu_torch.bench.run) in
   this process, bf16 auto_cast: medium (gpt_345m, [8, 1024], 2 + 10 steps in
   3 windows: tokens/s a window, spread, MFU against 989 TFLOP/s, peak
   memory, 24 tensor-core launches a step of each flash kernel, one
   profiled step); base with 4 in-program microbatches against 1 (peak
   memory lower at 4); medium under full and selective recompute (48
   forwards a step with the replay, 24 of each backward kernel; peak memory
   under full below the run without recompute); gpt_1p3b ([4, 2048], head
   dim 128) under full recompute; greedy decode at base (decode tokens/s,
   slot independence). Every loss finite and, but for gpt_1p3b's 3 steps,
   falling.
8. library_ops, the direct-call LayerNorm and LM-loss ops (the JAX
   package's examples/pallas_library_ops.py at full width): each of their
   six kernels against its plain version at GPT-2 124M's shapes (LayerNorm
   [8192, 768] f32 and bf16; LM loss h [8192, 768], W [50304, 768], bf16 h
   with an f32 W and f32, plus vocab 50257, a bf16 W and labels of -100,
   at both dtypes of h, and f32 at gpt_345m's hidden 1024), with kernel,
   plain, bound and library times. The LM-loss routes: bf16 h takes the
   bf16 tensor-core forward and backward (their times include the bf16
   copy of the f32 W, timed beside them); f32 h the 3xTF32 tensor-core
   forward and backward (f32 accuracy; the gradients held also in relative
   Frobenius norm), past H = 768 the FMA backward; the FMA kernels are
   checked and timed beside every tensor-core one as the redesign's
   predecessors. Then the
   composition they exist for: the 124M model's hidden state before ln_f
   through the kernel LayerNorm and the kernel LM loss with the tied
   embedding, in f32 (loss and the gradients of wte and ln_f against the
   model's own route; the 3xTF32 forward and backward) and with the LayerNorm's output
   cast to bf16 (loss, dh and dwte against the plain versions; the bf16
   tensor-core backward). Each kernel of a pass launches once in it.
9. lmloss_compile_probe: the LM-loss forward's stripped variants at the
   probe's defaults, checked and timed, with ptxas's registers and spills.
10. the ``kernels`` line: every ported kernel with the path that launched
   it (the training main path's timed steps and the dp phase's runs on
   rank 0, the f32 steps, scoring, the
   bench's gpt_1p3b run for the d = 128 rows, or a library_ops pass; the flash backward and the LM-loss backward once for
   each dtype, the route in ``kernel_route``), its
   launches there and its numbers from the kernel_vs_plain phases at that
   path's shape and dtype.

Any failure raises (exit code 1). Without a CUDA card, or without the
package beside it, the script exits non-zero before printing a result. The
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core rate
              torch.float32: 67e12,          # FP32 units (no TF32)
              "tf32": 495e12}                # dense TF32 tensor-core rate

F32_TOL = 1e-4          # kernel vs plain, f32: summation order only; also an f32
                        # result of bf16 inputs (flash lse, LM-loss loss and lse),
                        # times max(1, max|ref|): the products are exact in f32
BF16_TOL = 2e-2         # kernel vs plain, bf16: times max|o| (p rounds to bf16
                        # against a running, not final, max)
LOGITS_TOL = 2e-3       # card vs CPU, or kernel vs dense masked path, f32
                        # logits of ~0.5 scale after 12 layers
GRAD_F32_TOL = 1e-4     # backward kernels vs plain, f32: times max(1, max|ref|)
GRAD_F32_FROB_TOL = 5e-6  # ... the f32 gradients of the 3xTF32 kernels and of
                        # their FMA predecessors, besides GRAD_F32_TOL: LM-loss dh
                        # and dW of f32 h, ||got - ref||_F / ||ref||_F; the flash
                        # backward's dq, dk, dv in each (b, h) head (head_rel_frob);
                        # and, besides F32_TOL, the f32 flash forward's o in each
                        # (b, h) head. f32 sums in another order read ~4e-7; a
                        # TF32 product without its error compensation ~2e-4 (LM
                        # loss) or ~4e-4 (flash), and the LM loss's dh passes
                        # GRAD_F32_TOL then
GRAD_BF16_FROB_TOL = 1e-2  # ... bf16, besides BF16_TOL x max|ref|: each (b, h)
                        # head's ||got - ref||_F / ||ref||_F (causal P[0, 0] = 1
                        # makes dV[0] = dO[0], so max|ref| is ~50x a typical
                        # entry, and the max limit alone passes a q or kv tile
                        # dropped far from the diagonal)
DW_F32_TOL = 1e-3       # LM-loss f32 dW from bf16 h vs plain: times max|ref| (dl
                        # rounds to bf16 at the same point in both; at BF16_TOL
                        # the labels' -h spikes set max|ref| and hide the
                        # softmax term of the rows without a label)
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


def device_ms(fn, iters=20):
    """Device time of one call of fn with a cold L2: the median over
    ``iters`` calls of CUDA events recorded around the call, each call after
    a 512 MB device-to-device copy. The copy evicts the 50 MB L2, and at
    ~0.3 ms it outlasts the host's Python time for a call, so the host runs
    ahead of the card and the events see the call's kernels back to back.
    For calls of tens of microseconds, where events around a loop of calls
    would count the host's time between launches and a warm L2."""
    src = torch.empty(128 << 20, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        dst.copy_(src)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def _bound(flops, nbytes, dtype):
    """Least time of the card for ``flops`` operations at the dtype's peak
    and ``nbytes`` moved at the HBM rate: (ms, what bounds it)."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(b, h, sq, sk, d, causal, dtype, products=2, seq_tensors=None,
                    peak=None):
    """Least time of the card for attention work: each input read once, each
    output written once, and ``products`` matrix products over the (q, k)
    pairs these inputs need (the causal half only), at the peak of ``peak``
    (a PEAK_FLOPS key; dtype's by default). ``seq_tensors`` = (tensors of
    length sq, of length sk, f32 rows of length sq) moved; the forward's (q
    and o, k and v, lse) by default."""
    if causal:
        pairs = (sq * (sq + 1) // 2 if sq <= sk
                 else sk * (sk + 1) // 2 + (sq - sk) * sk)
    else:
        pairs = sq * sk
    flops = 2 * products * d * b * h * pairs
    n_q, n_k, n_rows = seq_tensors or (2, 2, 1)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * d * b * h * (n_q * sq + n_k * sk) + 4 * b * h * sq * n_rows
    return _bound(flops, nbytes, dtype if peak is None else peak)


def phase_env():
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.ops.kernels import _build

    card = card_name_and_power_limit()
    print(card, flush=True)
    emit(phase="env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    per_source = _build.build()
    report = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                     if "registers" in ln or "spill" in ln]
              for name in per_source}
    emit(phase="build", seconds=time.perf_counter() - t0, per_source=per_source,
         ptxas=report)
    return per_source


def _f32_tol(ref):
    """Limit of an f32 result of bf16 inputs: F32_TOL x max(1, max|ref|)."""
    return F32_TOL * max(1.0, ref.abs().max().item())


def rel_frob(got, want):
    """||got - want||_F / ||want||_F over the whole tensor."""
    g, w = got.float(), want.float()
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item()


def _frob_or_raise(what, got, want):
    """rel_frob of an f32 LM-loss gradient of f32 h; raises past
    GRAD_F32_FROB_TOL."""
    err = rel_frob(got, want)
    if not err <= GRAD_F32_FROB_TOL:
        raise AssertionError(f"{what}: kernel vs plain relative Frobenius error {err} "
                             f"(tol {GRAD_F32_FROB_TOL})")
    return err


def head_rel_frob(got, want):
    """The largest over the (b, h) heads of [b, s, h, d] tensors of
    ||got - want||_F / ||want||_F over the head's [s, d] slice."""
    g, w = got.float(), want.float()
    err = (g - w).square().sum(dim=(1, 3)).sqrt()
    ref = w.square().sum(dim=(1, 3)).sqrt()
    return (err / ref.clamp_min(1e-30)).max().item()


def phase_kernels_fwd():
    """Flash forward vs its plain version; returns the records by case.

    Each case takes the kernel of its dtype's route (checked for it: bf16
    the bf16 tensor-core kernel, f32 the 3xTF32 one), and the FMA
    predecessor (the private route="fma") is held to the same limits on the
    same inputs. bf16: o at BF16_TOL x max|o|, lse at F32_TOL x max(1,
    max|lse|) (exact bf16 products summed in f32: one dropped kv tile moves
    a row's lse by far more). f32: o and lse at F32_TOL, and o at
    GRAD_F32_FROB_TOL in each (b, h) head's relative Frobenius norm
    (``head_rel_frob``: a TF32 product without its error compensation errs
    by ~4e-4 there). The slice cases are timed: kernel, FMA predecessor and
    SDPA (default dispatch, with the name of its kernel) by ``device_ms``
    (tens of microseconds), the plain version by ``cuda_ms``; the f32
    bound counts three TF32 products each (f32 accuracy), the FP32 units'
    bound beside it."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, b, sq, sk, h, d, causal, dtype, timed)
        ("slice_f32_causal", 8, 1024, 1024, 12, 64, True, f32, True),
        ("slice_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, True),
        ("1p3b_bf16_causal", 4, 2048, 2048, 16, 128, True, bf16, True),
        ("slice_f32_noncausal", 8, 1024, 1024, 12, 64, False, f32, False),
        ("sq128_sk1024_f32_causal", 8, 128, 1024, 12, 64, True, f32, False),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, f32, False),
        ("d128_f32_causal", 8, 1024, 1024, 6, 128, True, f32, False),
        ("ragged1000_f32_causal", 8, 1000, 1000, 12, 64, True, f32, False),
        ("fused_qkv_view_f32_causal", 8, 1024, 1024, 12, 64, True, f32, False),
        ("slice_bf16_noncausal", 8, 1024, 1024, 12, 64, False, bf16, False),
        ("d32_bf16_causal", 8, 1024, 1024, 24, 32, True, bf16, False),
        ("d32_bf16_noncausal", 8, 1024, 1024, 24, 32, False, bf16, False),
        ("d128_bf16_causal", 8, 1024, 1024, 6, 128, True, bf16, False),
        ("d128_bf16_noncausal", 8, 1024, 1024, 6, 128, False, bf16, False),
        ("sq128_sk1024_bf16_causal", 8, 128, 1024, 12, 64, True, bf16, False),
        ("sq128_sk1024_d128_bf16_noncausal", 8, 128, 1024, 6, 128, False, bf16, False),
        ("ragged1000_bf16_causal", 8, 1000, 1000, 12, 64, True, bf16, False),
        ("ragged1000_d32_bf16_noncausal", 8, 1000, 1000, 24, 32, False, bf16, False),
        ("fused_qkv_view_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, False),
    ]
    recs = {}
    for name, b, sq, sk, h, d, causal, dtype, timed in cases:
        if name.startswith("fused_qkv_view"):
            # the model's strided views of one fused [b, s, 3, h, d] projection
            qkv = torch.randn(b, sq, 3, h, d, device="cuda", generator=gen).to(dtype)
            q, k, v = qkv.unbind(dim=2)
        else:
            q = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
            k = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
            v = torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
        scale = 1.0 / math.sqrt(d)
        route = fa.forward_route(dtype, d)
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        if dtype == f32:
            tol_o = tol_lse = F32_TOL
        else:
            tol_o = BF16_TOL * po.float().abs().max().item()
            tol_lse = _f32_tol(plse)
        errs, frob = {}, {}
        for r in (route, "fma"):   # the kernel, then its FMA predecessor
            before = dict(fa.launches_by_route)
            ro, rlse = (fa.flash_attention_with_lse(q, k, v, causal=causal) if r == route
                        else fa._launch(q, k, v, causal, scale, route="fma"))
            torch.cuda.synchronize()
            moved = {x: n - before[x] for x, n in fa.launches_by_route.items()}
            if moved != {x: int(x == r) for x in moved}:
                raise AssertionError(f"flash forward {name} ({r}) took the routes {moved}")
            errs[r] = ((ro.float() - po.float()).abs().max().item(),
                       (rlse - plse).abs().max().item())
            frob[r] = head_rel_frob(ro, po) if dtype == f32 else None
            if not (errs[r][0] <= tol_o and errs[r][1] <= tol_lse
                    and (frob[r] is None or frob[r] <= GRAD_F32_FROB_TOL)):
                raise AssertionError(f"flash kernel ({r}) disagrees with its plain version "
                                     f"on {name}: |do| {errs[r][0]} (tol {tol_o}), "
                                     f"|dlse| {errs[r][1]} (tol {tol_lse}), head relative "
                                     f"Frobenius {frob[r]} (tol {GRAD_F32_FROB_TOL})")
            del ro, rlse
        rec = dict(case=name, shape=[b, sq, sk, h, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                   max_abs_err_o=errs[route][0], max_abs_err_lse=errs[route][1],
                   tol_o=tol_o, tol_lse=tol_lse, fma_max_abs_err_o=errs["fma"][0],
                   fma_max_abs_err_lse=errs["fma"][1])
        if dtype == f32:
            rec.update(rel_frob_o=frob[route], fma_rel_frob_o=frob["fma"],
                       frob_tol=GRAD_F32_FROB_TOL)
        if timed:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype)
            if route == "tf32x3":
                # f32 accuracy on the tensor cores: three TF32 products each
                rec["fp32_bound_ms"] = bound_ms
                bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype, 6,
                                                     peak="tf32")

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                                        is_causal=causal)

            rec.update(
                kernel_ms=device_ms(lambda: fa.flash_attention_with_lse(q, k, v, causal=causal)),
                fma_kernel_ms=device_ms(lambda: fa._launch(q, k, v, causal, scale,
                                                           route="fma")),
                plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                                 iters=3),
                library_ms=device_ms(sdpa), library_kernels=device_profile(sdpa, top=2)[2],
                bound_ms=bound_ms, bound_by=bound_by, timing="device_ms")
            del qt, kt, vt
        emit(phase="kernel_vs_plain", kernel="flash_attention_fwd", **rec)
        recs[name] = rec
        del q, k, v, po, plse
    torch.cuda.empty_cache()
    return recs


def sdpa_yardstick(q, k, v, do, causal):
    """SDPA's forward and backward (dq, dk, dv) on [b, s, h, d] inputs, timed
    by ``device_ms``: under the default dispatch and, for bf16, pinned to the
    flash backend (FA2, the algorithm of the port's backward pair), with the
    name of the backward kernel each one ran (the profiler's largest)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).detach().clone().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = {"default": None}
    if q.dtype == torch.bfloat16:
        backends["flash"] = SDPBackend.FLASH_ATTENTION
    out = {}
    for key, backend in backends.items():
        with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
            with torch.no_grad():
                out[f"{key}_fwd_ms"] = device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
            with torch.enable_grad():
                ot = sdpa(qt, kt, vt, is_causal=causal)

                def bwd():
                    return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

                out[f"{key}_bwd_ms"] = device_ms(bwd)
                out[f"{key}_bwd_kernels"] = device_profile(bwd, top=2)[2]
            del ot
    return out


def phase_kernels_bwd():
    """The FA2 backward's dK/dV and dQ kernels vs their plain version, with
    SDPA's backward (all three gradients at once) as the library yardstick:
    pinned to its flash backend (FA2) for bf16, the default dispatch for f32,
    both by ``device_ms`` (``sdpa_yardstick``, with the name of the kernel
    it ran). bf16 takes the bf16 tensor-core pair, f32 the 3xTF32 pair (each
    checked for its route), and the FMA predecessor (the private
    route="fma") is held to the same limits on the same inputs: bf16
    gradients at BF16_TOL x max|ref| and GRAD_BF16_FROB_TOL, f32 ones at
    GRAD_F32_TOL x max(1, max|ref|) and GRAD_F32_FROB_TOL, the Frobenius
    limits in each (b, h) head (``head_rel_frob``). The f32 rows' bound
    counts three TF32 products each (f32 accuracy), the FP32 units' bound
    beside it. The timed cases time the kernels by ``device_ms``
    (``kernel_ms``, like the yardstick; the FMA predecessor's beside it) and
    by ``cuda_ms`` (a warm loop, ``cuda_ms``). Returns {case: {"dkdv": rec,
    "dq": rec}} for the timed cases."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, b, sq, sk, h, d, causal, dtype, timed)
        ("train_bf16_causal", 8, 1024, 1024, 12, 64, True, bf16, True),
        ("train_f32_causal", 8, 1024, 1024, 12, 64, True, f32, True),
        ("sq512_sk1024_f32_noncausal", 8, 512, 1024, 12, 64, False, f32, True),
        ("d128_bf16_causal", 8, 1024, 1024, 6, 128, True, bf16, True),
        ("1p3b_bf16_causal", 4, 2048, 2048, 16, 128, True, bf16, True),
        ("d32_bf16_causal", 8, 1024, 1024, 24, 32, True, bf16, False),
        ("train_bf16_noncausal", 8, 1024, 1024, 12, 64, False, bf16, False),
        ("ragged200_d32_bf16_causal", 8, 200, 200, 12, 32, True, bf16, False),
        ("sq77_sk300_d128_bf16_noncausal", 8, 77, 300, 6, 128, False, bf16, False),
        ("sq128_sk320_bf16_causal", 8, 128, 320, 12, 64, True, bf16, False),
        ("sq300_sk100_d128_bf16_causal", 8, 300, 100, 6, 128, True, bf16, False),
        ("train_f32_noncausal", 8, 1024, 1024, 12, 64, False, f32, False),
        ("d32_f32_causal", 8, 1024, 1024, 24, 32, True, f32, False),
        ("d128_f32_causal", 8, 1024, 1024, 6, 128, True, f32, False),
        ("ragged200_f32_causal", 8, 200, 200, 12, 64, True, f32, False),
        ("sq128_sk320_f32_causal", 8, 128, 320, 12, 64, True, f32, False),
    ]
    out = {}
    for name, b, sq, sk, h, d, causal, dtype, timed in cases:
        q, do = (torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal)
        delta = fa.attention_delta(o, do)
        args = (q, k, v, do, lse, delta, causal)
        route = fa.backward_route(dtype, d)
        want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args)))
        tol = {g: (GRAD_F32_TOL * max(1.0, w.float().abs().max().item()) if dtype == f32
                   else BF16_TOL * w.float().abs().max().item()) for g, w in want.items()}
        routes = [route] + (["fma"] if route != "fma" else [])
        frob_tol = GRAD_BF16_FROB_TOL if dtype == bf16 else GRAD_F32_FROB_TOL
        err, frob = {}, {}
        for r in routes:
            forced = None if r == route else r
            before = {x: dict(c) for x, c in fa.launches_bwd_by_route.items()}
            dk, dv = fa.flash_attention_bwd_dkdv(*args, route=forced)
            dq = fa.flash_attention_bwd_dq(*args, route=forced)
            torch.cuda.synchronize()
            moved = {x: {n: c[n] - before[x][n] for n in c}
                     for x, c in fa.launches_bwd_by_route.items()}
            if moved[r] != {"dkdv": 1, "dq": 1} or any(
                    n for x, c in moved.items() if x != r for n in c.values()):
                raise AssertionError(f"flash backward {name} ({r}) took the routes {moved}")
            got = {"dq": dq, "dk": dk, "dv": dv}
            err[r] = {g: (got[g].float() - want[g].float()).abs().max().item() for g in got}
            frob[r] = {g: head_rel_frob(got[g], want[g]) for g in got}
            if not all(err[r][g] <= tol[g] and frob[r][g] <= frob_tol for g in got):
                raise AssertionError(f"flash backward kernel ({r}) disagrees with its plain "
                                     f"version on {name}: errors {err[r]} (tol {tol}), "
                                     f"head relative Frobenius {frob[r]} (tol {frob_tol})")
            del dk, dv, dq, got
        if not timed:
            emit(phase="kernel_vs_plain", kernel="flash_attention_bwd (dkdv, dq)", case=name,
                 shape=[b, sq, sk, h, d], causal=causal,
                 dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                 max_abs_err=err[route], tol=tol, rel_frob=frob[route], frob_tol=frob_tol,
                 **({"fma_max_abs_err": err["fma"], "fma_rel_frob": frob["fma"]}
                    if route != "fma" else {}))
            del q, k, v, do, o, lse, delta, want
            continue
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args), iters=3)
        yard = sdpa_yardstick(q, k, v, do, causal)
        if name in ("train_bf16_causal", "train_f32_causal"):
            emit(phase="fa2_yardstick" if dtype == bf16 else "sdpa_yardstick", case=name,
                 shape=[b, sq, sk, h, d], causal=causal,
                 dtype=str(dtype).replace("torch.", ""), timing="device_ms", **yard)
        library_ms = yard.get("flash_bwd_ms", yard["default_bwd_ms"])
        library_kernels = yard.get("flash_bwd_kernels", yard["default_bwd_kernels"])
        rows = {}
        for kernel, fn, grads, products, moved in (
                ("dkdv", fa.flash_attention_bwd_dkdv, ("dk", "dv"),
                 4, (2, 4, 2)),    # q, dO in; k, v in, dk, dv out; lse, delta
                ("dq", fa.flash_attention_bwd_dq, ("dq",),
                 3, (3, 2, 2))):   # q, dO in, dq out; k, v in; lse, delta
            bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype,
                                                 products, moved)
            extra = {}
            if route == "tf32x3":
                # f32 accuracy on the tensor cores: three TF32 products each
                extra["fp32_bound_ms"] = bound_ms
                bound_ms, bound_by = attention_bound(b, h, sq, sk, d, causal, dtype,
                                                     3 * products, moved, peak="tf32")
            rows[kernel] = dict(
                case=name, shape=[b, sq, sk, h, d], causal=causal,
                dtype=str(dtype).replace("torch.", ""), kernel_route=route,
                max_abs_err=max(err[route][g] for g in grads),
                tol=min(tol[g] for g in grads),
                rel_frob=max(frob[route][g] for g in grads), frob_tol=frob_tol,
                kernel_ms=device_ms(lambda: fn(*args)),
                cuda_ms=cuda_ms(lambda: fn(*args)), plain_ms=plain_ms,
                library_ms=library_ms, library_default_ms=yard["default_bwd_ms"],
                library_kernels=library_kernels, bound_ms=bound_ms, bound_by=bound_by,
                timing="device_ms", **extra)
            if route != "fma":
                rows[kernel].update(
                    fma_max_abs_err=max(err["fma"][g] for g in grads),
                    fma_rel_frob=max(frob["fma"][g] for g in grads),
                    fma_kernel_ms=device_ms(lambda: fn(*args, route="fma")))
            emit(phase="kernel_vs_plain", kernel=f"flash_attention_bwd_{kernel}",
                 **rows[kernel], plain="flash_attention_bwd_plain (dq, dk, dv)",
                 library="scaled_dot_product_attention backward (dq, dk, dv), "
                 + ("flash backend" if "flash_bwd_ms" in yard else "default dispatch")
                 + ", device_ms")
        out[name] = rows
        del q, k, v, do, o, lse, delta, want
    torch.cuda.empty_cache()
    return out


def phase_score(model, cpu_model, ids):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cfg = model.config
    _reset_launch_counts()
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize()
    launches, routes = fa.launches, dict(fa.launches_by_route)
    if launches != cfg.num_layers or routes != {"mma": 0, "tf32x3": cfg.num_layers,
                                                 "fma": 0}:
        raise AssertionError(f"scoring forward launched the flash kernel "
                             f"{launches} times ({routes}), expected {cfg.num_layers} "
                             f"on the 3xTF32 kernel (f32)")
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
         launches_by_route=routes, logits_max_abs_err_vs_cpu=err, tol=LOGITS_TOL,
         forward_ms=ms, tokens_per_s=tokens / (ms / 1e3))
    return logits, launches, ms


def device_profile(fn, top=5):
    """Run fn under torch.profiler; returns (traced wall ms, summed CUDA
    kernel ms, the ``top`` kernels with the most time). One stream, so
    kernel times do not overlap. A trace without a single kernel record
    (seen on the H100 in calls of SDPA's backward and of its bf16 forward,
    twice in a row in one run) is taken again, with another call of fn, up
    to four traces in all; a fourth such trace raises."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(4):
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
        if total > 0:
            break
    else:
        raise AssertionError("the profiler recorded no device time in four traces")
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
            "flash_attention_bwd_dkdv": fa.launches_bwd("dkdv"),
            "flash_attention_bwd_dq": fa.launches_bwd("dq")}


def _reset_launch_counts():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    fa.launches = 0
    for r in fa.launches_by_route:
        fa.launches_by_route[r] = 0
    for counts in fa.launches_bwd_by_route.values():
        counts["dkdv"] = counts["dq"] = 0


def _bwd_routes():
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return {r: dict(c) for r, c in fa.launches_bwd_by_route.items()}


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
    the same step in f32 (the 3xTF32 forward and backward pair).
    Returns the launch counts of the timed bf16 steps (the main path's run)
    and of the four f32 steps, each {kernel: n}."""
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

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
        fwd_routes = dict(fa.launches_by_route)
        bwd_routes = _bwd_routes()
        peak = torch.cuda.max_memory_allocated()
        losses += timed
        for name, n in launches.items():
            if n != steps * cfg.num_layers:
                raise AssertionError(f"{steps} train steps launched {name} {n} "
                                     f"times, expected {steps * cfg.num_layers}")
        if fwd_routes != {"mma": steps * cfg.num_layers, "tf32x3": 0, "fma": 0}:
            raise AssertionError(f"the bf16 train steps' flash forwards took {fwd_routes}, "
                                 f"expected all {steps * cfg.num_layers} on the tensor cores")
        n = steps * cfg.num_layers
        if bwd_routes != {"mma": {"dkdv": n, "dq": n}, "tf32x3": {"dkdv": 0, "dq": 0},
                          "fma": {"dkdv": 0, "dq": 0}}:
            raise AssertionError(f"the bf16 train steps' flash backwards took {bwd_routes}, "
                                 f"expected all {n} of each on the tensor cores")
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
         flash_fwd_launches_by_route=fwd_routes, flash_bwd_launches_by_route=bwd_routes,
         max_memory_allocated_bytes=peak)
    emit(phase="profile", what="train_step", batch=list(ids.shape),
         wall_ms_untraced=median_ms, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / median_ms, top_kernels=top)

    # the same step without autocast: every product at f32 accuracy (no
    # TF32 in PyTorch's own; the flash forward and backward pair in 3xTF32)
    _reset_launch_counts()
    f32_losses, f32_ms = _steps(engine, ids, labels, 4)
    f32_launches = _launch_counts()
    f32_fwd_routes, f32_bwd_routes = dict(fa.launches_by_route), _bwd_routes()
    n = 4 * cfg.num_layers
    if f32_fwd_routes != {"mma": 0, "tf32x3": n, "fma": 0} or f32_bwd_routes != {
            "mma": {"dkdv": 0, "dq": 0}, "tf32x3": {"dkdv": n, "dq": n},
            "fma": {"dkdv": 0, "dq": 0}}:
        raise AssertionError(f"the 4 f32 train steps' flash kernels took {f32_fwd_routes} "
                             f"and {f32_bwd_routes}, expected {n} 3xTF32 launches of the "
                             f"forward and of each backward kernel")
    if not all(math.isfinite(x) for x in f32_losses):
        raise AssertionError(f"non-finite f32 training loss: {f32_losses}")
    f32_median = statistics.median(f32_ms[1:])
    wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels), top=10)
    emit(phase="train_f32", model="gpt2-124m", batch=list(ids.shape),
         warmup_steps=1, timed_steps=3, losses=f32_losses, step_ms=f32_ms[1:],
         step_ms_median=f32_median, tokens_per_s=ids.numel() / (f32_median / 1e3),
         launches=f32_launches, flash_fwd_launches_by_route=f32_fwd_routes,
         flash_bwd_launches_by_route=f32_bwd_routes)
    emit(phase="profile", what="train_step_f32", batch=list(ids.shape),
         wall_ms_untraced=f32_median, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / f32_median, top_kernels=top)
    return launches, f32_launches


def phase_train_vs_cpu():
    """One f32 step at full width, 2 layers, [1, 1024]: card (the 3xTF32
    forward and backward pair) vs CPU."""
    from paddle_tpu_torch.models import GPTConfig
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

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
                       _launch_counts(), (dict(fa.launches_by_route), _bwd_routes()))
        del model, engine
    (l_gpu, g_gpu, n_gpu, r_gpu), (l_cpu, g_cpu, n_cpu, _) = out["cuda"], out["cpu"]
    if set(n_gpu.values()) != {cfg.num_layers} or set(n_cpu.values()) != {0}:
        raise AssertionError(f"launches: card {n_gpu}, CPU {n_cpu}")
    n = cfg.num_layers
    if r_gpu != ({"mma": 0, "tf32x3": n, "fma": 0},
                 {"mma": {"dkdv": 0, "dq": 0}, "tf32x3": {"dkdv": n, "dq": n},
                  "fma": {"dkdv": 0, "dq": 0}}):
        raise AssertionError(f"the f32 step's flash kernels took {r_gpu}, expected the "
                             f"3xTF32 forward and pair")
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


DP_STEPS = 3            # steps of each dp run
DP_TIMEOUT_S = 300      # the dp phase's ranks, all runs (~30 s on one card)
DP_LOWP_RTOL = 2e-2     # bf16 / int8 payload losses vs the f32 trajectory: the JAX
                        # package's bar (tests/test_grad_comm.py)
DP_ZERO_RTOL = 1e-5     # ZeRO vs replicated losses past 2 ranks: NCCL may sum the
                        # all_reduce (ring, tree or NVLS) in another order than the
                        # reduce_scatter, so the f32 means differ in the last bits
                        # (~1e-7 relative), and each step's update of ~lr moves the
                        # loss by far less than 1e-5 of it
DP_ZERO_MEM_SHARE = 0.8  # ZeRO's peak below replicated's by this share of the
                         # AdamW state it shards, (1 - 1/N) x 8 x n bytes
DP_GRAD_CHUNK = 1024     # FLAGS_grad_comm_chunk of the dp runs


def _flat_grad(params):
    """The gradients of {name: parameter} as one f32 host vector in sorted
    name order (grad_comm's flat layout)."""
    return torch.cat([params[nm].grad.detach().reshape(-1).float().cpu()
                      for nm in sorted(params)])


def _payload_bounds(g_local, world):
    """Per element, the most a payload's rounding can move the first step's
    reduced mean gradient from the f32 run's, given every rank's own mean
    gradient g_r (this rank's is ``g_local``, [n] f32 on the host): {dtype:
    [n] f32 on the host}, each twice the rounding bound.

    bf16: each g_r rounds to bf16 (8 significant bits: relative error <=
    2^-8) and the backend sums in bf16 (at most N - 1 more roundings of
    partial sums, each <= 2^-8 of sum_r |g_r|), so the mean is off by <=
    2^-8 sum_r |g_r|; the bound is 2^-7 sum_r |g_r|. int8: rank r's element of chunk c is off by
    <= scale_rc / 2 = absmax_rc / 254, the f32 sum adds nothing of that
    order, so the mean is off by <= sum_r absmax_rc / (254 N); the bound is
    sum_r absmax_rc / (127 N). A dropped rank's share or a scale off by a
    factor leaves the bound on most elements."""
    from paddle_tpu_torch.distributed import collective

    n = g_local.numel()
    chunks = -(-n // DP_GRAD_CHUNK)
    a = g_local.abs()
    absmax = torch.nn.functional.pad(a, (0, chunks * DP_GRAD_CHUNK - n)).view(
        chunks, DP_GRAD_CHUNK).amax(1)
    sums = []
    for t in (a, absmax):
        t = t.cuda()
        collective.all_reduce(t)
        sums.append(t.cpu())
        del t
    return {"bf16": sums[0] * 2.0 ** -7,
            "int8": (sums[1] / (127.0 * world)).repeat_interleave(DP_GRAD_CHUNK)[:n]}


def dp_worker(out_dir):
    """One rank of the dp phase (started by the port's spawn): bench.py's step
    at GPT-2 124M through fleet.init -> fleet.distributed_engine on the
    global ids [8, 1024], each run of phase_dp's list; writes its results
    to ``out_dir/rank<r>.json``."""
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import grad_comm as gcm
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    torch.cuda.set_device(int(os.environ["FLAGS_selected_gpus"]))
    cfg = GPTConfig()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, 1024)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    counters = (gcm.BYTES_MOVED, gcm.RS_BYTES, gcm.AG_BYTES)
    out, kept = {"world": world, "rank": rank}, {}
    first = {}  # the first step's reduced mean gradient of a run (host f32)
    zero_scatter = gcm.zero_scatter

    def zero_scatter_spy(*a, **kw):  # ZeRO's reduced slice, before clip and update
        g, part = zero_scatter(*a, **kw)
        if first.get("armed"):
            first["zero_shard"], first["armed"] = g.cpu(), False
        return g, part

    gcm.zero_scatter = zero_scatter_spy

    def check_grad(name, dtype):
        """The first step's reduced gradient of a low-precision run against
        the f32 run's, element by element, within _payload_bounds."""
        if "zero_shard" in first:
            got = first.pop("zero_shard")
            lo = rank * got.numel()
            hi = min(bounds["n"], lo + got.numel())
            got = got[:max(0, hi - lo)]
        else:
            got, lo, hi = first.pop("replicated"), 0, bounds["n"]
        err = (got - kept["f32_grad"][lo:hi]).abs()
        bnd = bounds[dtype][lo:hi]
        ratio = err / bnd
        out[name].update(
            grad_elems=hi - lo, grad_max_abs_err=float(err.max()),
            grad_err_over_bound=float(ratio[bnd > 0].max()) if bool((bnd > 0).any()) else 0.0,
            grad_violations=int((err > bnd).sum()))

    def run(name, engine_of, dtype="f32", ef=False):
        set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef,
                   "grad_comm_chunk": DP_GRAD_CHUNK, "zero_update": False})
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = GPTForPretraining(cfg, seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                    weight_decay=0.01)
        engine = engine_of(model, opt)
        c0 = [c.get() for c in counters]
        _reset_launch_counts()
        losses, step_ms = [], []
        first["armed"] = dtype != "f32"
        with auto_cast(dtype="bfloat16"):
            for i in range(DP_STEPS):
                t0 = time.perf_counter()
                losses.append(engine.step(ids, labels).item())
                step_ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0 and name != "plain" and getattr(engine, "_zero_opt", None) is None:
                    first["replicated"] = _flat_grad(engine.params)
        first["armed"] = False
        launches = {"counts": _launch_counts(), "fwd": dict(fa.launches_by_route),
                    "bwd": _bwd_routes()}
        out[name] = {
            "losses": losses, "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "bytes_per_step": [(c.get() - v) // DP_STEPS for c, v in zip(counters, c0)],
            "launches": launches, "dtype": dtype,
            "zero": getattr(engine, "_zero_opt", None) is not None,
            "n": sum(p.numel() for p in model.parameters())}
        if name in ("plain", "f32", "zero"):
            # on the host: no run's peak counts another's
            kept[name] = {n: p.detach().cpu() for n, p in model.named_parameters()}
        if name == "f32":
            kept["f32_grad"] = first.pop("replicated")
        elif dtype != "f32":
            check_grad(name, dtype)
        first.clear()
        del model, opt, engine

    if world == 1:  # the single-GPU engine, before any process group exists
        from paddle_tpu_torch.distributed import TrainStepEngine
        run("plain", TrainStepEngine)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": world, "mp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    # this rank's own mean gradient at the first step's weights, on its rows
    # (the gradient each run's first step hands to its reduce)
    model = GPTForPretraining(cfg, seed=0)
    with auto_cast(dtype="bfloat16"):
        model(ids.chunk(world)[rank], labels.chunk(world)[rank]).backward()
    g_local = _flat_grad(dict(model.named_parameters()))
    del model
    bounds = _payload_bounds(g_local, world)
    bounds["n"] = g_local.numel()

    def zero_engine(m, o):
        return fleet.distributed_engine(m, o, zero_update=True)

    run("f32", fleet.distributed_engine)
    if world == 1 and not torch.equal(kept["f32_grad"], g_local):
        raise AssertionError("dp world 1: the f32 run's first reduced gradient is not "
                             "the rank's own gradient bit for bit")
    del g_local
    run("zero", zero_engine)
    for dtype in ("bf16", "int8"):
        for ef in (False, True):
            run(f"{dtype}{'_ef' if ef else ''}", fleet.distributed_engine, dtype, ef)
    run("zero_bf16", zero_engine, "bf16")
    run("zero_int8_ef", zero_engine, "int8", True)
    gcm.zero_scatter = zero_scatter
    for a, b in (("plain", "f32"), ("zero", "f32")):
        if a in kept:
            out[f"{a}_vs_{b}_params_equal"] = all(
                torch.equal(kept[a][n], kept[b][n]) for n in kept[b])
            out[f"{a}_vs_{b}_max_abs_param_diff"] = max(
                (kept[a][n] - kept[b][n]).abs().max().item() for n in kept[b])
    # the f32 payload's all_reduce alone, 2 + 5 calls (CUDA events): its bus
    # bandwidth, 2 (N - 1) / N x bytes / time, says which links carry it
    from paddle_tpu_torch.distributed import collective

    payload = torch.ones(out["f32"]["n"] + 1, device=ids.device)
    for _ in range(2):
        collective.all_reduce(payload)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        collective.all_reduce(payload)
    end.record()
    torch.cuda.synchronize()
    ar_ms = start.elapsed_time(end) / 5
    out["all_reduce_f32_payload_ms"] = ar_ms
    out["all_reduce_busbw_gb_s"] = 2 * (world - 1) / world * payload.numel() * 4 / ar_ms / 1e6
    del payload
    out["payload_bytes"] = {d: gcm.payload_bytes(out["f32"]["n"], d, DP_GRAD_CHUNK)
                            for d in ("f32", "bf16", "int8")}
    out["zero_payload_bytes"] = {d: list(gcm.zero_payload_bytes(out["f32"]["n"], world, d,
                                                                DP_GRAD_CHUNK))
                                 for d in ("f32", "bf16", "int8")}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_dp(world=None):
    """Data parallelism on the port, at ``world`` ranks (default: one per
    card), in processes started by the port's ``spawn`` with a deadline of
    their own (DP_TIMEOUT_S). Each rank runs GPT-2 124M at full width on the
    global ids [8, 1024] (its 8/N rows), AdamW(1e-4, weight decay 0.01),
    bf16 auto_cast, DP_STEPS steps a run, through fleet.init ->
    fleet.distributed_engine: the replicated f32 reduce, ZeRO, the bf16
    and int8 payloads with and without error feedback, and ZeRO at bf16 and
    at int8 with error feedback (the all_to_all reduce) (and, at world 1,
    the single-GPU engine first). Checks on every rank: at world 1 the f32
    run is the single-GPU engine's bit for bit (losses and every parameter);
    ZeRO is the replicated run's bit for bit up to 2 ranks and within
    DP_ZERO_RTOL past them; the low-precision losses are finite, fall, and
    stay within DP_LOWP_RTOL of the f32 trajectory, and their first step's
    reduced mean gradient (ZeRO: the rank's slice of it) is the f32 run's
    within the payload's rounding, element by element (_payload_bounds:
    twice the bound for bf16 and for int8's chunk scales, from every rank's
    own gradient); every run launches 12
    tensor-core launches of each flash kernel a step; the byte counters
    equal payload_bytes / zero_payload_bytes for the model's n; past one
    rank ZeRO's peak memory is below the replicated run's by at least
    DP_ZERO_MEM_SHARE x (1 - 1/N) x 8 x n bytes. Emits one line with step
    ms, tokens/s per chip, peaks, payload bytes and the f32 payload's
    all_reduce alone (ms, bus bandwidth) before the checks, and one
    (dp_checks) after them; returns rank 0's flash launches over the runs
    {kernel: n}."""
    import tempfile

    from paddle_tpu_torch.distributed import spawn

    world = world or torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        spawn(dp_worker, args=(d,), nprocs=world, timeout=DP_TIMEOUT_S)
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    wall = time.perf_counter() - t0
    lowp = ["bf16", "bf16_ef", "int8", "int8_ef", "zero_bf16", "zero_int8_ef"]
    runs = ["f32", "zero"] + lowp
    nl = 12
    r0 = ranks[0]
    ms = {name: statistics.median(r0[name]["step_ms"][1:]) for name in runs}
    emit(phase="dp", model="gpt2-124m", world=world, global_batch=[8, 1024],
         rows_per_rank=8 // world, steps=DP_STEPS, wall_s=wall,
         losses={name: r0[name]["losses"] for name in runs + (["plain"] if world == 1
                                                               else [])},
         step_ms_median=ms,
         tokens_per_s_per_chip={name: 8 * 1024 / world / (v / 1e3)
                                for name, v in ms.items()},
         peak_bytes_per_rank={name: [res[name]["peak_bytes"] for res in ranks]
                              for name in runs},
         n_params=r0["f32"]["n"], payload_bytes=r0["payload_bytes"],
         zero_payload_bytes_rs_ag=r0["zero_payload_bytes"],
         first_grad_max_abs_err_vs_f32={name: [res[name]["grad_max_abs_err"] for res in ranks]
                                        for name in lowp},
         first_grad_err_over_bound={name: [res[name]["grad_err_over_bound"] for res in ranks]
                                    for name in lowp},
         all_reduce_f32_payload_ms=[res["all_reduce_f32_payload_ms"] for res in ranks],
         all_reduce_busbw_gb_s=[res["all_reduce_busbw_gb_s"] for res in ranks],
         zero_vs_replicated_max_abs_param_diff=[res["zero_vs_f32_max_abs_param_diff"]
                                                for res in ranks],
         lowp_rtol=DP_LOWP_RTOL, zero_rtol=DP_ZERO_RTOL)
    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dkdv": 0,
                "flash_attention_bwd_dq": 0}
    for res in ranks:
        r, n = res["rank"], res["f32"]["n"]
        f32 = res["f32"]["losses"]
        if world == 1 and not (res["plain"]["losses"] == f32
                               and res["plain_vs_f32_params_equal"]):
            raise AssertionError(f"dp world 1: the replicated f32 steps {f32} are not the "
                                 f"single-GPU engine's {res['plain']['losses']} bit for bit")
        zl = res["zero"]["losses"]
        for name in runs:
            if res[name]["zero"] != name.startswith("zero"):
                raise AssertionError(f"dp rank {r} {name}: ZeRO engaged: {res[name]['zero']}")
        if world <= 2:
            if not (zl == f32 and res["zero_vs_f32_params_equal"]):
                raise AssertionError(f"dp rank {r}: ZeRO {zl} is not the replicated "
                                     f"step {f32} bit for bit")
        elif not np.allclose(zl, f32, rtol=DP_ZERO_RTOL, atol=0):
            raise AssertionError(f"dp rank {r}: ZeRO {zl} vs replicated {f32}")
        for name in runs:
            got = res[name]
            ls = got["losses"]
            if not all(math.isfinite(x) for x in ls) or not ls[-1] < ls[0]:
                raise AssertionError(f"dp rank {r} {name}: losses {ls}")
            if name in lowp:
                if not np.allclose(ls, f32, rtol=DP_LOWP_RTOL):
                    raise AssertionError(f"dp rank {r} {name}: {ls} vs f32 {f32}")
                if got["grad_violations"] or got["grad_elems"] <= 0:
                    raise AssertionError(
                        f"dp rank {r} {name}: {got['grad_violations']} of "
                        f"{got['grad_elems']} elements of the first reduced gradient "
                        f"outside the payload's rounding of the f32 run's (worst "
                        f"{got['grad_err_over_bound']} x the bound)")
            _check_mma_launches(f"dp rank {r} {name}", got["launches"]["fwd"],
                                got["launches"]["bwd"], DP_STEPS * nl, DP_STEPS * nl)
            if r == 0:
                for k in launches:
                    launches[k] += got["launches"]["counts"][k]
            dtype = got["dtype"]
            want = ([sum(res["zero_payload_bytes"][dtype])] + res["zero_payload_bytes"][dtype]
                    if got["zero"] else [res["payload_bytes"][dtype], 0, 0])
            if got["bytes_per_step"] != want:
                raise AssertionError(f"dp rank {r} {name}: bytes a step "
                                     f"{got['bytes_per_step']} (moved, rs, ag), "
                                     f"expected {want} for n = {n}")
        if world > 1:
            saved = res["f32"]["peak_bytes"] - res["zero"]["peak_bytes"]
            need = DP_ZERO_MEM_SHARE * (1 - 1 / world) * 8 * n
            if not saved >= need:
                raise AssertionError(f"dp rank {r}: ZeRO saved {saved} bytes of peak "
                                     f"memory, less than {need}")
    emit(phase="dp_checks", world=world, passed=True, launches_rank0=launches)
    return launches


def _route_counts():
    """The flash kernels' launches by route: (forward, backward pair)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    return dict(fa.launches_by_route), _bwd_routes()


def _check_mma_launches(what, fwd, bwd, n_fwd, n_bwd):
    """Every launch on the bf16 tensor cores: n_fwd forwards and n_bwd of
    each backward kernel, none on another route."""
    want = ({"mma": n_fwd, "tf32x3": 0, "fma": 0},
            {"mma": {"dkdv": n_bwd, "dq": n_bwd}, "tf32x3": {"dkdv": 0, "dq": 0},
             "fma": {"dkdv": 0, "dq": 0}})
    if (fwd, bwd) != want:
        raise AssertionError(f"{what}: the flash kernels took {fwd} and {bwd}, "
                             f"expected {want}")


def _bench_run(what, cfg, batch, seq, steps, warmup, per_step_fwd, per_step_bwd,
               falls=True, **kw):
    """One run of the port's bench (paddle_tpu_torch.bench.run) on the card,
    with the flash kernels' counts set to 0 just before it and read just
    after: every step (warm-up included) launches per_step_fwd forwards and
    per_step_bwd of each backward kernel on the bf16 tensor cores. The loss
    is finite and, where ``falls``, lower after the run than at its first
    step. Emits the bench line with the launches; returns (payload,
    forward launches, backward launches of each kernel)."""
    from paddle_tpu_torch import bench

    gc.collect()
    torch.cuda.empty_cache()
    _reset_launch_counts()
    row = bench.run(cfg, batch, seq, steps, warmup, device="cuda", **kw)
    torch.cuda.synchronize()
    fwd, bwd = _route_counts()
    n = steps + warmup
    _check_mma_launches(what, fwd, bwd, n * per_step_fwd, n * per_step_bwd)
    ex = row["extra"]
    first, final = ex["first_loss"], ex["final_loss"]
    if not (math.isfinite(first) and math.isfinite(final)):
        raise AssertionError(f"{what}: non-finite loss {first}, {final}")
    if falls and not final < first:
        raise AssertionError(f"{what}: the loss did not fall ({first} -> {final})")
    emit(phase="bench", case=what, tokens_per_s=row["value"], **ex,
         launches_per_step={"flash_attention_fwd": per_step_fwd,
                            "flash_attention_bwd_dkdv": per_step_bwd,
                            "flash_attention_bwd_dq": per_step_bwd})
    return row, fwd["mma"], bwd["mma"]["dkdv"]


def phase_bench():
    """The port's bench.py counterpart (``paddle_tpu_torch.bench.run``) in this
    process, on the paths of bench.py's knobs, all under bf16 auto_cast:

    - medium (gpt_345m, [8, 1024]): bench.py's 2 warm-up and 10 timed steps
      in 3 windows; tokens/s a window, spread, MFU, peak memory; 24 launches
      a step of the flash forward and of each backward kernel; then one
      profiled step of the same model after 6 (profile train_step_medium);
    - base ([8, 1024], 1 + 4 steps) with 4 in-program microbatches against
      1: 4 x 12 launches of each kernel a step; the peak memory must be
      lower at K = 4;
    - medium (1 + 3 steps) with full and with selective recompute: 48
      forwards a step (24 and their replay) and 24 of each backward kernel;
      the peak memory under full must be lower than the medium run's
      without recompute (selective's is reported);
    - gpt_1p3b ([4, 2048], head dim 128), full recompute, 1 + 2 steps: 48
      forwards and 24 of each backward kernel a step at d = 128, a finite
      loss, peak memory;
    - decode at base: greedy ``generate`` of 64 tokens after a 128-token
      prompt for 8 rows (a warm-up call, then a timed one: decode tokens/s).
      Slot independence: the rows in reversed slots give the same bf16
      tokens, and rows 0 and 5 alone give the batch's tokens at f32 (at
      bf16 a batch of one takes other GEMM kernels, whose rounding can
      break a tie of the bf16 logits: how many tokens agree is reported).

    Every loss is finite, and falls except in the 3 steps of gpt_1p3b.
    Returns the gpt_1p3b run's launches {kernel: n}."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.models import GPTForPretraining
    from paddle_tpu_torch.tools import bench_gpt_1p3b

    med_cfg, batch, seq, steps, warmup = bench.bench_config("medium")
    nl = med_cfg.num_layers
    medium, _, _ = _bench_run("medium", med_cfg, batch, seq, steps, warmup, nl, nl)
    peak_none = medium["extra"]["max_memory_allocated_bytes"]

    # one profiled medium step (where the time goes)
    gc.collect()
    torch.cuda.empty_cache()
    model, engine = _train_engine(med_cfg, "cuda")
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, med_cfg.vocab_size, (batch, seq)).astype(np.int64)).cuda()
    labels = torch.roll(ids, -1, 1)
    with auto_cast(dtype="bfloat16"):
        _, step_ms = _steps(engine, ids, labels, 6)
        wall, kernel_ms, top = device_profile(lambda: engine.step(ids, labels), top=12)
    untraced = statistics.median(step_ms[3:])
    emit(phase="profile", what="train_step_medium", batch=[batch, seq],
         wall_ms_untraced=untraced, wall_ms_traced=wall, kernel_ms=kernel_ms,
         device_busy_share=kernel_ms / untraced, top_kernels=top)
    del model, engine, ids, labels

    base_cfg = bench.bench_config("base")[0]
    peaks = {}
    for k in (1, 4):
        row, _, _ = _bench_run(f"base_accum{k}", base_cfg, 8, 1024, 4, 1,
                               k * base_cfg.num_layers, k * base_cfg.num_layers,
                               accum=k)
        peaks[k] = row["extra"]["max_memory_allocated_bytes"]
    if not peaks[4] < peaks[1]:
        raise AssertionError(f"peak memory at 4 microbatches {peaks[4]} is not below "
                             f"the plain step's {peaks[1]}")

    for rc in ("full", "selective"):
        row, _, _ = _bench_run(f"medium_recompute_{rc}", med_cfg, batch, seq, 3, 1,
                               2 * nl, nl, recompute=rc)
        peaks[rc] = row["extra"]["max_memory_allocated_bytes"]
    if not peaks["full"] < peak_none:
        raise AssertionError(f"peak memory under full recompute {peaks['full']} is not "
                             f"below the step's without it {peak_none}")

    big, b, seq, steps, warmup, kw = bench_gpt_1p3b.case(4)
    if big.hidden_size // big.num_heads != 128:
        raise AssertionError("gpt_1p3b's head dim is not 128")
    _, n_fwd, n_bwd = _bench_run("gpt_1p3b_recompute_full", big, b, seq, steps, warmup,
                                 2 * big.num_layers, big.num_layers, falls=False, **kw)
    emit(phase="bench_memory", model_medium_none=peak_none,
         medium_recompute_full=peaks["full"], medium_recompute_selective=peaks["selective"],
         base_microbatches_1=peaks[1], base_microbatches_4=peaks[4],
         unit="bytes, torch.cuda.max_memory_allocated")

    # decode: bench.py's greedy generate at base, 8 rows
    gc.collect()
    torch.cuda.empty_cache()
    dm = GPTForPretraining(base_cfg, seed=0).eval()
    prompt = torch.from_numpy(np.random.RandomState(1).randint(
        0, base_cfg.vocab_size, (8, 128)).astype(np.int64)).cuda()

    def greedy(ids):
        return dm.generate(ids, max_new_tokens=64, temperature=0)

    with auto_cast(dtype="bfloat16"):
        greedy(prompt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = greedy(prompt)
        int(out[0, -1])
        decode_s = time.perf_counter() - t0
        flipped = greedy(prompt.flip(0)).flip(0)
        alone = {i: greedy(prompt[i:i + 1])[0] for i in (0, 5)}
    if tuple(out.shape) != (8, 192) or not bool(((out >= 0) & (out < base_cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(out.shape)} or ids out of the vocabulary")
    # slot independence: in the same batch shape every row gives the same
    # tokens in another slot beside other neighbours (bf16, exactly) ...
    if not torch.equal(flipped, out):
        raise AssertionError("bf16 greedy tokens changed with the rows' slots")
    # ... and a row alone gives the batch's tokens at f32; at bf16 a batch of
    # one takes other GEMM kernels, whose rounding can break a tie of the
    # bf16 logits (one ulp is 2^-6 at their ~2.3), so it is reported
    f32_out = greedy(prompt)
    for i in (0, 5):
        if not torch.equal(greedy(prompt[i:i + 1])[0], f32_out[i]):
            raise AssertionError(f"f32: row {i} alone gave other greedy tokens than in "
                                 f"the batch of 8")
    same_prefix = {i: int((a != out[i]).nonzero()[0]) - 128 if bool((a != out[i]).any())
                   else 64 for i, a in alone.items()}
    emit(phase="bench_decode", model="gpt2-124m", amp="bfloat16 O1", batch=8,
         prompt=128, new_tokens=64, seconds=decode_s,
         decode_tokens_per_s=8 * 64 / decode_s, slots_flipped_equal=True,
         f32_rows_alone_equal=[0, 5], bf16_alone_tokens_equal_before_divergence=same_prefix)
    del dm
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_d128": n_fwd, "flash_attention_bwd_dkdv_d128": n_bwd,
            "flash_attention_bwd_dq_d128": n_bwd}


def _close_or_raise(what, got, want, dtype, grad=False, tol=None):
    """max |got - want| and its tolerance: ``tol`` where given, else f32
    F32_TOL (times max(1, max|ref|) for gradients), bf16 BF16_TOL x max|ref|,
    an f32 gradient of bf16 inputs DW_F32_TOL x max|ref|; raises past it."""
    scale = want.float().abs().max().item()
    if tol is None and dtype == torch.float32:
        tol = (GRAD_F32_TOL * max(1.0, scale)) if grad else F32_TOL
    elif tol is None:
        tol = (DW_F32_TOL if grad and got.dtype == torch.float32 else BF16_TOL) * scale
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{what}: kernel vs plain error {err} (tol {tol})")
    return err, tol


def phase_layer_norm_kernels(n=8192, h=768):
    """The three LayerNorm kernels against their plain versions at GPT-2
    124M's final-LayerNorm shape ([8, 1024, 768] as [8192, 768]), f32 and
    bf16; torch's layer_norm (and its autograd backward) is the library
    yardstick. Kernel, plain and library times are device times with a cold
    L2 (``device_ms``); ``wall_ms`` is the CUDA-event time of the wrapper's
    call in a loop, host time and a warm L2 included. Returns {dtype:
    {kernel: record}}."""
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(n, h, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        dy = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
        g = 1 + 0.1 * torch.randn(h, device="cuda", generator=gen)
        b = 0.1 * torch.randn(h, device="cuda", generator=gen)
        oi = ln.layer_norm_fwd(x, g, b, stats=False)
        o, mu, rstd = ln.layer_norm_fwd(x, g, b, stats=True)
        dx, dg, db = ln.layer_norm_bwd(x, g, dy, mu, rstd)
        torch.cuda.synchronize()
        po, pmu, prstd = ln.layer_norm_fwd_plain(x, g, b)
        pdx, pdg, pdb = ln.layer_norm_bwd_plain(x, g, dy, pmu, prstd)
        name = f"layer_norm [{n}, {h}] {str(dtype)[6:]}"
        err_i, tol_o = _close_or_raise(f"{name} inference forward", oi, po, dtype)
        err_o, _ = _close_or_raise(f"{name} training forward", o, po, dtype)
        err_s = max(_close_or_raise(f"{name} mu", mu, pmu, torch.float32)[0],
                    _close_or_raise(f"{name} rstd", rstd, prstd, torch.float32, True)[0])
        err_dx, tol_dx = _close_or_raise(f"{name} dx", dx, pdx, dtype, grad=True)
        err_dgb = max(_close_or_raise(f"{name} {k}", got, ref, torch.float32, True)[0]
                      for k, got, ref in (("dg", dg, pdg), ("db", db, pdb)))

        gx, bx = g.to(dtype), b.to(dtype)       # torch's op takes one dtype
        xl = x.detach().clone().requires_grad_()
        gl, bl = gx.clone().requires_grad_(), bx.clone().requires_grad_()
        ol = torch.nn.functional.layer_norm(xl, (h,), gl, bl, 1e-5)
        with torch.no_grad():
            lib_fwd = device_ms(lambda: torch.nn.functional.layer_norm(x, (h,), gx, bx,
                                                                       1e-5))
        lib_bwd = device_ms(lambda: torch.autograd.grad(ol, (xl, gl, bl), dy,
                                                        retain_graph=True))
        esize = x.element_size()
        io = esize * n * h                          # one [n, h] tensor in x's dtype
        elems = n * h
        rows = {
            "layer_norm_infer": dict(
                fn=lambda: ln.layer_norm_fwd(x, g, b, stats=False), err=err_i, tol=tol_o,
                plain=lambda: ln.layer_norm_fwd_plain(x, g, b), library_ms=lib_fwd,
                flops=7 * elems, nbytes=2 * io + 8 * h),
            "layer_norm_fwd": dict(
                fn=lambda: ln.layer_norm_fwd(x, g, b, stats=True), err=max(err_o, err_s),
                tol=tol_o, plain=lambda: ln.layer_norm_fwd_plain(x, g, b),
                library_ms=lib_fwd, flops=7 * elems, nbytes=2 * io + 8 * h + 8 * n),
            "layer_norm_bwd": dict(
                fn=lambda: ln.layer_norm_bwd(x, g, dy, mu, rstd), err=max(err_dx, err_dgb),
                tol=tol_dx, plain=lambda: ln.layer_norm_bwd_plain(x, g, dy, mu, rstd),
                library_ms=lib_bwd, flops=13 * elems, nbytes=3 * io + 12 * h + 8 * n),
        }
        recs = {}
        for kernel, r in rows.items():
            bound_ms, bound_by = _bound(r["flops"], r["nbytes"], torch.float32)
            recs[kernel] = dict(
                case=f"final_ln_{str(dtype)[6:]}", shape=[n, h], dtype=str(dtype)[6:],
                max_abs_err=r["err"], tol=r["tol"], kernel_ms=device_ms(r["fn"]),
                plain_ms=device_ms(r["plain"]), library_ms=r["library_ms"],
                bound_ms=bound_ms, bound_by=bound_by, wall_ms=cuda_ms(r["fn"], iters=50))
            emit(phase="kernel_vs_plain", kernel=kernel, **recs[kernel],
                 library="torch.nn.functional.layer_norm" + (
                     " autograd backward (dx, dg, db)" if kernel == "layer_norm_bwd" else ""))
        out[dtype] = recs
        del x, dy, oi, o, mu, rstd, dx, dg, db, po, pmu, prstd, pdx, pdg, pdb, xl, ol
    torch.cuda.empty_cache()
    return out


def phase_lm_loss_kernels(ids, vocab=50304, h=768):
    """The three LM-loss kernels against their plain versions at GPT-2 124M's
    LM head: h [8192, 768], W [vocab, 768], labels roll(ids, -1). Timed: bf16
    h with an f32 master W (the on-chip amp configuration; the tensor-core
    forward and backward, their time including W's bf16 copy, with the FMA
    kernels at the same inputs and the copy alone timed beside them) and f32
    (the 3xTF32 forward and backward, with the FMA kernels at the same
    inputs timed beside them), and f32 at gpt_345m's hidden 1024, h [8192,
    1024], W [50304, 1024] (the 3xTF32 forward, which streams the hidden dim
    and takes any H; the FMA backward, the route past H = 768); checked
    only: GPT-2's own vocabulary 50257 (a ragged last vocab tile) in f32 and
    at bf16 h with an f32 and a bf16 W, labels of -100 (their rows' loss is
    the logsumexp), and every label -100 (dh and dW the softmax term alone,
    so that max|ref| scales with it), each at bf16 h and at f32. Each timed
    record carries the launches of its checked call (``check_launches``).
    The forward takes the bf16 tensor cores at bf16
    h, the 3xTF32 kernel at f32; its loss and lse are held at F32_TOL x
    max(1, max|ref|) at bf16 h (exact products summed in f32) and F32_TOL at
    f32. The f32 dh and dW are also held to GRAD_F32_FROB_TOL in relative
    Frobenius norm. Wherever a function takes a tensor-core route, its FMA
    kernel (the predecessor) is checked at the same inputs and limits. The
    library yardstick is cross_entropy(linear(h, W).float()) and its
    autograd backward (dh and dW together), timed like the plain version in
    true f32 (no TF32). The f32 rows' bounds count three TF32 products each
    (f32 accuracy), the FP32 units' bound beside them. Returns {case:
    {kernel: record}}."""
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    gen = torch.Generator(device="cuda").manual_seed(5)
    labels = torch.roll(ids, -1, 1).reshape(-1).to(torch.int32)
    n = labels.numel()
    w32 = torch.randn(vocab, h, device="cuda", generator=gen) * 0.02
    h32 = torch.randn(n, h, device="cuda", generator=gen)
    g = torch.ones(n, device="cuda")
    minus100 = labels.clone()
    minus100[::97] = -100
    all_minus100 = torch.full_like(labels, -100)
    w50257 = w32[:50257].contiguous()
    w1024 = torch.randn(vocab, 1024, device="cuda", generator=gen) * 0.02
    h1024 = torch.randn(n, 1024, device="cuda", generator=gen)
    cases = [  # (name, h, W, labels, timed)
        ("bf16_h_f32_w", h32.bfloat16(), w32, labels, True),
        ("f32", h32, w32, labels, True),
        ("vocab50257_f32", h32, w50257, labels % 50257, False),
        ("label_minus100_f32", h32, w32, minus100, False),
        ("all_minus100_f32", h32, w32, all_minus100, False),
        ("vocab50257_bf16_h_f32_w", h32.bfloat16(), w50257, labels % 50257, False),
        ("label_minus100_bf16_h_f32_w", h32.bfloat16(), w32, minus100, False),
        ("all_minus100_bf16_h_f32_w", h32.bfloat16(), w32, all_minus100, False),
        ("vocab50257_bf16_h_bf16_w", h32.bfloat16(), w50257.bfloat16(), labels % 50257,
         False),
        ("h1024_f32", h1024, w1024, labels, True),
    ]
    out = {}
    for name, hh, w, lab, timed in cases:
        dt = hh.dtype
        f32 = dt == torch.float32
        hid = hh.shape[1]
        route = lm.backward_plan(dt, hid).route
        fwd_route = lm.forward_route(dt)
        before = {k: dict(c) for k, c in lm.launches_by_route.items()}
        loss, lse = lm.lm_loss_fwd(hh, w, lab)
        dh = lm.lm_loss_dh(hh, w, lab, lse, g)
        dw = lm.lm_loss_dw(hh, w, lab, lse, g)
        torch.cuda.synchronize()
        moved = {r: {k: c[k] - before[r][k] for k in c}
                 for r, c in lm.launches_by_route.items()}
        want_moved = {r: {"fwd": int(r == fwd_route), "dh": int(r == route),
                          "dw": int(r == route)} for r in moved}
        if moved != want_moved:
            raise AssertionError(f"lm_loss {name}: took the routes {moved}, expected the "
                                 f"forward on {fwd_route} and the backward on {route}")
        ploss, plse = lm.lm_loss_fwd_plain(hh, w, lab)
        pdh, pdw = lm.lm_loss_bwd_plain(hh, w, lab, plse, g)
        if dw.shape != w.shape or dw.dtype != w.dtype or dh.dtype != dt:
            raise AssertionError(f"lm_loss {name}: dh {dh.dtype}, dw {tuple(dw.shape)} "
                                 f"{dw.dtype}")
        # loss and lse: f32 results of exact products (bf16 h) or f32 ones
        tol_f = _f32_tol(plse) if dt == torch.bfloat16 else F32_TOL

        def fwd_err(what, got):
            return max(_close_or_raise(f"lm_loss {name} {what} loss", got[0], ploss, dt,
                                       tol=tol_f)[0],
                       _close_or_raise(f"lm_loss {name} {what} lse", got[1], plse, dt,
                                       tol=tol_f)[0])

        def grad_err(what, got, ref):
            """max error and its limit, and at f32 the relative Frobenius
            error (GRAD_F32_FROB_TOL), of one gradient"""
            err, tol = _close_or_raise(f"lm_loss {name} {what}", got, ref, dt, grad=True)
            frob = _frob_or_raise(f"lm_loss {name} {what}", got, ref) if f32 else None
            return err, tol, frob

        err_f = fwd_err(fwd_route, (loss, lse))
        err_dh, tol_dh, frob_dh = grad_err("dh", dh, pdh)
        err_dw, tol_dw, frob_dw = grad_err("dw", dw, pdw)
        fma, fma_err, fma_frob = {}, {}, {}
        # the FMA kernels at the same inputs: the tensor-core kernels'
        # predecessors, held to the same limits
        if fwd_route != "fma":
            fma["lm_loss_fwd"] = lambda: lm.lm_loss_fwd(hh, w, lab, route="fma")
            fma_err["lm_loss_fwd"] = fwd_err("fma", fma["lm_loss_fwd"]())
        if route != "fma":
            fma["lm_loss_dh"] = lambda: lm._bwd_launch(hh, w, lab, lse, g, False, route="fma")
            fma["lm_loss_dw"] = lambda: lm._bwd_launch(hh, w, lab, lse, g, True, route="fma")
            for k, ref in (("lm_loss_dh", pdh), ("lm_loss_dw", pdw)):
                fma_err[k], _, fma_frob[k] = grad_err(f"{k} fma", fma[k](), ref)
        if "minus100" in name:
            ignored = lab == -100
            if not torch.equal(loss[ignored], lse[ignored]):
                raise AssertionError("a -100 label picked a logit")
        recs = {}
        if timed:
            # the plain version and the yardstick are true f32 products
            if (torch.backends.cuda.matmul.allow_tf32
                    or torch.get_float32_matmul_precision() != "highest"):
                raise AssertionError("f32 matmuls may take TF32: the plain version and the "
                                     "library yardstick must run in true f32")
            v, h = w.shape
            hl = hh.detach().clone().requires_grad_()
            wl = w.detach().clone().requires_grad_()
            labl = lab.long()

            def library_fwd():
                return torch.nn.functional.cross_entropy(
                    torch.nn.functional.linear(hl, wl.to(dt)).float(), labl,
                    reduction="none")

            lib_loss = library_fwd()
            with torch.no_grad():
                lib_fwd_ms = cuda_ms(library_fwd, iters=5)
            lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_loss, (hl, wl), g,
                                                             retain_graph=True), iters=5)
            plain_bwd_ms = cuda_ms(lambda: lm.lm_loss_bwd_plain(hh, w, lab, plse, g),
                                   iters=3)
            hb, wb = hh.element_size() * n * h, w.element_size() * v * h
            rows = {
                "lm_loss_fwd": (lambda: lm.lm_loss_fwd(hh, w, lab), err_f, tol_f, None,
                                cuda_ms(lambda: lm.lm_loss_fwd_plain(hh, w, lab), iters=3),
                                lib_fwd_ms, 2, hb + wb + 12 * n),
                "lm_loss_dh": (lambda: lm.lm_loss_dh(hh, w, lab, lse, g), err_dh, tol_dh,
                               frob_dh, plain_bwd_ms, lib_bwd_ms, 4, 2 * hb + wb + 12 * n),
                "lm_loss_dw": (lambda: lm.lm_loss_dw(hh, w, lab, lse, g), err_dw, tol_dw,
                               frob_dw, plain_bwd_ms, lib_bwd_ms, 4,
                               hb + wb + 4 * v * h + 12 * n),
            }
            extra = {"lm_loss_fwd": {"kernel_route": fwd_route},
                     "lm_loss_dh": {"kernel_route": route},
                     "lm_loss_dw": {"kernel_route": route}}
            if fma:
                # the FMA kernels timed beside the tensor-core ones, and the W
                # cast that the bf16 tensor-core calls include
                cast_ms = (cuda_ms(lambda: w.to(torch.bfloat16), iters=20)
                           if fwd_route == "mma" and w.dtype != torch.bfloat16 else 0.0)
                for kernel, fn in fma.items():
                    extra[kernel].update(
                        w_cast_ms=cast_ms, fma_max_abs_err=fma_err[kernel],
                        fma_kernel_ms=cuda_ms(fn, iters=3, warmup=1),
                        **({"fma_rel_frob": fma_frob[kernel]} if kernel in fma_frob
                           else {}))
            for kernel, (fn, err, tol, frob, plain_ms, lib_ms, products,
                         nbytes) in rows.items():
                flops = products * n * v * h
                bound_ms, bound_by = _bound(flops, nbytes, dt)
                if extra[kernel]["kernel_route"] == "tf32x3":
                    # f32 accuracy on the tensor cores: three TF32 products
                    extra[kernel]["fp32_bound_ms"] = bound_ms
                    bound_ms, bound_by = _bound(3 * flops, nbytes, "tf32")
                if frob is not None:
                    extra[kernel].update(rel_frob=frob, frob_tol=GRAD_F32_FROB_TOL)
                kernel_ms = cuda_ms(fn, iters=5, warmup=1)
                recs[kernel] = dict(
                    case=name, shape=[n, v, h], dtype=f"h {str(dt)[6:]}, W {str(w.dtype)[6:]}",
                    max_abs_err=err, tol=tol, kernel_ms=kernel_ms,
                    plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                    bound_by=bound_by, tflops=flops / kernel_ms / 1e9,
                    check_launches=sum(moved[r][kernel[len("lm_loss_"):]] for r in moved),
                    **extra[kernel])
                emit(phase="kernel_vs_plain", kernel=kernel, **recs[kernel],
                     plain="lm_loss_bwd_plain (dh, dw)" if kernel != "lm_loss_fwd"
                     else "lm_loss_fwd_plain",
                     library="cross_entropy(linear(h, W).float())" + (
                         " autograd backward (dh, dW)" if kernel != "lm_loss_fwd" else ""))
            del hl, wl, lib_loss
        else:
            emit(phase="kernel_vs_plain", kernel="lm_loss (fwd, dh, dw)", case=name,
                 shape=[n, w.shape[0], hid], routes=[fwd_route, route],
                 max_abs_err=[err_f, err_dh, err_dw], tol=[tol_f, tol_dh, tol_dw],
                 rel_frob=[frob_dh, frob_dw] if f32 else None,
                 fma_max_abs_err={k: fma_err[k] for k in fma} if fma else None,
                 fma_rel_frob={k: fma_frob[k] for k in fma_frob} if f32 and fma_frob
                 else None)
        out[name] = recs
        del loss, lse, dh, dw, ploss, plse, pdh, pdw
        torch.cuda.empty_cache()
    return out


def _library_counts():
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    by_route = lm.launches_by_route
    return {"layer_norm_fwd": ln.launches_fwd, "layer_norm_infer": ln.launches_infer,
            "layer_norm_bwd": ln.launches_bwd, "lm_loss_fwd": lm.launches_fwd,
            "lm_loss_dh": lm.launches_dh, "lm_loss_dw": lm.launches_dw,
            **{f"lm_loss_{k}_{r}": by_route[r][k] for r in ("mma", "tf32x3", "fma")
               for k in ("fwd", "dh", "dw")}}


def _reset_library_counts():
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    ln.launches_fwd = ln.launches_infer = ln.launches_bwd = 0
    lm.launches_fwd = lm.launches_dh = lm.launches_dw = 0
    for counts in lm.launches_by_route.values():
        counts["fwd"] = counts["dh"] = counts["dw"] = 0


def phase_library_ops(ids):
    """The composition the library ops exist for, at GPT-2 124M width and
    depth, twice. In f32: the hidden state before ln_f through the kernel
    LayerNorm (no_grad: the inference forward, held against the model's
    ln_f; then with grad), the tied LM head and loss through the kernel LM
    loss, mean over rows; loss and the gradients of wte, ln_f.weight and
    ln_f.bias against the model's own route (plain LayerNorm, chunked fused
    loss); the LM loss's forward and backward on the 3xTF32 tensor-core
    kernels, none on the FMA ones. Then with the kernel
    LayerNorm's output cast to bf16 against the f32 tied wte (the bf16
    tensor-core forward and backward): loss, dh and dwte against the plain
    versions on the card at the same dtypes. Returns the launch counts of
    each pass ({"f32": ..., "bf16": ...})."""
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
    from paddle_tpu_torch.ops.kernels import layer_norm as ln
    from paddle_tpu_torch.ops.kernels import lm_loss as lm

    model = GPTForPretraining(GPTConfig(), seed=0)
    labels = torch.roll(ids, -1, 1)
    gpt = model.gpt
    params = {"gpt.wte.weight": gpt.wte.weight, "gpt.ln_f.weight": gpt.ln_f.weight,
              "gpt.ln_f.bias": gpt.ln_f.bias}

    def hidden_before_ln_f():
        x = gpt.wte(ids) + gpt.wpe(torch.arange(ids.shape[1], device=ids.device))
        for blk in gpt.blocks:
            x = blk(x)
        return x

    t0 = time.perf_counter()
    _reset_library_counts()
    x = hidden_before_ln_f()
    with torch.no_grad():
        h_inf = ln.layer_norm(x, gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon)
        h_ref = gpt.ln_f(x)
    hidden = ln.layer_norm(x, gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon)
    loss = lm.lm_head_cross_entropy(hidden.reshape(-1, hidden.shape[-1]),
                                    gpt.wte.weight, labels.reshape(-1)).mean()
    loss.backward()
    torch.cuda.synchronize()
    launches = _library_counts()
    pass_s = time.perf_counter() - t0
    want = {k: 0 if k.endswith(("_mma", "_fma")) else 1 for k in launches}
    if launches != want:
        raise AssertionError(f"the f32 library_ops pass launched {launches}, expected {want}")
    ln_err = (h_inf - h_ref).abs().max().item()
    if not ln_err <= F32_TOL * max(1.0, h_ref.abs().max().item()):
        raise AssertionError(f"kernel LayerNorm vs ln_f: {ln_err}")
    grads = {k: p.grad.clone() for k, p in params.items()}
    kernel_loss = loss.item()
    del x, h_inf, h_ref, hidden, loss

    model.zero_grad(set_to_none=True)
    ref = model(ids, labels)
    ref.backward()
    ref_loss = ref.item()
    loss_err = abs(kernel_loss - ref_loss) / abs(ref_loss)
    if not loss_err <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"library ops loss {kernel_loss} vs the model's {ref_loss}")
    worst = {}
    for k, p in params.items():
        scale = p.grad.abs().max().item()
        err = (grads[k] - p.grad).abs().max().item()
        worst[k] = err / scale
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"library ops gradient of {k}: {err} (max|g| {scale})")
    emit(phase="library_ops", model="gpt2-124m", batch=list(ids.shape), dtype="float32",
         loss_kernels=kernel_loss, loss_model=ref_loss, loss_rel_err=loss_err,
         loss_rtol=TRAIN_LOSS_RTOL, grad_rel_err=worst, grad_tol=TRAIN_GRAD_TOL,
         ln_inference_vs_ln_f_max_abs_err=ln_err, launches=launches, pass_s=pass_s)
    del grads, ref

    # bf16 h against the f32 master wte: the tensor-core route
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        x = hidden_before_ln_f()
    lab = labels.reshape(-1)
    t0 = time.perf_counter()
    _reset_library_counts()
    hidden = ln.layer_norm(x, gpt.ln_f.weight, gpt.ln_f.bias, gpt.ln_f.epsilon)
    hb = hidden.reshape(-1, hidden.shape[-1]).to(torch.bfloat16)
    hb.retain_grad()
    rows = lm.lm_head_cross_entropy(hb, gpt.wte.weight, lab)
    loss = rows.mean()
    loss.backward()
    torch.cuda.synchronize()
    bf16_launches = _library_counts()
    bf16_pass_s = time.perf_counter() - t0
    want = {k: 0 if k.endswith(("_fma", "_tf32x3")) or k == "layer_norm_infer" else 1
            for k in bf16_launches}
    if bf16_launches != want:
        raise AssertionError(f"the bf16 library_ops pass launched {bf16_launches}, "
                             f"expected {want}")
    wte = gpt.wte.weight.detach()
    hbd = hb.detach()
    ploss, plse = lm.lm_loss_fwd_plain(hbd, wte, lab)
    g = torch.full_like(plse, 1.0 / plse.numel())
    pdh, pdw = lm.lm_loss_bwd_plain(hbd, wte, lab, plse, g)
    bf16 = torch.bfloat16
    errs = {"loss": _close_or_raise("bf16 library_ops loss", rows, ploss, bf16,
                                    tol=_f32_tol(ploss)),
            "dh": _close_or_raise("bf16 library_ops dh", hb.grad, pdh, bf16, grad=True),
            "dwte": _close_or_raise("bf16 library_ops dwte", gpt.wte.weight.grad, pdw, bf16,
                                    grad=True)}
    if hb.grad.dtype != bf16 or gpt.wte.weight.grad.dtype != torch.float32:
        raise AssertionError(f"dh {hb.grad.dtype}, dwte {gpt.wte.weight.grad.dtype}")
    emit(phase="library_ops", model="gpt2-124m", batch=list(ids.shape),
         dtype="h bfloat16 (ln_f output cast), wte float32", loss_kernels=loss.item(),
         loss_plain=ploss.mean().item(), max_abs_err={k: e for k, (e, _) in errs.items()},
         tol={k: t for k, (_, t) in errs.items()}, launches=bf16_launches,
         pass_s=bf16_pass_s)
    del model, x, hidden, hb, rows, loss, ploss, plse, pdh, pdw
    torch.cuda.empty_cache()
    return {"f32": launches, "bf16": bf16_launches}


def phase_probe(build_seconds):
    """The LM-loss compile probe's port at its defaults (rows 4096, vocab
    8192, hidden 768, bf16): each forward variant checked and timed."""
    from paddle_tpu_torch.tools import lmloss_compile_probe as probe

    return probe.run(build_seconds=build_seconds,
                     emit=lambda rec: emit(phase="lmloss_compile_probe", **rec))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.models import GPTConfig, GPTForPretraining

    # f32 parity on the card: no TF32 in PyTorch's own products (the plain
    # versions and the library yardsticks are true f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    per_source = phase_env()
    fwd = phase_kernels_fwd()
    bwd = phase_kernels_bwd()

    cfg = GPTConfig()      # GPT-2 124M at full width and depth
    model = GPTForPretraining(cfg, seed=0)
    cpu_model = GPTForPretraining(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen).cuda()
    logits, score_launches, forward_ms = phase_score(model, cpu_model, ids)
    del cpu_model
    phase_serve(model, ids, logits)
    del logits
    phase_profile(model, ids, forward_ms)
    del model
    torch.cuda.empty_cache()

    launches, f32_launches = phase_train(ids)
    torch.cuda.empty_cache()
    phase_train_vs_cpu()
    torch.cuda.empty_cache()
    dp_launches = phase_dp()
    bench_launches = phase_bench()

    ln_recs = phase_layer_norm_kernels()
    lm_recs = phase_lm_loss_kernels(ids)
    library_launches = phase_library_ops(ids)
    phase_probe(per_source["lm_loss"] or None)

    # the training main path runs attention in bf16 at [8, 1024, 12, 64] (the
    # tensor-core forward and backward pair; the bench's gpt_1p3b run at [4,
    # 2048, 16, 128], its rows "_d128"), the f32 steps and scoring in
    # f32 (the 3xTF32 forward, and in the steps the 3xTF32 backward pair);
    # the library ops are reported at the composition's shapes:
    # LayerNorm in f32 (black-listed under O1), the LM loss with bf16 h and
    # an f32 master W (the bf16 tensor-core kernels) and in f32 (the 3xTF32
    # tensor-core forward and backward)
    pallas = "paddle_tpu/ops/pallas/"
    rows = [  # (name, path, record, source, replaces)
        ("flash_attention_fwd", "train, dp", fwd["slice_bf16_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_fwd_f32", "score, train_f32", fwd["slice_f32_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_bwd_dkdv", "train, dp", bwd["train_bf16_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq", "train, dp", bwd["train_bf16_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("flash_attention_bwd_dkdv_f32", "train_f32", bwd["train_f32_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq_f32", "train_f32", bwd["train_f32_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("flash_attention_fwd_d128", "bench gpt_1p3b", fwd["1p3b_bf16_causal"],
         "flash_attention_fwd.cu", pallas + "flash_attention.py:114"),
        ("flash_attention_bwd_dkdv_d128", "bench gpt_1p3b", bwd["1p3b_bf16_causal"]["dkdv"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:242"),
        ("flash_attention_bwd_dq_d128", "bench gpt_1p3b", bwd["1p3b_bf16_causal"]["dq"],
         "flash_attention_bwd.cu", pallas + "flash_attention.py:268"),
        ("layer_norm_fwd", "library_ops", ln_recs[torch.float32]["layer_norm_fwd"],
         "layer_norm.cu", pallas + "layer_norm.py:92"),
        ("layer_norm_infer", "library_ops", ln_recs[torch.float32]["layer_norm_infer"],
         "layer_norm.cu", pallas + "layer_norm.py:119"),
        ("layer_norm_bwd", "library_ops", ln_recs[torch.float32]["layer_norm_bwd"],
         "layer_norm.cu", pallas + "layer_norm.py:137"),
        ("lm_loss_fwd", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_fwd"],
         "lm_loss.cu", pallas + "lm_loss.py:162"),
        ("lm_loss_dh", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw", "library_ops", lm_recs["bf16_h_f32_w"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
        ("lm_loss_fwd_f32", "library_ops", lm_recs["f32"]["lm_loss_fwd"],
         "lm_loss.cu", pallas + "lm_loss.py:162"),
        ("lm_loss_dh_f32", "library_ops", lm_recs["f32"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw_f32", "library_ops", lm_recs["f32"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
        ("lm_loss_dh_f32_h1024", "lm_loss_kernels h1024_f32", lm_recs["h1024_f32"]["lm_loss_dh"],
         "lm_loss.cu", pallas + "lm_loss.py:261"),
        ("lm_loss_dw_f32_h1024", "lm_loss_kernels h1024_f32", lm_recs["h1024_f32"]["lm_loss_dw"],
         "lm_loss.cu", pallas + "lm_loss.py:279"),
    ]
    # LayerNorm from the f32 pass; the LM loss's bf16 tensor-core forward
    # and backward from the bf16 pass, its f32-h forward and backward
    # (3xTF32) from the f32 pass
    lib_f32, lib_bf16 = library_launches["f32"], library_launches["bf16"]
    counts = {**{k: launches[k] + dp_launches[k] for k in launches}, **bench_launches,
              "flash_attention_fwd_f32": score_launches
              + f32_launches["flash_attention_fwd"],
              "flash_attention_bwd_dkdv_f32": f32_launches["flash_attention_bwd_dkdv"],
              "flash_attention_bwd_dq_f32": f32_launches["flash_attention_bwd_dq"],
              **{k: lib_f32[k] for k in ("layer_norm_fwd", "layer_norm_infer",
                                         "layer_norm_bwd")},
              "lm_loss_fwd": lib_bf16["lm_loss_fwd_mma"],
              "lm_loss_fwd_f32": lib_f32["lm_loss_fwd_tf32x3"],
              "lm_loss_dh": lib_bf16["lm_loss_dh_mma"],
              "lm_loss_dw": lib_bf16["lm_loss_dw_mma"],
              "lm_loss_dh_f32": lib_f32["lm_loss_dh_tf32x3"],
              "lm_loss_dw_f32": lib_f32["lm_loss_dw_tf32x3"],
              **{f"{k}_f32_h1024": lm_recs["h1024_f32"][k]["check_launches"]
                 for k in ("lm_loss_dh", "lm_loss_dw")}}
    kernels = []
    for name, path, rec, src, replaces in rows:
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{src}",
            "replaces": replaces,
            "path": path,
            "launches": counts[name],
            "max_abs_err": rec.get("max_abs_err", rec.get("max_abs_err_o")),
            "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            **({"kernel_route": rec["kernel_route"]} if "kernel_route" in rec else {}),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
