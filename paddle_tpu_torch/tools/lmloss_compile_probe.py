"""Stripped variants of the LM-loss forward kernel, each checked and timed
on the card (counterpart of tools/lmloss_compile_probe.py).

    python -m paddle_tpu_torch.tools.lmloss_compile_probe [--rows 4096]
        [--vocab 8192] [--hidden 768]

The JAX probe times Mosaic's compile of stripped copies of the Pallas
forward, because that compile once ran for minutes. Here the variants are
instantiations of the tensor-core forward kernel of
``ops/kernels/csrc/lm_loss.cu`` (the PICK / MASK template parameters of
``fwd_mma_body``), each its own entry point:

    bare      s = h . W^T and the online logsumexp only   lm_fwd_mma_bare
    picked    + the label's logit                         lm_fwd_mma_picked
    masked    + columns from v_true = vocab - 64 masked   lm_fwd_mma_full
    full      the public lm_head_cross_entropy forward    lm_fwd_mma_full

``masked`` and ``full`` are one instantiation: the public kernel masks by
index at a v_true it is given, which is the vocab itself for ``full``. The
JAX probe's ``sliced`` variant (VMEM lane slices of the scratch) and its
``block_n`` sweep are Mosaic matters with no GPU counterpart, so they are
not here.

Prints one JSON line with the source's nvcc build seconds, then one line per
variant: its run time (CUDA events, mean of 10 after 2 warm-ups), its
largest difference from the matching plain computation and the tolerance,
and ptxas's registers and spills for its instantiation. Inputs are bf16,
random from a seed, labels in [0, vocab - 64). Raises (exit code 1) on a
card-less machine or when a variant disagrees with its plain version.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

import torch

VARIANTS = (  # (variant, kernel entry point, lm_loss_fwd variant, masked at vocab - 64)
    ("bare", "lm_fwd_mma_bare", "bare", False),
    ("picked", "lm_fwd_mma_picked", "picked", False),
    ("masked", "lm_fwd_mma_full", "full", True),
    ("full", "lm_fwd_mma_full", None, False),
)
TOL = 1e-4   # times max(1, max|ref|): bf16 inputs are exact in f32, sums differ in order


def ptxas_report(log: str) -> dict:
    """{entry point name: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` output."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, [None, None, None])[1:] = [int(m.group(1)),
                                                                int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, [None, None, None])[0] = int(m.group(1))
    return out


def _entry(report: dict, name: str):
    """The report of the entry point whose (mangled) name holds ``name``."""
    hits = [v for k, v in report.items() if re.search(rf"\d{name}E", k) or k == name]
    if len(hits) != 1:
        raise RuntimeError(f"ptxas reported {len(hits)} entry points named {name}")
    return hits[0]


def _cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _print(rec):
    print(json.dumps(rec), flush=True)


def run(rows=4096, vocab=8192, hidden=768, build_seconds=None, emit=_print):
    """Check and time every variant, passing each record to ``emit``;
    returns the records. ``build_seconds``: the lm_loss source's nvcc time
    when the caller just built it, else the source is compiled once more
    here to time it."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probe runs the CUDA kernels: it needs a CUDA card")
    from ..ops.kernels import _build
    from ..ops.kernels import lm_loss as lm

    if build_seconds is None:
        build_seconds = _build.build(["lm_loss"], force=True)["lm_loss"]
    emit({"source": "lm_loss.cu", "nvcc_seconds": build_seconds})
    report = ptxas_report(_build.build_log("lm_loss"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    h = torch.randn(rows, hidden, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(vocab, hidden, device="cuda", generator=gen) * 0.05).bfloat16()
    labels = torch.randint(0, vocab - 64, (rows,), device="cuda", generator=gen,
                           dtype=torch.int32)
    recs = []
    for name, entry, variant, masked in VARIANTS:
        v_true = vocab - 64 if masked else None
        if variant is None:
            fn = lambda: lm.lm_head_cross_entropy(h, w, labels)  # noqa: E731
        else:
            fn = lambda variant=variant, v_true=v_true: lm.lm_loss_fwd(  # noqa: E731
                h, w, labels, variant=variant, v_true=v_true)[0]
        with torch.no_grad():
            got = fn()
            torch.cuda.synchronize()
            want = lm.lm_loss_fwd_plain(h, w, labels, v_true, pick=name != "bare")[0]
            err = (got - want).abs().max().item()
            tol = TOL * max(1.0, want.abs().max().item())
            if not err <= tol:
                raise AssertionError(f"probe variant {name} disagrees with its plain "
                                     f"version: {err} (tol {tol})")
            run_ms = _cuda_ms(fn)
        regs, spill_st, spill_ld = _entry(report, entry)
        rec = {"variant": name, "kernel": entry, "rows": rows, "vocab": vocab,
               "hidden": hidden, "dtype": "bfloat16", "v_true": v_true or vocab,
               "run_ms": run_ms, "max_abs_err": err, "tol": tol, "registers": regs,
               "spill_store_bytes": spill_st, "spill_load_bytes": spill_ld}
        emit(rec)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--hidden", type=int, default=768)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    run(args.rows, args.vocab, args.hidden)
    return 0


if __name__ == "__main__":
    sys.exit(main())
