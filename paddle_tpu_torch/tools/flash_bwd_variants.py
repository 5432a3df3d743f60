"""Check and time the f32 FA2 backward pair (the 3xTF32 kernels
``flash_bwd_dkdv_tf32_kernel`` and ``flash_bwd_dq_tf32_kernel`` of
``ops/kernels/csrc/flash_attention_bwd.cu``) in edited copies of its
sources: what its accuracy rests on.

    python -m paddle_tpu_torch.tools.flash_bwd_variants [variant ...]
    python -m paddle_tpu_torch.tools.flash_bwd_variants --check

A variant is a list of edits of ``flash_attention_bwd.cu`` or
``mma_sync.cuh`` (``VARIANTS``): the three mutants of the 3xTF32 design
(one TF32 pass, two terms, and each of dK, dV and dQ summed in one
tensor-core accumulator over the whole loop instead of a fresh one a pass:
an edit of mma_sync.cuh's tf32_product, which the f32 flash forward shares),
and the TF32 split left out (big = small = x), which gives wrong results
by design and times the split's instructions.
Each is built in its own copy of the package under a temporary directory,
all builds at once (``lmloss_bwd_variants.run_variants``); then each runs
in its own process, in the order given and again in reverse, on f32 inputs
from seed 2: [8, 1024, 12, 64] causal (the f32 training step's shape), d =
128 causal ([8, 1024, 6, 128]) and a ragged [8, 200, 12, 64] causal. One
JSON line a run and shape: dK/dV's and dQ's device time (CUDA events
around each of 20 calls, each after an L2 flush; the median), and each of
dq, dk and dv against the plain f32 version: the max error beside
chip_smoke.py's GRAD_F32_TOL x max(1, max|ref|) and the largest (b, h)
head's relative Frobenius error beside GRAD_F32_FROB_TOL. Needs a CUDA
card; ``--check`` only verifies, on any machine, that every edit applies to
the sources exactly once.
"""
from __future__ import annotations

import argparse
import sys

from .lmloss_bwd_variants import CSRC, SPLIT_TF32, edited, run_variants

FILES = ("flash_attention_bwd.cu", "mma_sync.cuh")

#: variant -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "one_pass": [("mma_sync.cuh",
                  "  mma_tf32_all(d, a_small, b_big);\n  mma_tf32_all(d, a_big, b_small);\n", "")],
    "two_term": [("mma_sync.cuh", "  mma_tf32_all(d, a_small, b_big);\n", "")],
    "one_accumulator": [("mma_sync.cuh", "      mma_tf32x3(part, ab[kk], as[kk], bb, bs);",
                         "      mma_tf32x3(acc[g], ab[kk], as[kk], bb, bs);"),
                        ("mma_sync.cuh", "    add_frags(acc[g], part);\n", "")],
    "no_split": [("mma_sync.cuh", SPLIT_TF32, "  big = x;\n  small = x;")],
}


def check() -> None:
    """Every variant's edits apply to the current sources."""
    sources = {f: (CSRC / f).read_text() for f in FILES}
    for name in VARIANTS:
        edited(name, sources, VARIANTS)


_RUN = r"""
import json, statistics, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
from paddle_tpu_torch.ops.kernels import flash_attention as fa

def device_ms(fn, iters=20):
    src = torch.empty(128 << 20, device="cuda")
    dst = torch.empty_like(src)
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for start, end in ev:
        dst.copy_(src)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)

def head_rel_frob(got, want):
    err = (got - want).square().sum(dim=(1, 3)).sqrt()
    return (err / want.square().sum(dim=(1, 3)).sqrt().clamp_min(1e-30)).max().item()

gen = torch.Generator(device="cuda").manual_seed(2)
for b, s, h, d in ((8, 1024, 12, 64), (8, 1024, 6, 128), (8, 200, 12, 64)):
    q, do, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen) for _ in range(4))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    args = (q, k, v, do, lse, fa.attention_delta(o, do), True)
    assert fa.backward_route(q.dtype, d) == "tf32x3"
    dk, dv = fa.flash_attention_bwd_dkdv(*args)
    got = {"dq": fa.flash_attention_bwd_dq(*args), "dk": dk, "dv": dv}
    want = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(*args)))
    rec = {"variant": sys.argv[1], "card": torch.cuda.get_device_name(0),
           "shape": [b, s, s, h, d], "causal": True,
           "dkdv_ms": device_ms(lambda: fa.flash_attention_bwd_dkdv(*args)),
           "dq_ms": device_ms(lambda: fa.flash_attention_bwd_dq(*args))}
    for g in got:
        rec[g + "_max_abs_err"] = (got[g] - want[g]).abs().max().item()
        rec[g + "_tol"] = 1e-4 * max(1.0, want[g].abs().max().item())
        rec[g + "_head_rel_frob"] = head_rel_frob(got[g], want[g])
    rec["frob_tol"] = 5e-6
    rec["within_max_limit"] = all(rec[g + "_max_abs_err"] <= rec[g + "_tol"] for g in got)
    rec["within_frob_limit"] = all(rec[g + "_head_rel_frob"] <= 5e-6 for g in got)
    print(json.dumps(rec), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--check", action="store_true", help="only check that the edits apply")
    args = ap.parse_args(argv)
    check()
    if args.check:
        return 0
    run_variants(args.variants or list(VARIANTS), VARIANTS, FILES, ("flash_attention_bwd",),
                 _RUN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
