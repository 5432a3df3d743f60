"""Time the LayerNorm backward (``ln_bwd_kernel`` of
``ops/kernels/csrc/layer_norm.cu``) in edited copies of its source: what its
row walk costs alone, what the in-launch sum of dg and db adds, and where
that sum's time goes.

    python -m paddle_tpu_torch.tools.layer_norm_variants [variant ...]
    python -m paddle_tpu_torch.tools.layer_norm_variants --widths 768,2048 base no_tail
    python -m paddle_tpu_torch.tools.layer_norm_variants --check

Variants (``VARIANTS``): ``base`` (the source as it is), ``no_tail`` (the
row walk alone: the column sums kept live but never added across CTAs, the
groups' last rows still stored), ``no_final`` (the clusters' partial rows
and tickets, no final sum), and ``timeline`` (the source with thread 0 of
every CTA reading clock64 at each step of the tail and %globaltimer at the
start, the walk's end and the end, written over dx's first rows). Each is
built in its own copy of the package under a temporary directory, all
builds at once; then each runs in its own process, in the order given and
again in reverse: ``tools.layer_norm_ab`` at [8192, h] (``--no-check`` for
the variants that leave work out), or for ``timeline`` six bf16 backward
calls after the same 512 MB copy as ``chip_smoke.device_ms``, the last four
summarised: a step's median and largest SM cycles over the CTAs, the spread
of the walk's end over the CTAs, and the ns from the last walk's end to
the kernel's end. One JSON line each. Needs a CUDA card; ``--check`` only
verifies, on any machine, that every edit applies to the source once.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .lmloss_bwd_variants import CSRC, edited, run_variants

REPO = Path(__file__).resolve().parents[2]
SRC = "layer_norm.cu"

_TAIL = "  // the CTA's column sums: each group's [dg | db] into its slot, then the\n"
_LAST_DX = ("  if (last_row >= 0) store_dx<T, L, NV>(dx, last_row, h, lane, chunks, cx, cd, gam, "
            "cm, cr, c1, c2);\n")
_KEEP = ("  if (n != -7) {  // the sums stay live; never true\n"
         "    float t = 0.f;\n"
         "    for (int c = 0; c < NV; ++c)\n"
         "      for (int q = 0; q < E; ++q) t += acc_g[c][q] + acc_b[c][q];\n"
         "    if (t == -7.f) dgdb[threadIdx.x] = t;\n"
         "  " + _LAST_DX +
         "    return;\n"
         "  }\n")
_GT = ("[]{ unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
       "return static_cast<long long>(t); }()")
_END = "  cluster_wait();  // no CTA leaves while a peer reads its slot\n}"
# the tail's steps, in order, as the timeline names them
STEPS = ("walk", "cta_sum_and_barrier", "cluster_sum_and_part_row", "arrive", "ticket",
         "last_dx", "final_sum", "wait")

VARIANTS = {
    "base": [],
    "no_tail": [(SRC, _TAIL, _KEEP + _TAIL)],
    "no_final": [(SRC, "  if (last_flag) {\n", "  if (last_flag && n == -7) {\n")],
    "timeline": [
        (SRC, "  float c1 = 0.f, c2 = 0.f;\n",
         "  long long tl[14];\n  tl[0] = clock64();\n  tl[10] = " + _GT + ";\n"
         "  float c1 = 0.f, c2 = 0.f;\n"),
        (SRC, _TAIL, "  tl[1] = clock64();\n  tl[11] = " + _GT + ";\n" + _TAIL),
        (SRC, "  cluster_wait();  // every CTA's sum is in its slot 0\n",
         "  cluster_wait();  // every CTA's sum is in its slot 0\n  tl[2] = clock64();\n"),
        (SRC, "  __syncthreads();   // the CTA's slice written",
         "  tl[3] = clock64();\n  __syncthreads();   // the CTA's slice written"),
        (SRC, "  cluster_arrive_relaxed();\n", "  cluster_arrive_relaxed();\n  tl[4] = clock64();\n"),
        (SRC, "    last_flag = last;\n", "    last_flag = last;\n    tl[5] = clock64();\n"),
        (SRC, _LAST_DX, _LAST_DX + "  tl[6] = clock64();\n"),
        (SRC, _END,
         "  tl[7] = clock64();\n  cluster_wait();\n  tl[8] = clock64();\n  tl[12] = " + _GT + ";\n"
         "  tl[13] = last_flag;\n"
         "  if (threadIdx.x == 0) {\n"
         "    long long* o = reinterpret_cast<long long*>(dx) + blockIdx.x * 16;\n"
         "    for (int i = 0; i < 14; ++i) o[i] = tl[i];\n"
         "  }\n}"),
    ],
}
_LEAVE_OUT = {"no_tail", "no_final", "timeline"}


def check() -> None:
    """Every variant's edits apply to the current source."""
    sources = {SRC: (CSRC / SRC).read_text()}
    for name in VARIANTS:
        edited(name, sources, VARIANTS)


def timeline(widths) -> None:
    """The ``timeline`` variant's run (in its copy): bf16 [8192, h]."""
    import json
    import statistics

    import torch

    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    card = card_name_and_power_limit()
    src = torch.empty(128 << 20, device="cuda")
    dst = torch.empty_like(src)
    for h in widths:
        n = 8192
        gen = torch.Generator(device="cuda").manual_seed(4)
        x = (torch.randn(n, h, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
        dy = torch.randn(n, h, device="cuda", generator=gen).bfloat16()
        g = 1 + 0.1 * torch.randn(h, device="cuda", generator=gen)
        b = 0.1 * torch.randn(h, device="cuda", generator=gen)
        _, mu, rstd = ln.layer_norm_fwd(x, g, b)
        clusters = ln._kernel("layer_norm_bwd_clusters")(n, h, 1)
        grid = clusters * 8
        for call in range(6):
            dst.copy_(src)
            dx = ln.layer_norm_bwd(x, g, dy, mu, rstd)[0]
            torch.cuda.synchronize()
            if call < 2:
                continue
            t = dx.reshape(-1).view(torch.int64)[: grid * 16].view(grid, 16)[:, :14].cpu()
            rec = {"variant": "timeline", "card": card, "shape": [n, h], "dtype": "bfloat16",
                   "ctas": grid, "call": call}
            for k, name in enumerate(STEPS, start=1):
                d = (t[:, k] - t[:, k - 1]).tolist()
                rec[f"{name}_cycles"] = [statistics.median(d), max(d)]
            last = t[:, 13].nonzero().flatten().tolist()
            rec["final_sum_cycles_of_the_last_ctas"] = [int(t[i, 7] - t[i, 6]) for i in last]
            rec["walk_end_spread_ns"] = int(t[:, 11].max() - t[:, 11].min())
            rec["after_the_last_walk_ns"] = int(t[:, 12].max() - t[:, 11].max())
            rec["kernel_ns"] = int(t[:, 12].max() - t[:, 10].min())
            print(json.dumps(rec), flush=True)


_RUN = f"""
import sys
sys.path.append({str(REPO)!r})   # chip_smoke, for layer_norm_ab's timing helpers
name, widths = sys.argv[1], sys.argv[2]
if name == "timeline":
    from paddle_tpu_torch.tools import layer_norm_variants as v
    v.timeline([int(w) for w in widths.split(",")])
else:
    from paddle_tpu_torch.tools import layer_norm_ab
    sys.exit(layer_norm_ab.main(["--label", name, "--widths", widths]
                                + (["--no-check"] if name in {sorted(_LEAVE_OUT)!r} else [])))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*",
                    help=f"of {', '.join(VARIANTS)} (default: base no_tail no_final timeline)")
    ap.add_argument("--check", action="store_true", help="only check that the edits apply")
    ap.add_argument("--widths", default="768", help="hidden sizes, comma-separated")
    args = ap.parse_args(argv)
    check()
    if args.check:
        return 0
    run_variants(args.variants or list(VARIANTS), VARIANTS, (SRC, "mma_sync.cuh"),
                 ("layer_norm",), _RUN, (args.widths,))
    return 0


if __name__ == "__main__":
    sys.exit(main())
