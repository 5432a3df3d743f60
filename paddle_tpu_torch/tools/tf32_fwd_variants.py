"""Check and time the two f32 forwards on the TF32 tensor cores (3xTF32): the
LM-loss forward ``lm_fwd_tf32_full`` of ``ops/kernels/csrc/lm_loss.cu`` and
the flash forward ``flash_fwd_tf32_kernel`` of
``ops/kernels/csrc/flash_attention_fwd.cu``, in edited copies of their
sources: what their accuracy rests on, and the designs not kept.

    python -m paddle_tpu_torch.tools.tf32_fwd_variants [variant ...]
    python -m paddle_tpu_torch.tools.tf32_fwd_variants --check

A variant is a list of edits of ``lm_loss.cu``, ``flash_attention_fwd.cu``
or ``mma_sync.cuh`` (``VARIANTS``): the mutants of the 3xTF32 product (one
TF32 pass, two terms) and of its accumulation (the flash forward's O and
the LM-loss forward's S each summed in one tensor-core accumulator across
the kv or hidden loop, not in a fresh one a pass or 32-column slice); the
designs not kept (the LM-loss forward at two CTAs an SM, with one
accumulator and its B fragments split a pair of n8 tiles at a time to fit
128 registers; the flash forward's split Q fragments loaded once and kept
in registers, not reloaded each tile; at d = 128, its S loop unrolled in
full and its P V passes of 16 kv rows, apart and together); and the TF32 split
left out (big = small = x), which gives wrong results by design and times
the split's instructions. Each is built in its own copy of the package under a
temporary directory, all builds at once (``lmloss_bwd_variants.run_variants``);
then each runs in its own process, in the order given and again in
reverse. One JSON line a run and case, with ptxas's registers and spills
of the kernel's instances:

- LM loss at GPT-2 124M's head, h [8192, 768] and W [50304, 768] f32 from
  seed 5, labels from the same generator with every 97th -100: the time
  (CUDA events over 5 calls after one) and the loss's and lse's max error
  against the plain f32 version beside chip_smoke.py's F32_TOL (1e-4);
  then h [1024, 1280], W [300, 1280] x 0.05: those errors, and the
  backward's dh from the kernel's lse against the plain dh from the plain
  lse in relative Frobenius norm beside GRAD_F32_FROB_TOL (5e-6), as the
  card tests hold it;
- flash attention on f32 inputs from seed 1: [8, 1024, 12, 64] causal and
  not (scoring's and the f32 step's shape), d = 32 ([8, 1024, 24, 32]) and
  d = 128 ([8, 1024, 6, 128]) causal, a ragged [8, 1000, 12, 64] causal:
  the device time (CUDA events around each of 20 calls, each after an L2
  flush; the median), o's and lse's max error beside F32_TOL, and o's
  largest (b, h) head relative Frobenius error beside GRAD_F32_FROB_TOL
  (5e-6).

Needs a CUDA card; ``--check`` only verifies, on any machine, that every
edit applies to the sources exactly once.
"""
from __future__ import annotations

import argparse
import sys

from .lmloss_bwd_variants import CSRC, SPLIT_TF32, edited, run_variants

FILES = ("lm_loss.cu", "flash_attention_fwd.cu", "mma_sync.cuh")
LIBRARIES = ("lm_loss", "flash_attention_fwd")

_Q_ONCE_AT = "  const unsigned k_lane = b_lane(lane, LD, 4) * 4;"
_Q_ONCE = """  unsigned qb[KS][1][4], qs[KS][1][4];
  cp_async_wait<1>();  // Q has landed (tile 0 may still be in flight)
  __syncthreads();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned qr[4];
    ldsm_x4(qa + ks * 32, qr);
#pragma unroll
    for (int x = 0; x < 4; ++x) split_tf32(qr[x], qb[ks][0][x], qs[ks][0][x]);
  }
"""
_Q_EACH_TILE = """      ldsm_x4(qa + ks * 32, qr);
#pragma unroll
      for (int x = 0; x < 4; ++x) split_tf32(qr[x], ab[0][x], as[0][x]);
"""
_LM_FRESH = "      float run[2][8][4] = {};   // the slice's products, a fresh accumulator\n"
_LM_ONE_ACC = [("lm_loss.cu", _LM_FRESH,
                "      float (&run)[2][8][4] = acc;   // the slice's products, into S\n"),
               ("lm_loss.cu", "      add_frags(acc, run);\n", "")]
_B_ALL = """#pragma unroll
        for (int np = 0; np < 4; ++np) {
          unsigned b[4];
          ldsm_x4(buf + (b_off + np * 16 * FLD + kk * 8) * 4, b);
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split_tf32(b[x], bb[2 * np + (x >> 1)][x & 1], bs[2 * np + (x >> 1)][x & 1]);
        }
        mma_tf32x3(run, ab, as, bb, bs);
"""
_B_PAIRS = """#pragma unroll
        for (int np = 0; np < 4; ++np) {   // a pair of n8 tiles at a time
          unsigned b[4], bb[2][2], bs[2][2];
          ldsm_x4(buf + (b_off + np * 16 * FLD + kk * 8) * 4, b);
#pragma unroll
          for (int x = 0; x < 4; ++x) split_tf32(b[x], bb[x >> 1][x & 1], bs[x >> 1][x & 1]);
          float d[2][2][4];   // the pair's accumulators (register names only)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) d[mt][j][e] = run[mt][2 * np + j][e];
          mma_tf32x3(d, ab, as, bb, bs);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) run[mt][2 * np + j][e] = d[mt][j][e];
        }
"""
# one accumulator, B split a pair of n8 tiles at a time, two CTAs an SM
_LM_TWO_CTAS = _LM_ONE_ACC + [
    ("lm_loss.cu", _B_ALL, _B_PAIRS),
    ("lm_loss.cu", "        unsigned a[2][4], ab[2][4], as[2][4], bb[8][2], bs[8][2];\n",
     "        unsigned a[2][4], ab[2][4], as[2][4];\n"),
    ("lm_loss.cu", "__global__ void __launch_bounds__(NT, 1) lm_fwd_tf32_full(",
     "__global__ void __launch_bounds__(NT, 2) lm_fwd_tf32_full(")]
_S_UNROLLED = ("flash_attention_fwd.cu", "  constexpr int SU = D <= 64 ? KS : 4;",
               "  constexpr int SU = KS;")
_PV16 = ("flash_attention_fwd.cu", "constexpr int TF32_PV = D <= 64 ? 32 : 8;",
         "constexpr int TF32_PV = D <= 64 ? 32 : 16;")

#: variant -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    # the mutants of the 3xTF32 product
    "one_pass": [("mma_sync.cuh",
                  "  mma_tf32_all(d, a_small, b_big);\n  mma_tf32_all(d, a_big, b_small);\n", "")],
    "two_term": [("mma_sync.cuh", "  mma_tf32_all(d, a_small, b_big);\n", "")],
    # O (flash) and S (LM loss) in one tensor-core accumulator across the kv
    # or hidden loop instead of a fresh one a pass or slice
    "one_accumulator": [("mma_sync.cuh", "      mma_tf32x3(part, ab[kk], as[kk], bb, bs);",
                         "      mma_tf32x3(acc[g], ab[kk], as[kk], bb, bs);"),
                        ("mma_sync.cuh", "    add_frags(acc[g], part);\n", "")] + _LM_ONE_ACC,
    # LM loss: one accumulator, so that two CTAs an SM fit (B split a pair of
    # n8 tiles at a time)
    "two_ctas": _LM_TWO_CTAS,
    # flash: the warp's split Q fragments loaded once and kept in registers
    "q_resident": [("flash_attention_fwd.cu", _Q_ONCE_AT, _Q_ONCE + _Q_ONCE_AT),
                   ("flash_attention_fwd.cu", _Q_EACH_TILE, ""),
                   ("flash_attention_fwd.cu", "      mma_tf32x3(s, ab, as, bb, bs);",
                    "      mma_tf32x3(s, qb[ks], qs[ks], bb, bs);")],
    # flash at d = 128: S's k8 steps unrolled in full, P V in passes of 16
    # kv rows, and both (the kept design unrolls by 4, in passes of 8)
    "s_unrolled": [_S_UNROLLED],
    "pv16": [_PV16],
    "s_unrolled_pv16": [_S_UNROLLED, _PV16],
    # the split's instructions, timed (wrong results by design)
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
from paddle_tpu_torch.ops.kernels import _build
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import lm_loss as lm

F32_TOL, FROB_TOL = 1e-4, 5e-6

def cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters

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

def ptxas(lib, kernel):
    return next((r for k, r in _build.ptxas_report(lib).items() if kernel in k), None)

card = torch.cuda.get_device_name(0)
gen = torch.Generator(device="cuda").manual_seed(5)
n, v, h = 8192, 50304, 768
w = torch.randn(v, h, device="cuda", generator=gen) * 0.02
hh = torch.randn(n, h, device="cuda", generator=gen)
lab = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
lab[::97] = -100
assert lm.forward_route(hh.dtype) == "tf32x3"
loss, lse = lm.lm_loss_fwd(hh, w, lab)
ploss, plse = lm.lm_loss_fwd_plain(hh, w, lab)
rec = {"variant": sys.argv[1], "card": card, "kernel": "lm_fwd_tf32_full", "shape": [n, v, h],
       "ms": cuda_ms(lambda: lm.lm_loss_fwd(hh, w, lab)),
       "loss_max_abs_err": (loss - ploss).abs().max().item(),
       "lse_max_abs_err": (lse - plse).abs().max().item(), "tol": F32_TOL,
       "ptxas": ptxas("lm_loss", "lm_fwd_tf32_full")}
rec["within_limit"] = max(rec["loss_max_abs_err"], rec["lse_max_abs_err"]) <= F32_TOL
print(json.dumps(rec), flush=True)
del w, hh, loss, lse, ploss, plse
torch.cuda.empty_cache()

# a wider hidden and larger logits: the forward's lse feeds the backward's
# dh (the FMA kernel past H = 768), held to FROB_TOL against the plain
# version's from the plain lse
n, v, h = 1024, 300, 1280
hh = torch.randn(n, h, device="cuda", generator=gen)
w = torch.randn(v, h, device="cuda", generator=gen) * 0.05
lab = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
g = torch.rand(n, device="cuda", generator=gen)
loss, lse = lm.lm_loss_fwd(hh, w, lab)
ploss, plse = lm.lm_loss_fwd_plain(hh, w, lab)
dh = lm.lm_loss_dh(hh, w, lab, lse, g)
pdh = lm.lm_loss_bwd_plain(hh, w, lab, plse, g)[0]
rec = {"variant": sys.argv[1], "card": card, "kernel": "lm_fwd_tf32_full", "shape": [n, v, h],
       "loss_max_abs_err": (loss - ploss).abs().max().item(),
       "lse_max_abs_err": (lse - plse).abs().max().item(), "tol": F32_TOL,
       "dh_rel_frob": ((dh - pdh).norm() / pdh.norm()).item(), "frob_tol": FROB_TOL}
rec["within_limit"] = (max(rec["loss_max_abs_err"], rec["lse_max_abs_err"]) <= F32_TOL
                       and rec["dh_rel_frob"] <= FROB_TOL)
print(json.dumps(rec), flush=True)
del w, hh, loss, lse, ploss, plse, dh, pdh
torch.cuda.empty_cache()

gen = torch.Generator(device="cuda").manual_seed(1)
for b, s, hd, d, causal in ((8, 1024, 12, 64, True), (8, 1024, 12, 64, False),
                            (8, 1024, 24, 32, True), (8, 1024, 6, 128, True),
                            (8, 1000, 12, 64, True)):
    q, k, vv = (torch.randn(b, s, hd, d, device="cuda", generator=gen) for _ in range(3))
    assert fa.forward_route(q.dtype, d) == "tf32x3"
    o, lse = fa.flash_attention_with_lse(q, k, vv, causal=causal)
    po, plse = fa.flash_attention_plain(q, k, vv, causal=causal)
    rec = {"variant": sys.argv[1], "card": card, "kernel": "flash_fwd_tf32_kernel",
           "shape": [b, s, s, hd, d], "causal": causal,
           "ms": device_ms(lambda: fa.flash_attention_with_lse(q, k, vv, causal=causal)),
           "o_max_abs_err": (o - po).abs().max().item(),
           "lse_max_abs_err": (lse - plse).abs().max().item(), "tol": F32_TOL,
           "o_head_rel_frob": head_rel_frob(o, po), "frob_tol": FROB_TOL,
           "ptxas": ptxas("flash_attention_fwd", f"flash_fwd_tf32_kernelILi{d}E")}
    rec["within_max_limit"] = max(rec["o_max_abs_err"], rec["lse_max_abs_err"]) <= F32_TOL
    rec["within_frob_limit"] = rec["o_head_rel_frob"] <= FROB_TOL
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
    run_variants(args.variants or list(VARIANTS), VARIANTS, FILES, LIBRARIES, _RUN)
    return 0


if __name__ == "__main__":
    sys.exit(main())
