"""Time and check the f32 LM-loss backward (the 3xTF32 kernel
``lm_grad_tf32_kernel`` of ``ops/kernels/csrc/lm_loss.cu``) in edited copies
of its sources: where its time goes, what other designs give, and what its
accuracy rests on.

    python -m paddle_tpu_torch.tools.lmloss_bwd_variants [variant ...]
    python -m paddle_tpu_torch.tools.lmloss_bwd_variants --hidden 1024 base no_exchange
    python -m paddle_tpu_torch.tools.lmloss_bwd_variants --check

A variant is a list of edits of ``lm_loss.cu`` or ``mma_sync.cuh``
(``VARIANTS``): parts of the kernel left out (the loads of later other
tiles, one of the two products, the TF32 split), other designs (a stager
that divides by the row width, the S loop unrolled, a truncating split, two
column pairs at once, S summed over 32 columns, k permuted in the product,
another dl row stride), and the two mutants of the 3xTF32 product (two
terms, one pass), and for the cluster route past the one-CTA tiles the
partial S taken as its S without the cluster barriers and reads
(``no_exchange``) or with the barriers and no reads (``barrier_only``),
its arrive with release semantics in every thread (``release_arrive``),
the reads of the peers' slots issued after the next tile's S
(``late_gather``), its pipelined instances run in order (``in_order``),
and the first two together (``first_design``). Each variant is built in
its own copy of the package under a temporary directory, all builds at
once; then each runs in its own process, in the order given and again in
reverse, at GPT-2 124M's LM head: h [8192, 768] and W [50304, 768] f32 from
seed 5, labels from the same generator, g = 1 (``--hidden`` another H, such
as gpt_345m's 1024, where the backward takes a cluster; ``--dtype
bfloat16``, h in bf16 and W f32: the bf16 tensor-core kernel).
One JSON line a run: dh's and dW's time (CUDA events over 5 calls after
one), and each one's error against the plain f32 version, max and
relative Frobenius. Variants that leave work out give wrong results by
design. Needs a CUDA card; ``--check`` only verifies, on any machine, that
every edit applies to the sources exactly once.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "ops" / "kernels" / "csrc"

_PRODUCT_B = "ot[(ks * 8 + tq + 4 * q) * ld + j * 128 + e * 8]"
_PRODUCT_LOOP = """#pragma unroll
    for (int j = 0; j < HC; ++j) {
      if (active & (1u << j)) {
        float part[2][2][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          unsigned bb[2][2], bs[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int q = 0; q < 2; ++q)
              split_tf32(__float_as_uint(ot[(ks * 8 + tq + 4 * q) * ld + j * 128 + e * 8]),
                         bb[e][q], bs[e][q]);
          mma_tf32x3(part, ab[ks], as[ks], bb, bs);
        }
        add_frags(acc[j], part);
      }
    }
"""
_PAIRS_LOOP = """#pragma unroll
    for (int j0 = 0; j0 < HC; j0 += 2) {
      float part[2][2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = j0 + jj;
          if (active & (1u << j)) {
            unsigned bb[2][2], bs[2][2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                split_tf32(__float_as_uint(ot[(ks * 8 + tq + 4 * q) * ld + j * 128 + e * 8]),
                           bb[e][q], bs[e][q]);
            mma_tf32x3(part[jj], ab[ks], as[ks], bb, bs);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        if (active & (1u << (j0 + jj))) add_frags(acc[j0 + jj], part[jj]);
    }
"""
_LOAD = "    if (q < n) ld_cluster(local, q, v[q]);\n"
_NO_LOAD = "    if (q < n) v[q][0] = 0.f;\n"
_GATHER = ("  const unsigned local = smem_u32(slot);\n"
           "  const int n = static_cast<int>(cluster_nctarank());\n"
           "  for (int r0 = 0; r0 < n; r0 += 4) {\n")
_GATHER_LOCAL = "#pragma unroll\n  for (int i = 0; i < N; ++i) s[i] = slot[i];\n  return;\n" + _GATHER
_FENCE = '  if (threadIdx.x == 0) asm volatile("fence.acq_rel.cluster;\\n" ::: "memory");\n'
_ARRIVE = '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n'
_WAIT = '  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n'


def _early(n):
    return ("      cluster_wait();             // every rank's partial S of tile t is in its slot\n"
            f"      float v[4][{n}];\n"
            "      cluster_load(v, slot(t));   // in flight through the S of tile t + 1\n")


_S_NEXT = "      if (t + 1 < n_t) {\n        s_phase(t + 1);\n        __syncthreads();\n      }\n"
SPLIT_TF32 = ("  big = x + 0x1000u;\n"
          "  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big & 0xffffe000u));")

#: variant -> [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    # parts left out
    "no_load": [("lm_loss.cu", "    if (t + 1 < n_t) {          // the other buffer",
                 "    if (t + 1 < 2) {          // the other buffer")],
    "no_s": [("lm_loss.cu",
              "        mma_tf32x3(part, ab, as, bb, bs);\n      }\n      add_frags(sacc, part);",
              "      }\n      add_frags(sacc, part);")],
    "no_product": [("lm_loss.cu", "          mma_tf32x3(part, ab[ks], as[ks], bb, bs);\n", "")],
    "no_split": [("mma_sync.cuh", SPLIT_TF32, "  big = x;\n  small = x;")],
    # other designs
    "divided_stager": [("lm_loss.cu", """    for (int r = warp; r < R; r += NT / 32) {
      const bool ok = r0 + r < rows;
      const float* row = src + static_cast<long long>(ok ? r0 + r : 0) * p.hdim;
      const unsigned d = smem_u32(dst + r * ld);
      for (int c = lane; c < vecs; c += 32) cp_async16(d + c * 16, row + c * 4, ok ? 16 : 0);
    }""", """    for (int idx = threadIdx.x; idx < R * vecs; idx += NT) {
      const int r = idx / vecs, c = idx - r * vecs;
      const bool ok = r0 + r < rows;
      cp_async16(smem_u32(dst + r * ld + c * 4),
                 src + static_cast<long long>(ok ? r0 + r : 0) * p.hdim + c * 4, ok ? 16 : 0);
    }""")],
    "unroll_s": [("lm_loss.cu", "    for (int k0 = 0; k0 < kw; k0 += 16) {",
                  "#pragma unroll 2\n    for (int k0 = 0; k0 < kw; k0 += 16) {")],
    "trunc_split": [("mma_sync.cuh", SPLIT_TF32,
                     "  big = x;\n  small = __float_as_uint(__uint_as_float(x) - "
                     "__uint_as_float(x & 0xffffe000u));")],
    "column_pairs": [("lm_loss.cu", _PRODUCT_LOOP, _PAIRS_LOOP)],
    "s_groups_32": [("lm_loss.cu", "    for (int k0 = 0; k0 < kw; k0 += 16) {",
                     "    for (int k0 = 0; k0 < kw; k0 += 32) {"),   # H a multiple of 256
                    ("lm_loss.cu", "      for (int k = k0; k < k0 + 16; k += 8) {",
                     "      for (int k = k0; k < k0 + 32; k += 8) {")],
    # k permuted in the product (rows 2tq, 2tq + 1): no bank shared by the B
    # loads, A pairs as float2
    "permuted_k": [("lm_loss.cu", """          split_tf32(__float_as_uint(row[tq]), ab[ks][m][i], as[ks][m][i]);
          split_tf32(__float_as_uint(row[tq + 4]), ab[ks][m][i + 2], as[ks][m][i + 2]);""",
                    """          const float2 x = *reinterpret_cast<const float2*>(row + 2 * tq);
          split_tf32(__float_as_uint(x.x), ab[ks][m][i], as[ks][m][i]);
          split_tf32(__float_as_uint(x.y), ab[ks][m][i + 2], as[ks][m][i + 2]);"""),
                   ("lm_loss.cu", _PRODUCT_B, "ot[(ks * 8 + 2 * tq + q) * ld + j * 128 + e * 8]")],
    # a dl row stride of 24: two lanes to a bank in the scalar A loads
    "dl_stride_24": [("lm_loss.cu", "constexpr int TDLD = OT + 4;", "constexpr int TDLD = OT + 8;")],
    # the mutants of the 3xTF32 product
    "two_term": [("mma_sync.cuh", "  mma_tf32_all(d, a_small, b_big);\n", "")],
    "one_pass": [("mma_sync.cuh",
                  "  mma_tf32_all(d, a_small, b_big);\n  mma_tf32_all(d, a_big, b_small);\n", "")],
    # the cluster route: each CTA's partial S kept as its S (no barrier, no
    # reads of the peers), or the barriers without the reads
    "no_exchange": [("mma_sync.cuh", _LOAD, _NO_LOAD), ("mma_sync.cuh", _GATHER, _GATHER_LOCAL),
                    ("mma_sync.cuh", _FENCE, ""), ("mma_sync.cuh", _ARRIVE, ""),
                    ("mma_sync.cuh", _WAIT, "")],
    "barrier_only": [("mma_sync.cuh", _LOAD, _NO_LOAD),
                     ("mma_sync.cuh", _GATHER, _GATHER_LOCAL)],
    # the pipelined loops' reads of the peers' slots issued after the S of
    # the next tile, not before it (the barrier's wait a tile after its arrive)
    "late_gather": [("lm_loss.cu", _early(n) + _S_NEXT, _S_NEXT + _early(n)) for n in (4, 2)],
    # the cluster barrier's arrive with release semantics in every thread,
    # in place of one thread's fence and relaxed arrives
    "release_arrive": [("mma_sync.cuh", _FENCE, ""),
                       ("mma_sync.cuh", _ARRIVE, _ARRIVE.replace(".relaxed.", ".release."))],
    # the pipelined cluster instances (three buffers) run in order: the
    # partial S meet at a barrier inside each tile, as where three do not fit
    "in_order": [("lm_loss.cu", "  if constexpr (ST != 3) {\n", "  if constexpr (true) {\n"),
                 ("lm_loss.cu", "    if (ST == 2) {\n      stage(s_oth, other, 0, nb);",
                  "    if (ST >= 2) {\n      stage(s_oth, other, 0, nb);"),
                 ("lm_loss.cu", "      if (ST == 2 && t + 1 < n_t) {",
                  "      if (ST >= 2 && t + 1 < n_t) {"),
                 ("lm_loss.cu", "  if constexpr (ST == 2) {\n    // in order",
                  "  if constexpr (true) {\n    // in order")],
}
# the cluster route as first built: in order, a release arrive in every thread
VARIANTS["first_design"] = VARIANTS["in_order"] + VARIANTS["release_arrive"]


def edited(name: str, sources: dict, variants: dict = VARIANTS) -> dict:
    """``sources`` ({file: text}) with the edits of ``variants[name]``;
    ValueError unless each edit's text occurs exactly once."""
    out = dict(sources)
    for fname, old, new in variants[name]:
        n = out[fname].count(old)
        if n != 1:
            raise ValueError(f"variant {name!r}: its edit of {fname} matches {n} times")
        out[fname] = out[fname].replace(old, new)
    return out


def check() -> None:
    """Every variant's edits apply to the current sources."""
    sources = {f: (CSRC / f).read_text() for f in ("lm_loss.cu", "mma_sync.cuh")}
    for name in VARIANTS:
        edited(name, sources)


_RUN = r"""
import json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
from paddle_tpu_torch.ops.kernels import lm_loss as lm

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

gen = torch.Generator(device="cuda").manual_seed(5)
n, v, h, dtype = 8192, 50304, int(sys.argv[2]), getattr(torch, sys.argv[3])
w = torch.randn(v, h, device="cuda", generator=gen) * 0.02
hh = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
lab = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
g = torch.ones(n, device="cuda")
_, lse = lm.lm_loss_fwd(hh, w, lab)
plan = lm.backward_plan(hh.dtype, h)
assert plan.route == ("tf32x3" if dtype == torch.float32 else "mma")
dh, dw = lm.lm_loss_dh(hh, w, lab, lse, g), lm.lm_loss_dw(hh, w, lab, lse, g)
pdh, pdw = lm.lm_loss_bwd_plain(hh, w, lab, lse, g)
rec = {"variant": sys.argv[1], "card": torch.cuda.get_device_name(0), "hidden": h,
       "dtype": sys.argv[3], "plan": plan._asdict(),
       "dh_ms": cuda_ms(lambda: lm.lm_loss_dh(hh, w, lab, lse, g)),
       "dw_ms": cuda_ms(lambda: lm.lm_loss_dw(hh, w, lab, lse, g))}
for k, got, ref in (("dh", dh, pdh), ("dw", dw, pdw)):
    got, ref = got.float(), ref.float()
    rec[k + "_max_abs_err"] = (got - ref).abs().max().item()
    rec[k + "_tol"] = (1e-4 * max(1.0, ref.abs().max().item()) if dtype == torch.float32
                       else (2e-2 if k == "dh" else 1e-3) * ref.abs().max().item())
    rec[k + "_rel_frob"] = ((got - ref).norm() / ref.norm()).item()
print(json.dumps(rec), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--check", action="store_true", help="only check that the edits apply")
    ap.add_argument("--hidden", type=int, default=768, help="H of h and W (default 768)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="h's dtype (W is f32)")
    args = ap.parse_args(argv)
    check()
    if args.check:
        return 0
    run_variants(args.variants or list(VARIANTS), VARIANTS, ("lm_loss.cu", "mma_sync.cuh"),
                 ("lm_loss",), _RUN, (str(args.hidden), args.dtype))
    return 0


def run_variants(names, variants, files, libraries, script, script_args=()) -> None:
    """Build each variant of ``names`` (edits of ``files`` in csrc/, as
    ``variants`` names them) in its own copy of the package under a
    temporary directory, all builds of the ``libraries`` at once; then run
    ``script`` (python -c, the variant's name and ``script_args`` as its
    arguments) in each copy, in the order given and again in reverse."""
    sources = {f: (CSRC / f).read_text() for f in files}
    with tempfile.TemporaryDirectory() as tmp:
        roots = {}
        for name in names:
            root = Path(tmp) / name
            shutil.copytree(PACKAGE, root / PACKAGE.name,
                            ignore=shutil.ignore_patterns("build", "__pycache__"))
            for fname, text in edited(name, sources, variants).items():
                (root / PACKAGE.name / "ops" / "kernels" / "csrc" / fname).write_text(text)
            roots[name] = root
        build = ("from paddle_tpu_torch.ops.kernels import _build; "
                 f"_build.build({list(libraries)!r})")
        procs = [subprocess.Popen([sys.executable, "-c", build], cwd=r) for r in roots.values()]
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a variant did not build")
        for name in names + names[::-1]:
            subprocess.run([sys.executable, "-c", script, name, *script_args], cwd=roots[name],
                           check=True)


if __name__ == "__main__":
    sys.exit(main())
