"""Read chip_smoke.py's nn_transformer f32 check with the flash kernels'
3xTF32 product cut down: does its limit tell the f32-accurate route from a
cheaper one?

    python -m paddle_tpu_torch.tools.nn_transformer_control [variant ...]
    python -m paddle_tpu_torch.tools.nn_transformer_control --check

A variant is an edit of ``ops/kernels/csrc/mma_sync.cuh`` (``VARIANTS``,
taken from ``lmloss_bwd_variants``), which the flash forward and both
backward kernels call for every f32 product: ``base`` (the sources as they
are: 3xTF32), ``two_term`` (a_small . b_big left out) and ``one_pass`` (one
TF32 product: plain 1xTF32). Each is built in its own copy of the package
under a temporary directory, all builds at once
(``lmloss_bwd_variants.run_variants``); then each runs in its own process,
in the order given and again in reverse. A run builds the phase's
12-layer encoder at ERNIE-3.0-base width (``_nn_transformer_model``) and
runs ``nn_transformer_f32_runs`` at [2, 512]: the output and every gradient
on the card, on the CPU and in f64 on the card. One JSON line a run: the
card's name and power limit, whether every launch took the 3xTF32 route's
kernels, the leaves that pass their limit (``nn_tf_f32_past``, at
chip_smoke.py's NN_TF_F32_TOL and NN_TF_F32_COND) and those that do not,
each leaf's largest card error over its CPU-vs-f64 error (the least
NN_TF_F32_COND that would pass it, without NN_TF_F32_TOL), and whether the k
projections' biases pass their size check (``nn_grad_errors``). Needs a
CUDA card and chip_smoke.py beside the package; ``--check`` only verifies,
on any machine, that every edit applies to the sources exactly once.
"""
from __future__ import annotations

import argparse
import sys

from .lmloss_bwd_variants import CSRC, VARIANTS as _ALL, edited, run_variants

FILES = ("mma_sync.cuh",)
LIBRARIES = ("flash_attention_fwd", "flash_attention_bwd")
VARIANTS = {"base": [], "two_term": _ALL["two_term"], "one_pass": _ALL["one_pass"]}

_RUN = r"""
import copy, importlib.util, json, sys, torch
torch.backends.cuda.matmul.allow_tf32 = False
import paddle_tpu_torch as P
from paddle_tpu_torch.bench import card_name_and_power_limit

spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
place = P.get_place()
try:
    cpu_model = cs._nn_transformer_model(P)
    model = copy.deepcopy(cpu_model).cuda()
    runs = cs.nn_transformer_f32_runs(cpu_model, model)
finally:
    P.set_device(place)
n = cs.NN_TF_WIDTH[3]
try:
    cs._check_route_launches("control", *runs["routes"], n, n, "tf32x3")
    routes = "tf32x3"
except AssertionError as e:
    routes = str(e)
try:
    cs.nn_grad_errors(runs["names"], runs["card"], runs["cpu"])
    k_bias = "pass"
except AssertionError as e:
    k_bias = str(e)
readings = cs.nn_tf_f32_readings(runs)
past = cs.nn_tf_f32_past(readings)
cond = {k: max(r[0], r[2]) / r[1] for k, r in readings.items()}
print(json.dumps({
    "variant": sys.argv[1], "card": card_name_and_power_limit(), "routes": routes,
    "tol": [cs.NN_TF_F32_TOL, cs.NN_TF_F32_COND], "passes": not past and k_bias == "pass",
    "leaves": len(readings), "leaves_past": len(past), "k_bias_check": k_bias,
    "summary": cs.nn_tf_f32_summary(readings),
    "least_cond": {"max": max(cond.values()), "worst": max(cond, key=cond.get),
                   "median": sorted(cond.values())[len(cond) // 2]},
    "past": {k: list(r) for k, r in sorted(past.items(), key=lambda kv: -kv[1][0])[:8]},
}), flush=True)
"""


def check() -> None:
    """Every variant's edits apply to the current sources."""
    sources = {f: (CSRC / f).read_text() for f in FILES}
    for name in VARIANTS:
        edited(name, sources, VARIANTS)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--check", action="store_true", help="only check that the edits apply")
    args = ap.parse_args(argv)
    check()
    if args.check:
        return 0
    smoke = CSRC.parents[3] / "chip_smoke.py"
    if not smoke.is_file():
        raise FileNotFoundError(f"{smoke}: the tool runs chip_smoke.py's check")
    run_variants(args.variants or list(VARIANTS), VARIANTS, FILES, LIBRARIES, _RUN,
                 (str(smoke),))
    return 0


if __name__ == "__main__":
    sys.exit(main())
