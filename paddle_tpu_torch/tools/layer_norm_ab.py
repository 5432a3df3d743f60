"""Time the LayerNorm kernels of the checkout it runs from, so that two
commits can be compared on one card in one call.

    python -m paddle_tpu_torch.tools.layer_norm_ab [--label NAME] [--widths 768,1024,2048]

Run from a checkout's root: it imports that root's ``chip_smoke`` (its
``device_ms``, ``device_profile`` and ``_bound``, which every commit since
the library ops has) and that root's ``paddle_tpu_torch``. To compare with
another commit, unpack that commit into a git-ignored directory, copy this
file into its ``paddle_tpu_torch/tools/``, and run both roots in turns
(other, this, this, other) within one chip call.

At [8192, h] for each width, f32 and bf16 (inputs from seed 4, as
``chip_smoke.phase_layer_norm_kernels`` makes them): the training forward,
the inference forward and the backward, each against its plain version
(the script raises past 1e-4 x max(1, max|ref|) at f32 and 2e-2 x max|ref|
at bf16), timed by ``device_ms`` (cold L2, median of 20); the kernels of
one training forward and of one backward by torch.profiler
(``fwd_profile``, ``bwd_profile``: [name, ms] by time);
beside each ``device_ms`` the same median after a read-only flush
(``read_flush_ms``: the copy of ``device_ms`` leaves up to 50 MB of dirty
lines in the L2, which a call's own traffic then writes back); and first
the events' floor, ``device_ms`` of a one-element fill. ``--no-check``
times edited copies that leave work out. One JSON line each, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def _err(got, ref, dtype, torch):
    scale = ref.float().abs().max().item()
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 2e-2 * scale
    err = (got.float() - ref.float()).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"kernel vs plain error {err} (tol {tol})")
    return err


def read_flush_ms(fn, torch, iters=20):
    """``chip_smoke.device_ms`` with the L2 evicted by reading 512 MB (a sum)
    instead of writing it (a copy): the call finds the L2 cold but clean, so
    its own traffic does not write back the flush's dirty lines."""
    import statistics

    src = torch.empty(128 << 20, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        src.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--widths", default="768,1024,2048")
    ap.add_argument("--no-check", action="store_true",
                    help="time without holding the kernels to their plain versions "
                         "(for edited copies that leave work out)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("layer_norm_ab needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c
    from paddle_tpu_torch.bench import card_name_and_power_limit
    from paddle_tpu_torch.ops.kernels import layer_norm as ln

    card = card_name_and_power_limit()
    floor = c.device_ms(torch.empty(1, device="cuda").zero_)
    print(json.dumps({"tool": "layer_norm_ab", "label": args.label, "card": card,
                      "events_floor_ms": floor}), flush=True)
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(4)
    for h in (int(w) for w in args.widths.split(",")):
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(n, h, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
            dy = torch.randn(n, h, device="cuda", generator=gen).to(dtype)
            g = 1 + 0.1 * torch.randn(h, device="cuda", generator=gen)
            b = 0.1 * torch.randn(h, device="cuda", generator=gen)
            o, mu, rstd = ln.layer_norm_fwd(x, g, b, stats=True)
            dx, dg, db = ln.layer_norm_bwd(x, g, dy, mu, rstd)
            po, pmu, prstd = ln.layer_norm_fwd_plain(x, g, b)
            pdx, pdg, pdb = ln.layer_norm_bwd_plain(x, g, dy, mu, rstd)
            errs = [0.0] if args.no_check else [
                _err(o, po, dtype, torch), _err(dx, pdx, dtype, torch),
                _err(dg, pdg, torch.float32, torch), _err(db, pdb, torch.float32, torch)]
            io = x.element_size() * n * h
            calls = {"fwd": lambda: ln.layer_norm_fwd(x, g, b, stats=True),
                     "infer": lambda: ln.layer_norm_fwd(x, g, b, stats=False),
                     "bwd": lambda: ln.layer_norm_bwd(x, g, dy, mu, rstd)}
            times = {f"{k}_ms": c.device_ms(fn) for k, fn in calls.items()}
            times.update({f"{k}_ms_read_flush": read_flush_ms(fn, torch)
                          for k, fn in calls.items()})
            bounds = {"fwd_bound_ms": c._bound(7 * n * h, 2 * io + 8 * h + 8 * n,
                                               torch.float32)[0],
                      "bwd_bound_ms": c._bound(13 * n * h, 3 * io + 12 * h + 8 * n,
                                               torch.float32)[0]}
            profiles = {
                "fwd_profile": c.device_profile(lambda: ln.layer_norm_fwd(x, g, b))[2],
                "bwd_profile": c.device_profile(lambda: ln.layer_norm_bwd(x, g, dy, mu,
                                                                           rstd))[2]}
            print(json.dumps({"tool": "layer_norm_ab", "label": args.label, "card": card,
                              "shape": [n, h], "dtype": str(dtype)[6:], **times, **bounds,
                              **profiles, "max_abs_err": max(errs)}),
                  flush=True)
            del x, dy, o, mu, rstd, dx, dg, db, po, pmu, prstd, pdx, pdg, pdb
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
