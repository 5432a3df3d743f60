"""The bench's gpt_1p3b case ([B, 2048], full recompute, 1 + 2 steps, one
window; ``chip_smoke.py``'s ``bench`` phase runs it through ``case`` at
B = 4) on its own, so that it also runs under the launcher:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        -m paddle_tpu_torch.tools.bench_gpt_1p3b [global batch, default 8]

Under the launcher it is the bench's data-parallel run (each rank takes
B/N rows; ``FLAGS_zero_update=1`` for ZeRO); alone it runs on one card.
Rank 0 prints the bench's JSON line (tokens/s per card, the peak memory of
every rank).
"""
from __future__ import annotations

import json
import os
import sys

from .. import bench
from ..distributed import fleet
from ..models import gpt_1p3b


def case(batch):
    """The run's arguments of ``bench.run``: (config, batch, seq, steps,
    warm-up steps, keyword arguments)."""
    return gpt_1p3b(), batch, 2048, 2, 1, {"windows": 1, "recompute": "full"}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg, batch, seq, steps, warmup, kw = case(int(argv[0]) if argv else 8)
    row = bench.run(cfg, batch, seq, steps, warmup,
                    dp="PADDLE_TRAINERS_NUM" in os.environ, **kw)
    if fleet.worker_index() == 0:
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
