"""Shared helpers of the kernels (counterpart of paddle_tpu/ops/pallas/_common.py).

Only the device-independent parts carry over: the finite mask value and the
tile picker that the routing predicates use. VMEM scratch, the 128-lane
broadcast of row statistics and interpret mode are TPU matters.
"""
from __future__ import annotations

NEG_INF = -1e30  # finite (not -inf): exp(NEG_INF - m) is 0, never NaN


def pick_block(n: int, preferred: int = 512) -> int:
    """Largest power-of-two tile from (preferred..8) dividing n; falls back to
    n itself (callers' supported() predicates reject unaligned sizes)."""
    for b in (preferred, 512, 256, 128, 64, 32, 16, 8):
        if b <= preferred and n % b == 0 and b <= n:
            return b
    return n
