"""Prompt-length bucketing (the port's own copy of paddle_tpu/serving/bucketing.py).

Prompts are right-padded to the smallest rung of a small geometric ladder,
so the prefill runs at a handful of shapes whatever the traffic's lengths.
Causal attention makes the right-pad inert: logits are read at the last real
position, and decode overwrites the pad cache rows before they are attended.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

#: Default geometric rung set; clip to the model's max_seq_len with
#: clip_ladder before use.
DEFAULT_LADDER: Tuple[int, ...] = (64, 128, 256, 512)


def clip_ladder(ladder: Iterable[int], max_len: int,
                reserve: int = 0) -> Tuple[int, ...]:
    """Sorted, deduplicated rungs that fit max_len - reserve (reserve =
    decode headroom, e.g. the per-request max_new_tokens cap). Always keeps
    at least one rung: if every rung is too large, the largest feasible
    length itself becomes the single rung."""
    fit = max_len - reserve
    if fit <= 0:
        raise ValueError(f"max_len {max_len} leaves no room after "
                         f"reserving {reserve}")
    rungs = sorted({int(r) for r in ladder if 0 < int(r) <= fit})
    return tuple(rungs) if rungs else (fit,)


def bucket_for(length: int, ladder: Sequence[int] = DEFAULT_LADDER) -> int:
    """Smallest rung >= length. Raises when the prompt exceeds the ladder."""
    if length <= 0:
        raise ValueError(f"prompt length must be positive, got {length}")
    for rung in sorted(int(r) for r in ladder):
        if length <= rung:
            return rung
    raise ValueError(f"prompt length {length} exceeds the bucket ladder "
                     f"{tuple(sorted(ladder))}")


def resolve_bucket(length: int, bucket) -> int:
    """Resolve a prompt_bucket argument: an int is an explicit rung, any
    iterable is a ladder (smallest fitting rung wins)."""
    if isinstance(bucket, bool):
        raise TypeError("prompt_bucket must be an int rung or a ladder of "
                        "ints, not a bool")
    if isinstance(bucket, int):
        if length > bucket:
            raise ValueError(f"prompt length {length} exceeds prompt_bucket "
                             f"{bucket}")
        return int(bucket)
    return bucket_for(length, tuple(bucket))
