"""Viterbi decoding, CRF max-sum inference (counterpart of
paddle_tpu/text/viterbi.py; reference python/paddle/text/viterbi_decode.py:24
and the phi viterbi_decode kernel).

Two loops over time on the potentials' device: the forward max-sum
recursion carries (alpha, remaining length) and keeps each step's
backpointers; the backward trace walks them from the last step. A sequence
shorter than the padded length freezes its alpha once exhausted; with
``include_bos_eos_tag`` the last tag is the forced start (its transition
row added to the first step) and the second to last the end (its row
added at each sequence's last step). The trace emits 0 past a sequence's
end and holds its ids before that end is reached, as the JAX op does.
``argmax`` takes the first maximum. The path is trimmed to
``max(lengths)``, read on the host.
"""
from __future__ import annotations

import torch

from ..ops.creation import to_tensor

__all__ = ["viterbi_decode", "ViterbiDecoder"]


def viterbi_decode(potentials, transition_params, lengths, include_bos_eos_tag=True,
                   name=None):
    """The highest-scoring tag sequence.

    Args:
        potentials: [batch, seq_len, num_tags] emission scores.
        transition_params: [num_tags, num_tags] transition scores.
        lengths: [batch] valid lengths.
        include_bos_eos_tag: the last tag is BOS (forced start), the second
            to last EOS (its transition row added at each sequence's end).

    Returns:
        (scores [batch], paths [batch, max(lengths)] int64).
    """
    pot, trans = potentials, transition_params.to(potentials.device)
    left = lengths.to(pot.device)[:, None].to(torch.int32)     # remaining steps, [B, 1]
    if include_bos_eos_tag:
        # the forced start: alpha = e_0 + trans[BOS], the EOS row at once for length 1
        alpha = pot[:, 0] + trans[-1][None, :]
        alpha = alpha + (left == 1) * trans[-2][None, :]
    else:
        alpha = pot[:, 0]
    left = left - 1

    backptrs = []
    for t in range(1, pot.shape[1]):
        scored = alpha[:, :, None] + trans[None]               # [B, K_prev, K_next]
        best = scored.amax(1) + pot[:, t]
        backptrs.append(scored.argmax(1))                      # [B, K_next]
        active = (left > 0).to(alpha.dtype)
        alpha = active * best + (1 - active) * alpha
        if include_bos_eos_tag:
            alpha = alpha + (left == 1) * trans[-2][None, :]
        left = left - 1

    scores = alpha.amax(1)
    last_ids = alpha.argmax(1).to(torch.int32)
    left = left[:, 0]
    ids, remaining = last_ids, left
    path = [None] * len(backptrs)
    for t in range(len(backptrs) - 1, -1, -1):
        # shorter sequences emit 0 until their own last step is reached
        remaining = remaining + 1
        prev = backptrs[t].gather(1, ids[:, None].long())[:, 0].to(torch.int32)
        prev = prev * (remaining > 0)
        prev = torch.where(remaining == 0, ids, prev)
        ids = torch.where(remaining < 0, ids, prev)           # before the end: hold ids
        path[t] = prev
    path.append(last_ids * (left >= 0))
    path = torch.stack(path, 1)
    return scores, path[:, :int(lengths.max())].to(torch.int64)


class ViterbiDecoder:
    """``viterbi_decode`` with its transition matrix held (reference
    python/paddle/text/viterbi_decode.py ViterbiDecoder)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions if torch.is_tensor(transitions) \
            else to_tensor(transitions)
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths, self.include_bos_eos_tag)

    forward = __call__
