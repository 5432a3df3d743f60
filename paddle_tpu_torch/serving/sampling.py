"""Per-row token sampling (counterpart of paddle_tpu/serving/sampling.py).

Greedy when temperature == 0 (argmax, first maximum on ties). Otherwise
scale by temperature, keep the top-k (clamped to vocab, <= 0 disables), then
the top-p nucleus of what is left (>= 1 disables), then draw.

The draw for the token at sequence position p of a request with seed s uses
its own stream, ``stream_seed(s, p)``, so a request's tokens do not depend
on its slot or its neighbours, and the prefill (first token) and decode
(later tokens) draw alike. The streams are ``torch.Generator``s on the CPU:
the JAX package keys threefry with ``fold_in(seed, position)`` instead, so
sampled tokens differ between the two packages by design; greedy tokens
agree exactly.
"""
from __future__ import annotations

from typing import Sequence

import torch

_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, position: int) -> int:
    """Seed of the (request seed, position) stream: a splitmix64 finaliser
    over both, so nearby seeds and positions give unrelated streams."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def gumbel_noise(seeds: Sequence[int], positions: Sequence[int], vocab: int,
                 device=None) -> torch.Tensor:
    """[n, vocab] Gumbel noise, row i from the stream of (seeds[i],
    positions[i]). argmax(logits + noise) is a draw from softmax(logits)."""
    rows = []
    for s, p in zip(seeds, positions):
        g = torch.Generator().manual_seed(stream_seed(s, p))
        u = torch.rand(vocab, generator=g, dtype=torch.float32)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows).to(device)


def filter_topk_topp(logits, top_k, top_p):
    """Mask [n, V] logits to the per-row top-k / nucleus top-p support.

    top_k int [n] (<= 0 disables; clamped to vocab) and top_p float [n]
    (>= 1 disables). Returns logits with excluded entries at -inf. Top-p
    operates on the top-k-filtered distribution."""
    vocab = logits.shape[-1]
    dev = logits.device
    top_k = torch.as_tensor(top_k, dtype=torch.long, device=dev).reshape(-1)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).reshape(-1)
    neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype, device=dev)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_eff = top_k.clamp(1, vocab)
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    logits = torch.where((top_k[:, None] > 0) & (logits < kth), neg_inf, logits)
    # nucleus cutoff over the (possibly) top-k-filtered logits
    sorted_f = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_f, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1)
    cutoff = sorted_f.gather(-1, cutoff_idx.clamp(0, vocab - 1)[:, None])
    return torch.where((top_p[:, None] < 1.0) & (logits < cutoff), neg_inf, logits)


def sample_tokens(logits, noise, temperature, top_k, top_p):
    """One token per row of [n, V] logits. ``noise`` is the rows' Gumbel
    noise (``gumbel_noise``), or None when every row is greedy. Returns
    int64 [n]."""
    logits = logits.float()
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).reshape(-1)
    greedy = torch.argmax(logits, dim=-1)
    if noise is None:
        if bool((temperature != 0.0).any()):
            raise ValueError("sampled rows need their Gumbel noise")
        return greedy
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    filtered = filter_topk_topp(scaled, top_k, top_p)
    sampled = torch.argmax(filtered + noise, dim=-1)
    return torch.where(temperature == 0.0, greedy, sampled)
