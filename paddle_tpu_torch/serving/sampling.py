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

Speculative decoding (reference sampling.py:80-112) draws from two more
streams a position, each the plain stream's seed folded once more with a
salt (``spec_stream_seed``): the draft's proposal (``DRAFT_SALT``) and the
acceptance uniform (``ACCEPT_SALT``). The token that replaces a rejected
proposal, and the bonus token after a window accepted whole, use the plain
stream of their position, so a window accepted whole emits the token a
decode step would have drawn there. These draws too differ from JAX's by
design; greedy speculative tokens are the target's argmax, exactly.
"""
from __future__ import annotations

from typing import Sequence

import torch

_MASK64 = (1 << 64) - 1


# speculative decoding's stream salts (the reference's values)
DRAFT_SALT = 0x5BEC
ACCEPT_SALT = 0xACCE


def _splitmix64(z: int) -> int:
    """splitmix64's finaliser of a 64-bit word, to 63 bits (a torch seed)."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def stream_seed(seed: int, position: int) -> int:
    """Seed of the (request seed, position) stream: a splitmix64 finaliser
    over both, so nearby seeds and positions give unrelated streams."""
    return _splitmix64((int(seed) & 0xFFFFFFFF) << 32 | (int(position) & 0xFFFFFFFF))


def spec_stream_seed(seed: int, position: int, salt: int) -> int:
    """Seed of a speculative stream of (seed, position): the plain stream's
    seed XOR the salt in its top 32 bits, through the finaliser once more
    (as the reference's ``spec_key`` folds ``request_key`` once more), so
    the salted streams are unrelated to the plain one and to each other."""
    return _splitmix64(stream_seed(seed, position) ^ ((int(salt) & 0xFFFFFFFF) << 32))


def _stream_seeds(seeds, positions, salt):
    if salt is None:
        return [stream_seed(s, p) for s, p in zip(seeds, positions)]
    return [spec_stream_seed(s, p, salt) for s, p in zip(seeds, positions)]


def gumbel_noise(seeds: Sequence[int], positions: Sequence[int], vocab: int,
                 device=None, salt=None) -> torch.Tensor:
    """[n, vocab] Gumbel noise, row i from the stream of (seeds[i],
    positions[i]), salted with ``salt`` when given. argmax(logits + noise)
    is a draw from softmax(logits)."""
    rows = []
    for z in _stream_seeds(seeds, positions, salt):
        g = torch.Generator().manual_seed(z)
        u = torch.rand(vocab, generator=g, dtype=torch.float32)
        rows.append(-torch.log(-torch.log(u)))
    return torch.stack(rows).to(device)


def accept_uniforms(seeds: Sequence[int], positions: Sequence[int]) -> torch.Tensor:
    """[n] f32 uniforms in [0, 1) on the CPU, one from each (seeds[i],
    positions[i]) ``ACCEPT_SALT`` stream: the speculative acceptance test's
    u."""
    out = torch.empty(len(seeds), dtype=torch.float32)
    for i, z in enumerate(_stream_seeds(seeds, positions, ACCEPT_SALT)):
        out[i] = torch.rand(1, generator=torch.Generator().manual_seed(z))
    return out


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


def filtered_probs(logits, temperature, top_k, top_p):
    """[n, V] sampling distribution of each row: the softmax of the
    temperature-scaled, top-k / top-p masked logits. Both sides of the
    acceptance test u < p_t(d) / p_d(d) use it, so the target and the draft
    are filtered alike (reference sampling.py:91)."""
    logits = logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device).reshape(-1)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    return torch.softmax(filter_topk_topp(scaled, top_k, top_p), dim=-1)


def residual_sample(p_target, p_draft, noise):
    """One draw a row from normalize(max(p_t - p_d, 0)), the distribution
    that replaces a rejected proposal (Leviathan et al.); rows whose
    residual has no mass draw from p_t. ``noise`` [n, V] is the Gumbel
    noise of the plain stream at the row's position, the noise
    ``sample_tokens`` would draw that token with. Returns int64 [n]."""
    res = (p_target - p_draft).clamp_min(0.0)
    mass = res.sum(dim=-1, keepdim=True)
    res = torch.where(mass > 0.0, res, p_target)
    return torch.argmax(torch.log(res.clamp_min(1e-38)) + noise, dim=-1)


def spec_draws(seeds, offsets, n_draft, sampled, k: int, vocab: int):
    """The host draws of one verify dispatch of window ``k`` for [S] slots
    at ``offsets`` (host arrays). Rows where ``sampled`` is False get zeros
    (greedy rows ignore noise). For a sampled row with ``n_draft`` d:

    - draft noise [k, S, V]: step i < d from the DRAFT_SALT stream at
      off + i + 1 (the proposal for that position);
    - uniforms [S, k]: column j < d from the ACCEPT_SALT stream at
      off + j + 1;
    - plain noise [S, k + 1, V]: column j <= d from the plain stream at
      off + j + 1 (the token after j accepted proposals).

    Out-of-window entries are zero: no emitted token reads them. Each
    step's or column's rows are made in one call. On the CPU."""
    S = len(offsets)
    dnoise = torch.zeros((k, S, vocab))
    uniforms = torch.zeros((S, k))
    pnoise = torch.zeros((S, k + 1, vocab))
    for j in range(k + 1):
        rows = [r for r in range(S) if sampled[r] and j <= n_draft[r]]
        if rows:
            pnoise[rows, j] = gumbel_noise([seeds[r] for r in rows],
                                           [offsets[r] + j + 1 for r in rows], vocab)
        inner = [r for r in rows if j < n_draft[r]]
        if inner:
            s_in, p_in = [seeds[r] for r in inner], [offsets[r] + j + 1 for r in inner]
            dnoise[j, inner] = gumbel_noise(s_in, p_in, vocab, salt=DRAFT_SALT)
            uniforms[inner, j] = accept_uniforms(s_in, p_in)
    return dnoise, uniforms, pnoise
