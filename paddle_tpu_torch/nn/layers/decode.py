"""Beam-search decoding (counterpart of paddle_tpu/nn/layers/decode.py):
``gather_tree`` only. ``BeamSearchDecoder``, ``Decoder`` and
``dynamic_decode`` are ROADMAP Queue 1 item 17, with the RNN layers."""
from __future__ import annotations

import numpy as np
import torch


def gather_tree(ids, parents):
    """Full beams from each step's tokens and parent pointers ([T, N, beam]
    each), walked back from the last step on the host, as the JAX op does."""
    ids_np = ids.detach().cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
    par_np = parents.detach().cpu().numpy() if torch.is_tensor(parents) \
        else np.asarray(parents)
    T, N, B = ids_np.shape
    out = np.zeros_like(ids_np)
    for n in range(N):
        for b in range(B):
            beam = b
            for t in range(T - 1, -1, -1):
                out[t, n, b] = ids_np[t, n, beam]
                beam = par_np[t, n, beam]
    res = torch.from_numpy(out)
    return res.to(ids.device) if torch.is_tensor(ids) else res
