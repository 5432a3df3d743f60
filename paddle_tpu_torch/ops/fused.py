"""Fused LM head + softmax cross entropy, chunked, with a recompute backward
(counterpart of paddle_tpu/ops/fused.py).

    loss[i] = logsumexp(h[i] @ Wᵀ) - (h[i] @ Wᵀ)[label[i]]

is computed over row chunks of ``_CHUNK`` rows: each chunk's [chunk, vocab]
f32 logits live only while that chunk is processed, and the backward
recomputes them chunk by chunk instead of saving softmax residuals. Saved
for the backward: the inputs and the per-row logsumexp. Rows are padded with
``ignore_index`` up to a multiple of the chunk; ignored rows have loss 0 and
no gradient. dW is accumulated in f32 across chunks and cast to W's dtype at
the end.

The products are plain ``torch.matmul`` (the JAX package leaves them to XLA,
outside any Pallas kernel; its LM-loss kernel is retired from this route,
fused.py:132-138). Inputs of another dtype than f32 are widened to f32 for
the products: a bf16 value is exact in f32, so this is the reference's
storage-dtype product with f32 accumulation.
"""
from __future__ import annotations

import torch

from ..amp import cast_inputs

_CHUNK = 2048  # rows per chunk: 2048 x 50304 f32 logits = 412 MB transient


def _logits_chunk(hc, w, transpose_y):
    """[C, H] x W -> [C, V] f32 (W taken in the activation dtype, as the
    reference casts it)."""
    wc = w.to(hc.dtype).float()
    return torch.matmul(hc.float(), wc.t() if transpose_y else wc)


class _FusedLinearCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h2, w, labels, transpose_y, chunk, ignore_index):
        n = h2.shape[0]
        loss = torch.empty(n, dtype=torch.float32, device=h2.device)
        lse = torch.empty(n, dtype=torch.float32, device=h2.device)
        for r0 in range(0, n, chunk):
            hc, lc = h2[r0:r0 + chunk], labels[r0:r0 + chunk]
            logits = _logits_chunk(hc, w, transpose_y)
            m = logits.amax(dim=-1)
            lse_c = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
            ignored = lc == ignore_index
            picked = logits.gather(1, lc.masked_fill(ignored, 0)[:, None])[:, 0]
            loss[r0:r0 + chunk] = torch.where(ignored, 0.0, lse_c - picked)
            lse[r0:r0 + chunk] = lse_c
        ctx.save_for_backward(h2, w, labels, lse)
        ctx.transpose_y, ctx.chunk, ctx.ignore_index = transpose_y, chunk, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, w, labels, lse = ctx.saved_tensors
        chunk, ignore_index = ctx.chunk, ctx.ignore_index
        n = h2.shape[0]
        wc = w.to(h2.dtype).float()
        dh = torch.empty_like(h2)
        dw = torch.zeros(wc.shape, dtype=torch.float32, device=w.device)
        for r0 in range(0, n, chunk):
            hc, lc = h2[r0:r0 + chunk], labels[r0:r0 + chunk]
            p = torch.exp(_logits_chunk(hc, w, ctx.transpose_y)
                          - lse[r0:r0 + chunk, None])
            ignored = lc == ignore_index
            gc = torch.where(ignored, 0.0, g[r0:r0 + chunk].float())
            p[torch.arange(p.shape[0], device=p.device), lc.masked_fill(ignored, 0)] -= 1.0
            dl = (p * gc[:, None]).to(hc.dtype).float()       # [C, V]
            if ctx.transpose_y:                                # W [V, H]
                dh[r0:r0 + chunk] = torch.matmul(dl, wc).to(hc.dtype)
                dw += torch.matmul(dl.t(), hc.float())
            else:                                              # W [H, V]
                dh[r0:r0 + chunk] = torch.matmul(dl, wc.t()).to(hc.dtype)
                dw += torch.matmul(hc.float().t(), dl)
        return dh, dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(hidden, weight, label, transpose_y=True,
                               ignore_index=-100, chunk=_CHUNK):
    """Per-position LM loss without materializing the full logits.

    hidden: [..., H]; weight: [V, H] if transpose_y (the tied-embedding
    layout) else [H, V]; label: int [...]. Returns the f32 loss of shape
    [...], 0 where label == ignore_index. Differentiable in hidden and
    weight."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    hidden, weight = cast_inputs("fused_linear_cross_entropy", hidden, weight)
    lead_shape = hidden.shape[:-1]
    hdim = hidden.shape[-1]
    h2 = hidden.reshape(-1, hdim)
    lb = label.reshape(-1).to(device=hidden.device, dtype=torch.long)
    n = h2.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        h2 = torch.cat([h2, h2.new_zeros(pad, hdim)])
        lb = torch.cat([lb, lb.new_full((pad,), ignore_index)])
    loss = _FusedLinearCrossEntropy.apply(h2, weight, lb, bool(transpose_y), chunk,
                                          int(ignore_index))
    return loss[:n].reshape(lead_shape)
