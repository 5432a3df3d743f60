"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

Each rule maps a list of ``(param, grad)`` pairs to a new list, grads of
None passing through, under ``no_grad``. Norms are taken in f32 and the
scaled grads keep their dtype, as in the JAX package.

As the JAX package does: ``ClipGradByGlobalNorm`` takes ``group_name`` and
``auto_skip_clip`` and reads neither; ``clip_grad_norm_`` returns the global
norm after clipping and ignores ``norm_type`` and ``error_if_nonfinite``.
"""
from __future__ import annotations

import torch


def _sq_norm(g):
    return g.float().square().sum()


class ClipGradBase:
    def _clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        with torch.no_grad():
            return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, params_grads):
        return [(p, None if g is None else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each grad scaled to norm at most ``clip_norm`` on its own."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is not None:
                norm = torch.sqrt(_sq_norm(g))
                scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
                g = (g * scale).to(g.dtype)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every grad scaled by ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def compute_global_norm(self, grads):
        sq = [_sq_norm(g) for g in grads if g is not None]
        if not sq:
            return None
        return torch.sqrt(torch.stack(sq).sum())

    def _clip(self, params_grads):
        gn = self.compute_global_norm([g for _, g in params_grads])
        if gn is None:
            return params_grads
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(p, None if g is None else (g * scale).to(g.dtype))
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` to global norm at most
    ``max_norm``, in place of each grad; returns the global norm after the
    clip (a 0-d f32 tensor), or None when no parameter has a grad."""
    params = [p for p in parameters if p.grad is not None]
    clip = ClipGradByGlobalNorm(max_norm)
    pairs = clip([(p, p.grad) for p in params])
    for p, g in pairs:
        p.grad = g
    return clip.compute_global_norm([g for _, g in pairs])
