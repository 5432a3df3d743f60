"""Mixture of experts on the ``ep`` axis (counterpart of
paddle_tpu/distributed/meta_parallel/moe.py; reference incubate MoELayer,
moe_layer.py:233).

``MoELayer`` routes each token to its top-k experts with capacity-based
dense dispatch (the GShard formulation, the JAX package's arithmetic in
f32): softmax of the gate's logits, the top k, one position counter per
expert shared across the k choices in k-major order (every first choice
outranks every second; a per-column count would give a first and a second
choice the same slot and sum them), the tokens past
``capacity = max(1, int(capacity_factor * tokens * k / experts))``
dropped (their share of the output is zero), then the [T, E, C] dispatch
and combine tensors, the experts' FFN on their [E, C, d] inputs, and the
gated combine.

At ``ep_degree > 1`` each rank of the expert-parallel group holds E / ep
experts (rank r the r-th block; ``ep_splits`` names the split for the
engine's gather), as the JAX package's ``P("ep", ...)`` specs place them.
What GSPMD derives from those specs is written out: the tokens and the gate
are replicated over ep (every ep rank takes the same rows); each rank
dispatches to and combines from its own experts, and one all-reduce over
the ep group (``reduce_from_mp``) sums the partial outputs. In the
backward the expert path's token gradient and the logits' gradient are
summed over ep (``copy_to_mp`` on the experts' token input and on the
logits), so the gate's parameters get the whole gradient on every rank.
The experts are whole on every mp rank (the JAX package's mp split of
their hidden dim is not ported).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF
from torch import nn

from ...ops import nn_functional as F
from ..mesh import get_hybrid_communicate_group
from .mp_layers import copy_to_mp, reduce_from_mp

_ACTIVATIONS = {"gelu": lambda x: TF.gelu(x, approximate="tanh"), "relu": TF.relu,
                "silu": TF.silu, "swish": TF.silu}


def ep_info(moe_group=None):
    """(group, rank, size) of ``moe_group``, or of the global topology's
    expert-parallel group; (None, 0, 1) without one."""
    if moe_group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None or hcg.degrees.get("ep", 1) <= 1:
            return None, 0, 1
        moe_group = hcg.get_expert_parallel_group()
    if moe_group.nranks == 1:
        return moe_group, 0, 1
    return moe_group, moe_group.rank, moe_group.nranks


class _Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class NaiveGate(nn.Module):
    """The gate's logits, a Linear d_model -> num_experts (``[out, in]``
    weight, models/convert.py's layout)."""

    def __init__(self, d_model, num_experts):
        super().__init__()
        self.gate = _Linear(d_model, num_experts)

    def forward(self, x):
        return self.gate(x)


class GShardGate(NaiveGate):
    pass


class SwitchGate(NaiveGate):
    pass


class ExpertFFN(nn.Module):
    """The experts' FFN weights stacked over the experts this rank holds:
    w1 [E/ep, d_model, d_hidden], b1 [E/ep, 1, d_hidden], w2 [E/ep, d_hidden,
    d_model], b2 [E/ep, 1, d_model] (the JAX package's layout). The
    weights are drawn as the logical [E, ...] tensors from torch's global
    generator (Xavier normal per expert, zero biases) and sliced, so every
    ep degree starts from the same experts."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu", moe_group=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.ep_group, self.ep_rank, self.ep_size = ep_info(moe_group)
        if num_experts % self.ep_size:
            raise ValueError(f"num_experts {num_experts} is not divisible by the "
                             f"expert-parallel degree {self.ep_size}")
        self.num_experts = num_experts
        self.local_experts = num_experts // self.ep_size
        self.act = activation
        self.ep_splits = {n: (0, 1) for n in ("w1", "b1", "w2", "b2")}
        lo, hi = self.ep_rank * self.local_experts, (self.ep_rank + 1) * self.local_experts
        with torch.no_grad():
            w1 = torch.randn(num_experts, d_model, d_hidden) * math.sqrt(
                2.0 / (d_model + d_hidden))
            w2 = torch.randn(num_experts, d_hidden, d_model) * math.sqrt(
                2.0 / (d_model + d_hidden))
        self.w1 = nn.Parameter(w1[lo:hi].clone())
        self.b1 = nn.Parameter(torch.zeros(self.local_experts, 1, d_hidden))
        self.w2 = nn.Parameter(w2[lo:hi].clone())
        self.b2 = nn.Parameter(torch.zeros(self.local_experts, 1, d_model))


class MoELayer(nn.Module):
    """Top-k MoE with capacity-based dense dispatch (GShard); module
    docstring. ``moe_group``: the expert-parallel group (default: the
    topology's ep group)."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2, capacity_factor=1.25,
                 gate=None, moe_group=None, mp_group=None, recompute_interval=0,
                 activation="gelu"):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.gate = gate if isinstance(gate, nn.Module) else NaiveGate(d_model, num_experts)
        self.experts = ExpertFFN(num_experts, d_model, d_hidden, activation, moe_group)

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens * self.top_k / self.num_experts))

    def routing(self, logits, capacity):
        """(dispatch, combine), each [T, E, C] f32, of the gate's logits."""
        E, K = self.num_experts, self.top_k
        probs = torch.softmax(logits.float(), dim=-1)
        # the k largest, ties to the lower expert (jax.lax.top_k's order)
        topv, topi = (t[..., :K] for t in torch.sort(probs, dim=-1, descending=True,
                                                      stable=True))
        n = probs.shape[0]
        onehot = TF.one_hot(topi, E).float()                          # [T, K, E]
        pos = (torch.cumsum(onehot.transpose(0, 1).reshape(K * n, E), dim=0) - 1.0)
        pos = pos.reshape(K, n, E).transpose(0, 1)                    # [T, K, E]
        keep = (pos < capacity).float() * onehot
        gates = topv[..., None] * keep
        pos_idx = torch.einsum("tke,tke->tk", pos, keep).long()
        cap_oh = TF.one_hot(pos_idx, capacity).float()                # [T, K, C]
        return (torch.einsum("tke,tkc->tec", keep, cap_oh),
                torch.einsum("tke,tkc->tec", gates, cap_oh))

    def forward(self, x):
        """x: [batch, seq, d_model] or [tokens, d_model]."""
        orig_shape = x.shape
        tokens = x.reshape(-1, orig_shape[-1]) if x.dim() == 3 else x
        e = self.experts
        group = e.ep_group if e.ep_size > 1 else None
        logits = copy_to_mp(self.gate(tokens), group)                  # [T, E]
        dispatch, combine = self.routing(logits, self.capacity(tokens.shape[0]))
        lo = e.ep_rank * e.local_experts
        dispatch, combine = (t[:, lo:lo + e.local_experts] for t in (dispatch, combine))
        tok = copy_to_mp(tokens, group).float()
        expert_in = torch.einsum("tec,td->ecd", dispatch, tok)
        h = torch.einsum("ecd,edh->ech", expert_in, e.w1.float()) + e.b1.float()
        h = _ACTIVATIONS[e.act](h)
        out = torch.einsum("ech,ehd->ecd", h, e.w2.float()) + e.b2.float()
        y = reduce_from_mp(torch.einsum("tec,ecd->td", combine, out), group)
        return y.to(tokens.dtype).reshape(orig_shape)
