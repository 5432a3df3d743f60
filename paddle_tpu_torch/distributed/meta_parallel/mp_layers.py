"""Tensor-parallel layers (counterpart of
paddle_tpu/distributed/meta_parallel/mp_layers.py): ``VocabParallelEmbedding``,
``ColumnParallelLinear``, ``RowParallelLinear``, ``ParallelCrossEntropy`` and
``split``.

Megatron-style and explicit: each rank of the model-parallel group holds its
own 1/mp shard, and the collectives run where GSPMD inserts them in the JAX
package (which keeps the full logical weight under a ``PartitionSpec``).
Each collective is a ``torch.autograd.Function``, Megatron's f and g:

- into a column layer: identity forward, all-reduce of the input's
  gradient backward (``copy_to_mp``);
- out of a row layer: all-reduce forward, identity backward
  (``reduce_from_mp``); the row layer's bias is added once, after it;
- the embedding: a masked lookup of the rank's vocab rows, then
  ``reduce_from_mp``;
- ``gather_output=True``: all-gather along the last dim forward, the rank's
  slice of the gradient backward.

Layouts are the port's (``nn.Linear``'s ``[out, in]``). Each layer names
its sharded parameters in ``mp_splits``, {name: (dim, blocks)}: the
logical tensor is ``blocks`` equal pieces along ``dim``, each split into mp
equal parts, and a rank holds its part of every piece (``blocks`` is 1 but
for a fused projection such as GPT's qkv, whose rank holds its heads of q,
of k and of v). ``sharded_parameters(model)`` lists them by parameter name;
``mp_slice`` and ``mp_gather`` map between a shard and the logical tensor
(the engine's checkpoints and models/convert.py use them). At mp = 1
every layer is its dense counterpart: the same parameter names, the same
calls and the same bits.

A layer's default weights are drawn as the logical tensor from torch's
global generator (Xavier normal, zero biases) and sliced, so every mp degree
starts from the same logical weights.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...amp import cast_inputs
from ...ops import nn_functional as F
from .. import collective
from ..mesh import get_hybrid_communicate_group


def mp_info(mp_group=None):
    """(group, rank, size) of ``mp_group``, or of the global topology's
    model-parallel group; (None, 0, 1) without one."""
    if mp_group is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None or getattr(hcg, "degrees", {}).get("mp", 1) <= 1:
            return None, 0, 1
        mp_group = hcg.get_model_parallel_group()
    if mp_group is None or mp_group.nranks == 1:
        return mp_group, 0, 1
    return mp_group, mp_group.rank, mp_group.nranks


# ------------------------------------------------------------ collectives

class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        return collective.all_reduce(g, group=ctx.group), None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.all_reduce(x.clone(memory_format=torch.contiguous_format),
                                     group=group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return torch.cat(collective.all_gather(None, x.contiguous(), group=group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        grp = ctx.group
        return g.chunk(grp.nranks, dim=-1)[grp.rank].contiguous(), None


class _ScatterToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.nranks, dim=-1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(collective.all_gather(None, g.contiguous(), group=ctx.group),
                         dim=-1), None


def copy_to_mp(x, group):
    """Identity forward; the gradient is all-reduced over ``group``."""
    return x if group is None or group.nranks == 1 else _CopyToMp.apply(x, group)


def reduce_from_mp(x, group):
    """All-reduce (sum) forward over ``group``; identity backward."""
    return x if group is None or group.nranks == 1 else _ReduceFromMp.apply(x, group)


def gather_from_mp(x, group):
    """The ranks' ``x`` concatenated along the last dim; backward, the
    rank's slice."""
    return x if group is None or group.nranks == 1 else _GatherFromMp.apply(x, group)


def scatter_to_mp(x, group):
    """The rank's slice of ``x``'s last dim; backward, the gradients
    all-gathered."""
    return x if group is None or group.nranks == 1 else _ScatterToMp.apply(x, group)


# ------------------------------------------------------------ shard layout

def mp_slice(full, split, rank, size):
    """The rank's shard of the logical tensor ``full`` under ``split`` =
    (dim, blocks); ``full`` itself when ``split`` is None or size is 1."""
    if split is None or size == 1:
        return full
    dim, blocks = split
    pieces = full.chunk(blocks, dim=dim)
    return torch.cat([pc.chunk(size, dim=dim)[rank] for pc in pieces], dim=dim)


def mp_gather(shards, split):
    """The logical tensor from the ranks' shards (in mp rank order)."""
    if split is None or len(shards) == 1:
        return shards[0]
    dim, blocks = split
    per = [s.chunk(blocks, dim=dim) for s in shards]
    return torch.cat([torch.cat([p[b] for p in per], dim=dim) for b in range(blocks)],
                     dim=dim)


def logical_shape(shape, split, size):
    shape = list(shape)
    if split is not None:
        shape[split[0]] *= size
    return tuple(shape)


def sharded_parameters(model, axis="mp"):
    """{name: (split, size)} of every parameter of ``model`` that a layer
    splits over ``axis`` (by the modules' ``<axis>_splits`` and
    ``<axis>_size``: "mp" here, "pp" for GPTForPretrainingPipe's stages,
    "ep" for the experts of meta_parallel/moe.py; names as
    ``model.named_parameters()`` gives them)."""
    out = {}
    for mname, m in model.named_modules():
        splits = getattr(m, f"{axis}_splits", None)
        if not splits:
            continue
        for pn, split in splits.items():
            if getattr(m, pn, None) is not None:
                out[f"{mname}.{pn}" if mname else pn] = (split, getattr(m, f"{axis}_size"))
    return out


@torch.no_grad()
def _init_logical(p, kind, split, rank, size):
    """Draw ``p``'s logical tensor (Xavier normal for a weight, zeros for a
    bias) from torch's global generator and keep the rank's shard."""
    if p.is_meta:
        return
    if kind == "bias":
        p.zero_()
        return
    shape = logical_shape(p.shape, split, size)
    fan_in, fan_out = (shape[1], shape[0]) if kind == "linear" else (shape[0], shape[1])
    full = torch.randn(shape) * math.sqrt(2.0 / (fan_in + fan_out))
    p.copy_(mp_slice(full, split, rank, size))


# ------------------------------------------------------------ layers

class VocabParallelEmbedding(nn.Module):
    """The embedding with its vocab rows split over the mp ranks: rank r
    holds rows [r V/mp, (r+1) V/mp), looks up the ids in them (zeros for
    the others) and the ranks' lookups are summed."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None, mp_group=None,
                 name=None):
        super().__init__()
        self.mp_group, self.mp_rank, self.mp_size = mp_info(mp_group)
        if num_embeddings % self.mp_size:
            raise ValueError(f"num_embeddings {num_embeddings} is not divisible by the "
                             f"model-parallel degree {self.mp_size}")
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = num_embeddings // self.mp_size
        self.vocab_start = self.mp_rank * self.per_rank
        self.mp_splits = {"weight": (0, 1)}
        self.weight = nn.Parameter(torch.empty(self.per_rank, embedding_dim))
        _init_logical(self.weight, "embedding", (0, 1), self.mp_rank, self.mp_size)

    def forward(self, ids):
        if self.mp_size == 1:
            return F.embedding(ids, self.weight)
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.per_rank)
        out = F.embedding(local.masked_fill(outside, 0), self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return reduce_from_mp(out, self.mp_group)


class ColumnParallelLinear(nn.Linear):
    """``y = x Wᵀ + b`` with W's output rows (the logical ``[in, out]``
    weight's columns) split over the mp ranks. The input enters through
    ``copy_to_mp``; ``gather_output`` concatenates the ranks' outputs, else
    each rank keeps its slice (the paired row layer consumes it).
    ``mp_blocks`` (the port's): the output is that many equal blocks, each
    split over the ranks (3 for GPT's fused qkv: a rank's output is its
    heads of q, of k and of v)."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 gather_output=True, fuse_matmul_bias=False, mp_group=None, name=None,
                 mp_blocks=1):
        group, rank, size = mp_info(mp_group)
        if out_features % (size * mp_blocks):
            raise ValueError(f"out_features {out_features} is not divisible by the "
                             f"model-parallel degree {size} x {mp_blocks} blocks")
        super().__init__(in_features, out_features // size, bias=has_bias)
        self.mp_group, self.mp_rank, self.mp_size = group, rank, size
        self.gather_output = gather_output
        self.mp_splits = {"weight": (0, mp_blocks), "bias": (0, mp_blocks)}
        self.reset_parameters()

    def reset_parameters(self):
        if not hasattr(self, "mp_splits"):
            return  # nn.Linear's own call, before the shard is known
        _init_logical(self.weight, "linear", self.mp_splits["weight"], self.mp_rank,
                      self.mp_size)
        if self.bias is not None:
            _init_logical(self.bias, "bias", None, self.mp_rank, self.mp_size)

    def forward(self, x):
        if self.mp_size == 1:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(copy_to_mp(x, self.mp_group), self.weight, self.bias)
        return gather_from_mp(out, self.mp_group) if self.gather_output else out


class RowParallelLinear(nn.Linear):
    """``y = x Wᵀ + b`` with W's input columns (the logical ``[in, out]``
    weight's rows) split over the mp ranks: each rank multiplies its slice
    of the input, the partial products are summed (``reduce_from_mp``) and
    the replicated bias is added once. ``input_is_parallel`` false: the
    rank takes its slice of a full input first."""

    def __init__(self, in_features, out_features, weight_attr=None, has_bias=True,
                 input_is_parallel=False, fuse_matmul_bias=False, mp_group=None, name=None):
        group, rank, size = mp_info(mp_group)
        if in_features % size:
            raise ValueError(f"in_features {in_features} is not divisible by the "
                             f"model-parallel degree {size}")
        super().__init__(in_features // size, out_features, bias=has_bias)
        self.mp_group, self.mp_rank, self.mp_size = group, rank, size
        self.input_is_parallel = input_is_parallel
        self.mp_splits = {"weight": (1, 1)}
        self.reset_parameters()

    def reset_parameters(self):
        if not hasattr(self, "mp_splits"):
            return
        _init_logical(self.weight, "linear", (1, 1), self.mp_rank, self.mp_size)
        if self.bias is not None:
            _init_logical(self.bias, "bias", None, self.mp_rank, self.mp_size)

    def forward(self, x):
        if self.mp_size == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = scatter_to_mp(x, self.mp_group)
        out = reduce_from_mp(F.linear(x, self.weight), self.mp_group)
        if self.bias is None:
            return out
        _, bias = cast_inputs("linear", out, self.bias)
        return out + bias


class _VocabParallelCE(torch.autograd.Function):
    """Per-position loss of vocab-sharded f32 logits [N, V/mp]: the row max
    by a MAX all-reduce, the exp-sums and the target logit by SUM
    all-reduces; its own backward (softmax minus the one-hot, on the rank's
    columns). Ignored positions give 0 and no gradient."""

    @staticmethod
    def forward(ctx, logits, labels, start, group, ignore_index):
        n_local = logits.shape[-1]
        row_max = logits.amax(dim=-1)
        collective.all_reduce(row_max, op=collective.ReduceOp.MAX, group=group)
        shifted = logits - row_max[:, None]
        exp = shifted.exp()
        sum_exp = exp.sum(dim=-1)
        ignored = labels == ignore_index
        local = labels - start
        mine = (local >= 0) & (local < n_local) & ~ignored
        idx = local.masked_fill(~mine, 0)
        picked = shifted.gather(-1, idx[:, None])[:, 0].masked_fill(~mine, 0.0)
        both = torch.stack([sum_exp, picked])
        collective.all_reduce(both, group=group)
        sum_exp, picked = both[0], both[1]
        loss = (torch.log(sum_exp) - picked).masked_fill(ignored, 0.0)
        ctx.save_for_backward(exp, sum_exp, idx, mine, ignored)
        return loss

    @staticmethod
    def backward(ctx, g):
        exp, sum_exp, idx, mine, ignored = ctx.saved_tensors
        grad = exp / sum_exp[:, None]
        grad.scatter_add_(-1, idx[:, None], -mine.to(grad.dtype)[:, None])
        grad.mul_((g * ~ignored)[:, None])
        return grad, None, None, None, None


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy of vocab-sharded logits ``[..., V/mp]`` against
    global labels ``[...]`` (or ``[..., 1]``): the per-position loss
    ``[..., 1]`` in f32 (the JAX package's ``softmax_with_cross_entropy``,
    black-listed under amp), 0 at ``ignore_index``. At mp = 1 it is that
    op on the whole vocab."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group, self.mp_rank, self.mp_size = mp_info(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):
        (logits,) = cast_inputs("softmax_with_cross_entropy", input)
        logits = logits.float() if logits.dtype != torch.float32 else logits
        lb = label.to(device=logits.device, dtype=torch.long)
        if lb.dim() == logits.dim():
            lb = lb.squeeze(-1)
        lead = logits.shape[:-1]
        flat, flat_lb = logits.reshape(-1, logits.shape[-1]), lb.reshape(-1)
        if self.mp_size == 1:
            ignored = flat_lb == self.ignore_index
            lsm = torch.log_softmax(flat, dim=-1)
            picked = lsm.gather(-1, flat_lb.masked_fill(ignored, 0)[:, None])[:, 0]
            loss = torch.where(ignored, 0.0, -picked)
        else:
            loss = _VocabParallelCE.apply(flat, flat_lb, self.mp_rank * flat.shape[-1],
                                          self.mp_group, self.ignore_index)
        return loss.reshape(*lead, 1)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True, weight_attr=None,
          bias_attr=None, inner_rank=0):
    """Reference ``paddle.distributed.split`` (collective.py:1520): builds
    the matching parallel layer over the topology's mp group and applies it
    to ``x``. ``size`` is the logical ``[in, out]`` (linear) or ``[vocab,
    dim]`` (embedding)."""
    if operation == "linear":
        if axis == 0:
            layer = RowParallelLinear(size[0], size[1], weight_attr=weight_attr,
                                      has_bias=bias_attr is not False)
        else:
            layer = ColumnParallelLinear(size[0], size[1], weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         gather_output=gather_out)
        return layer.to(x.device)(x)
    if operation == "embedding":
        return VocabParallelEmbedding(size[0], size[1], weight_attr=weight_attr).to(
            x.device)(x)
    raise ValueError(f"unsupported split operation {operation!r}")
