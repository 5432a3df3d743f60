"""Recommendation models of the parameter-server config (counterpart of
paddle_tpu/models/rec.py): BASELINE config 5, Wide&Deep and DeepFM.

The sparse tables either live on the parameter server (``use_ps=True``:
``DistributedEmbedding``, the trainer holds no rows and pulls them on
forward, pushes their merged gradient on backward) or on the trainer as an
``Embedding`` (one process). The dense tower (the MLP and the output layer)
runs on ``device``: the card unless ``device="cpu"`` is asked for. With the
PS the tables stay in host RAM behind the C++ service and the card does the
dense compute; that split is the design.

``sparse=True`` on a trainer-side table gives a dense gradient, as in the
JAX package. Weights are drawn from ``seed`` in module order on the CPU
(nn/layers/common.py's ``materialize``); models/convert.py carries the JAX
model's weights over (the Linear weights transposed, the embeddings as they
are).
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.ps.layers import DistributedEmbedding
from ..nn.layers import Embedding, LayerList, Linear
from ..nn.layers.common import materialize
from ..ops import nn_functional as F


def _table(vocab, dim, use_ps, table_id, client):
    if use_ps:
        return DistributedEmbedding(table_id, dim, client)
    return Embedding(vocab, dim, sparse=True)


class _SparseFeatures(nn.Module):
    """Embeds ``num_fields`` categorical id fields into [b, fields, dim]."""

    def __init__(self, sparse_feature_dim, embedding_dim, num_fields, use_ps=False,
                 table_id=0, client=None):
        super().__init__()
        self.use_ps = use_ps
        self.num_fields = num_fields
        self.embedding_dim = embedding_dim
        self.emb = _table(sparse_feature_dim, embedding_dim, use_ps, table_id, client)

    def forward(self, sparse_ids):      # [b, fields]
        return self.emb(sparse_ids)     # [b, fields, dim]


def _tower(num_fields, embedding_dim, dense_dim, hidden_sizes):
    sizes = [num_fields * embedding_dim + dense_dim] + list(hidden_sizes)
    mlp = LayerList([Linear(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)])
    return mlp, Linear(hidden_sizes[-1], 1)


def _deep(mlp, out, emb, dense):
    x = torch.cat([emb.reshape(emb.shape[0], -1), dense], dim=1)
    for fc in mlp:
        x = torch.relu(fc(x))
    return out(x)


class WideDeep(nn.Module):
    """Wide (linear over the sparse ids) + Deep (MLP over their embeddings and
    the dense features).

    forward(sparse_ids [b, F] int64, dense [b, D] f32) -> logits [b, 1]
    """

    def __init__(self, sparse_feature_dim=100000, embedding_dim=8, num_fields=26,
                 dense_dim=13, hidden_sizes=(128, 64, 32), use_ps=False,
                 wide_table_id=0, deep_table_id=1, client=None, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.num_fields = num_fields
        with torch.device("meta"):
            # wide part: a scalar weight an id, an embedding of dim 1
            self.wide_emb = _table(sparse_feature_dim, 1, use_ps, wide_table_id, client)
            self.deep_emb = _SparseFeatures(sparse_feature_dim, embedding_dim, num_fields,
                                            use_ps, deep_table_id, client)
            self.mlp, self.out = _tower(num_fields, embedding_dim, dense_dim, hidden_sizes)
        materialize(self, dev, seed)

    def forward(self, sparse_ids, dense):
        wide = self.wide_emb(sparse_ids).sum(dim=1)                  # [b, 1]
        return _deep(self.mlp, self.out, self.deep_emb(sparse_ids), dense) + wide


class DeepFM(nn.Module):
    """Factorization machine (first and second order over the field
    embeddings) + a deep MLP.

    forward(sparse_ids [b, F] int64, dense [b, D] f32) -> logits [b, 1]
    """

    def __init__(self, sparse_feature_dim=100000, embedding_dim=8, num_fields=26,
                 dense_dim=13, hidden_sizes=(128, 64), use_ps=False, first_table_id=0,
                 second_table_id=1, client=None, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        with torch.device("meta"):
            self.first_emb = _table(sparse_feature_dim, 1, use_ps, first_table_id, client)
            self.second_emb = _SparseFeatures(sparse_feature_dim, embedding_dim, num_fields,
                                              use_ps, second_table_id, client)
            self.mlp, self.out = _tower(num_fields, embedding_dim, dense_dim, hidden_sizes)
        materialize(self, dev, seed)

    def forward(self, sparse_ids, dense):
        first = self.first_emb(sparse_ids).sum(dim=1)                # [b, 1]
        emb = self.second_emb(sparse_ids)                            # [b, F, d]
        # second order: 0.5 * ((sum v)^2 - sum v^2), summed over dim
        sum_sq = emb.sum(dim=1).pow(2)
        sq_sum = emb.pow(2).sum(dim=1)
        fm2 = 0.5 * (sum_sq - sq_sum).sum(dim=1, keepdim=True)      # [b, 1]
        return _deep(self.mlp, self.out, emb, dense) + first + fm2


def ctr_loss(logits, label):
    """BCE-with-logits click loss of both CTR models (mean over the batch)."""
    return F.binary_cross_entropy_with_logits(logits, label.to(torch.float32))
