"""PS-backed layers: the distributed embedding lookup that pushes on backward
(counterpart of paddle_tpu/distributed/ps/layers.py).

Reference: operators/pscore/distributed_lookup_table_op.cc (a trainer-side
op whose forward pulls rows from the PS and whose grad op pushes row
gradients back) and ``paddle.static.nn.sparse_embedding``. The table is not
a trainer parameter: its rows live in host RAM on the servers, the trainer
pulls the rows a batch needs over the host's network and hands them to the
model's device with one copy; the dense compute runs there. That split is
the design, not a fallback.

PyTorch runs no backward for a graph node without an input that requires
grad, so the pulled rows are a leaf that requires grad, with a hook that
pushes: on backward the rows' gradient comes to the host in one copy, its
duplicate ids are merged in the JAX package's order (``np.unique`` then
``np.add.at``: the same sums, bit for bit, on the same cotangents) and the
merged rows go to the server-side optimizer. Under ``torch.no_grad()``
nothing is pushed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _merge_and_push(client, table_id, dim, ids_np, grad):
    g = grad.detach().to("cpu", torch.float32).numpy()
    flat_ids = ids_np.reshape(-1)
    flat_g = g.reshape(flat_ids.size, dim)
    uniq, inv = np.unique(flat_ids, return_inverse=True)
    merged = np.zeros((uniq.size, dim), dtype=np.float32)
    np.add.at(merged, inv.reshape(-1), flat_g)
    client.push_sparse(table_id, uniq, merged, dim)


def distributed_lookup_table(ids: torch.Tensor, client, table_id: int,
                             dim: int) -> torch.Tensor:
    """Rows ``[*ids.shape, dim]`` of ``table_id`` for ``ids``, pulled from the
    PS onto ``ids``' device; with grad enabled their gradient is merged per
    id and pushed back on backward."""
    ids_np = np.asarray(ids.detach().cpu().numpy(), dtype=np.uint64)
    rows = torch.from_numpy(client.pull_sparse(table_id, ids_np, dim).astype(np.float32))
    rows = rows.to(ids.device)
    if torch.is_grad_enabled():
        rows.requires_grad_(True)
        rows.register_hook(
            lambda grad: _merge_and_push(client, table_id, dim, ids_np, grad))
    return rows


class DistributedEmbedding(nn.Module):
    """Embedding whose table lives on the parameter server (reference
    ``sparse_embedding``); the trainer holds no rows of it."""

    def __init__(self, table_id: int, embedding_dim: int, client=None):
        super().__init__()
        self.table_id = table_id
        self.embedding_dim = embedding_dim
        self._client = client

    def set_client(self, client):
        self._client = client

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self._client is None:
            raise RuntimeError("DistributedEmbedding needs a PSClient "
                               "(TheOnePSRuntime.init_worker or bind_model wires it)")
        return distributed_lookup_table(ids, self._client, self.table_id,
                                        self.embedding_dim)

    def extra_repr(self):
        return f"table_id={self.table_id}, embedding_dim={self.embedding_dim}"
