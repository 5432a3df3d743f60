"""TheOnePSRuntime: the role-aware PS bootstrap (counterpart of
paddle_tpu/distributed/ps/runtime.py), with DenseSync, GeoSync and GraphClient.

Reference: python/paddle/distributed/ps/the_one_ps.py:816 — _init_server builds
C++ tables from the program's table configs (:1049), _init_worker creates the
brpc client (:903), run_server blocks, stop_worker tears down, barriers keep
sync-mode trainers aligned. Env contract comes from the launcher's PS controller
(TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST / PADDLE_PORT / PADDLE_PSERVER_ID,
launch/main.py ps mode).

Servers hold the tables in host RAM (service.py); a trainer's parameters
live on its device. DenseSync and GeoSync write what they pull into each
parameter in place, on the parameter's own device, so the optimizer that
holds the parameter object keeps it.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .service import DenseTableConfig, PSClient, PSServer, SparseTableConfig


class TheOnePSRuntime:
    def __init__(self, sparse_tables: Sequence[SparseTableConfig] = (),
                 dense_tables: Sequence[DenseTableConfig] = ()):
        self.sparse_tables = list(sparse_tables)
        self.dense_tables = list(dense_tables)
        self.role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self.server_endpoints = [e for e in os.environ.get(
            "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
        self.trainer_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.trainers_num = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self._server: Optional[PSServer] = None
        self._client: Optional[PSClient] = None
        self._stop_evt = threading.Event()

    def is_server(self) -> bool:
        return self.role == "PSERVER"

    def is_worker(self) -> bool:
        return not self.is_server()

    # ---- server side (the_one_ps.py:1049 _init_server) ----
    def init_server(self) -> PSServer:
        port = int(os.environ.get("PADDLE_PORT", "0"))
        self._server = PSServer(port, self.sparse_tables, self.dense_tables)
        return self._server

    def run_server(self) -> None:
        """Block serving until a client sends stop (reference fleet.run_server)."""
        assert self._server is not None, "call init_server() first"
        while not self._server.stop_requested() and not self._stop_evt.wait(0.2):
            pass
        self._server.stop()

    # ---- worker side (the_one_ps.py:903 _init_worker) ----
    def init_worker(self, model=None) -> PSClient:
        assert self.server_endpoints, \
            "PADDLE_PSERVERS_IP_PORT_LIST is empty — launch with --run_mode ps"
        self._client = PSClient(self.server_endpoints)
        for t in self.sparse_tables + self.dense_tables:
            self._client.register_table_dim(t.table_id, t.dim)
        if model is not None:
            self.bind_model(model)
        return self._client

    def bind_model(self, model) -> None:
        """Wire every DistributedEmbedding sublayer to the PS client."""
        from .layers import DistributedEmbedding

        for layer in model.modules():
            if isinstance(layer, DistributedEmbedding):
                layer.set_client(self._client)

    def barrier_worker(self, generation: int = 0) -> None:
        if self._client is not None and self.trainers_num > 1:
            self._client.barrier(generation, self.trainers_num)

    def stop_worker(self) -> None:
        if self._client is not None and self.trainer_id == 0:
            self._client.stop_servers()

    # ---- persistence (fleet.save_persistables -> table dump, the_one_ps.py) ----
    def save_persistables(self, path: str) -> None:
        assert self._client is not None
        self._client.save(path)

    def load_persistables(self, path: str) -> None:
        assert self._client is not None
        self._client.load(path)


def _host(t) -> np.ndarray:
    """A flat f32 host copy of a tensor on any device."""
    return t.detach().to("cpu", torch.float32).numpy().reshape(-1).copy()


@torch.no_grad()
def _write(p, values: np.ndarray) -> None:
    """Pulled values into ``p`` in place, on ``p``'s device and dtype."""
    p.copy_(torch.from_numpy(values).reshape(p.shape))


class DenseSync:
    """Async/sync dense-parameter flow for PS training: trainer pushes dense
    grads to the server-side optimizer and pulls fresh params back (reference
    Communicator send/recv threads, ps/service/communicator/). For geo-SGD
    (local training + delta aggregation) use GeoSync below."""

    def __init__(self, client: PSClient, params: Dict[int, "object"],
                 pull_interval: int = 1):
        # params: table_id -> Parameter tensor (trainer-side mirror)
        self.client = client
        self.params = params
        self.pull_interval = pull_interval
        self._step = 0
        for tid, p in params.items():
            self.client.register_table_dim(tid, int(np.prod(p.shape)))
            self.client.push_dense_param(tid, _host(p))

    def step(self) -> None:
        """Push this step's dense grads; pull params on the refresh interval."""
        self._step += 1
        for tid, p in self.params.items():
            if p.grad is not None:
                self.client.push_dense(tid, _host(p.grad))
                p.grad = None
        if self._step % self.pull_interval == 0:
            self.pull()

    def pull(self) -> None:
        for tid, p in self.params.items():
            _write(p, self.client.pull_dense(tid))


class GeoSync:
    """Geo-SGD delta aggregation (reference memory_sparse_geo_table.cc +
    GeoCommunicator): each trainer optimizes LOCALLY; every `push_interval`
    steps it pushes `delta = local - base` to the server, which ADDS deltas
    from all trainers into the global parameter; the trainer then pulls the
    merged value and rebases. Unlike DenseSync's grad-push, the server runs
    no optimizer — aggregation is exact addition of locally-optimized
    movement, which is the geo-SGD algorithm (arXiv:1811.11682).
    """

    def __init__(self, client: PSClient, params: Dict[int, "object"],
                 push_interval: int = 4,
                 init_from_server: Optional[bool] = None):
        # params: table_id -> Parameter tensor (trainer-side, optimizer-owned)
        self.client = client
        self.params = params
        self.push_interval = push_interval
        self._step = 0
        self._base: Dict[int, np.ndarray] = {}
        if init_from_server is None:
            # only rank 0 seeds the server; a later-starting trainer that
            # pushed its init unconditionally would WIPE deltas already
            # aggregated by earlier trainers
            init_from_server = int(os.environ.get("PADDLE_TRAINER_ID",
                                                  "0")) != 0
        for tid, p in params.items():
            self.client.register_table_dim(tid, int(np.prod(p.shape)))
            if init_from_server:
                _write(p, self.client.pull_dense(tid))
            else:
                self.client.push_dense_param(tid, _host(p))
            self._base[tid] = _host(p)

    def step(self) -> None:
        """Call AFTER the local optimizer step."""
        self._step += 1
        if self._step % self.push_interval == 0:
            self.sync()

    def sync(self) -> None:
        for tid, p in self.params.items():
            self.client.push_dense_delta(tid, _host(p) - self._base[tid])
            _write(p, self.client.pull_dense(tid))
            self._base[tid] = _host(p)


class GraphClient:
    """High-level GNN graph-store API over the PS graph table (reference
    common_graph_table.cc service surface: add edges, sample neighbors,
    node features, degrees)."""

    def __init__(self, client: PSClient, table_id: int, feat_dim: int = 0):
        self.client = client
        self.table_id = table_id
        self.feat_dim = feat_dim
        if feat_dim:
            client.register_table_dim(table_id, feat_dim)

    def add_edges(self, src, dst, bidirectional: bool = False) -> None:
        self.client.graph_add_edges(self.table_id, np.asarray(src),
                                    np.asarray(dst))
        if bidirectional:
            self.client.graph_add_edges(self.table_id, np.asarray(dst),
                                        np.asarray(src))

    def degree(self, ids) -> np.ndarray:
        return self.client.graph_degree(self.table_id, np.asarray(ids))

    def sample_neighbors(self, ids, k: int, seed: int = 0) -> np.ndarray:
        """[*ids.shape, k] uint64; UINT64_MAX marks neighborless nodes."""
        return self.client.graph_sample_neighbors(self.table_id,
                                                  np.asarray(ids), k, seed)

    def set_node_feat(self, ids, feats) -> None:
        self.client.graph_set_feat(self.table_id, np.asarray(ids),
                                   np.asarray(feats), self.feat_dim or None)

    def get_node_feat(self, ids) -> np.ndarray:
        return self.client.graph_get_feat(self.table_id, np.asarray(ids),
                                          self.feat_dim or None)
