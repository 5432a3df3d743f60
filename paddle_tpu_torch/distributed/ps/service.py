"""PSServer and PSClient: ctypes bindings over the port's native
``ps_table`` library (counterpart of paddle_tpu/distributed/ps/service.py).

Reference: PSClient::PullSparse/PushSparse (ps/service/ps_client.h:128+),
BrpcPsServer (ps/service/brpc_ps_server.cc). The tables live in host RAM
behind the C++ TCP service (core/native/ps_table.cc, the JAX package's
source byte for byte); the trainer's dense compute runs on the card. That
split is the design: the sparse tables of a CTR model are larger than the
card's memory in production, and the service is what shards them.

The client fans requests out across all server instances: ids are
partitioned by ``id % n_servers``; a dense table lives on server
``table_id % n_servers``. A server of either package answers a client of
either package.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...core.native import load_library

_OPTS = {"sgd": 0, "adagrad": 1, "adam": 2}


_bound = []


def _lib():
    """The ``ps_table`` library with its signatures declared (built on first
    use; raises when g++ is missing or the build fails)."""
    lib = load_library("ps_table")
    if lib in _bound:
        return lib
    lib.ps_server_start.restype = ctypes.c_void_p
    lib.ps_server_start.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.ps_server_add_sparse_table.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int]
    lib.ps_server_add_dense_table.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]
    lib.ps_server_add_graph_table.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int, ctypes.c_int]
    lib.ps_server_sparse_size.restype = ctypes.c_int64
    lib.ps_server_sparse_size.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.ps_server_stop.argtypes = [ctypes.c_void_p]
    lib.ps_server_stop_requested.restype = ctypes.c_int
    lib.ps_server_stop_requested.argtypes = [ctypes.c_void_p]
    lib.ps_client_connect.restype = ctypes.c_void_p
    lib.ps_client_connect.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.ps_client_free.argtypes = [ctypes.c_void_p]
    for name, argtypes in [
        ("ps_pull_sparse", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_int]),
        ("ps_push_sparse", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_void_p, ctypes.c_int]),
        ("ps_pull_dense", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                           ctypes.c_int]),
        ("ps_push_dense", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                           ctypes.c_int]),
        ("ps_push_dense_param", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                 ctypes.c_int]),
        ("ps_push_dense_delta", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                                 ctypes.c_int]),
        ("ps_push_sparse_delta", [ctypes.c_void_p, ctypes.c_uint32,
                                  ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_int]),
        ("ps_graph_add_edges", [ctypes.c_void_p, ctypes.c_uint32,
                                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]),
        ("ps_graph_degree", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_void_p]),
        ("ps_graph_sample", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                             ctypes.c_void_p]),
        ("ps_graph_set_feat", [ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int]),
        ("ps_graph_get_feat", [ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int]),
        ("ps_save", [ctypes.c_void_p, ctypes.c_char_p]),
        ("ps_load", [ctypes.c_void_p, ctypes.c_char_p]),
        ("ps_barrier", [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]),
        ("ps_stop_server", [ctypes.c_void_p]),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    _bound.append(lib)
    return lib


@dataclass
class SparseTableConfig:
    table_id: int
    dim: int
    optimizer: str = "sgd"     # server-side sparse SGD rule (reference sparse_sgd_rule.cc)
    learning_rate: float = 0.01
    initial_range: float = 0.1
    shard_num: int = 8


@dataclass
class DenseTableConfig:
    table_id: int
    dim: int
    optimizer: str = "sgd"
    learning_rate: float = 0.01


@dataclass
class GraphTableConfig:
    """GNN graph store (reference common_graph_table.cc): id-sharded
    adjacency + per-node features behind the PS wire protocol."""
    table_id: int
    feat_dim: int = 0
    shard_num: int = 8


class PSServer:
    """One PS server instance hosting its shard of every configured table."""

    def __init__(self, port: int = 0,
                 sparse_tables: Sequence[SparseTableConfig] = (),
                 dense_tables: Sequence[DenseTableConfig] = (),
                 graph_tables: Sequence[GraphTableConfig] = ()):
        self._lib = _lib()
        got = ctypes.c_int(0)
        self._handle = self._lib.ps_server_start(port, ctypes.byref(got))
        if not self._handle:
            raise RuntimeError(f"PSServer: cannot bind port {port}")
        self.port = got.value
        for t in sparse_tables:
            self.add_sparse_table(t)
        for t in dense_tables:
            self.add_dense_table(t)
        for t in graph_tables:
            self.add_graph_table(t)

    def add_sparse_table(self, cfg: SparseTableConfig):
        self._lib.ps_server_add_sparse_table(
            self._handle, cfg.table_id, cfg.dim, _OPTS[cfg.optimizer],
            cfg.learning_rate, cfg.initial_range, cfg.shard_num)

    def add_dense_table(self, cfg: DenseTableConfig):
        self._lib.ps_server_add_dense_table(
            self._handle, cfg.table_id, cfg.dim, _OPTS[cfg.optimizer],
            cfg.learning_rate)

    def add_graph_table(self, cfg: GraphTableConfig):
        self._lib.ps_server_add_graph_table(
            self._handle, cfg.table_id, cfg.feat_dim, cfg.shard_num)

    def sparse_size(self, table_id: int) -> int:
        return int(self._lib.ps_server_sparse_size(self._handle, table_id))

    def stop_requested(self) -> bool:
        """True once a client sent the stop command (fleet.stop_worker)."""
        return bool(self._handle and
                    self._lib.ps_server_stop_requested(self._handle))

    def stop(self):
        if self._handle:
            self._lib.ps_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class PSClient:
    """Client fanning out over all servers; ids partitioned by id % n_servers."""

    def __init__(self, endpoints: List[str], timeout: float = 60.0):
        self._lib = _lib()
        self._conns = []
        for ep in endpoints:
            host, port = ep.rsplit(":", 1)
            h = self._lib.ps_client_connect(host.encode(), int(port),
                                            int(timeout * 1000))
            if not h:
                raise TimeoutError(f"PSClient: cannot connect to {ep}")
            self._conns.append(h)
        self.n_servers = len(self._conns)
        self._dims: Dict[int, int] = {}

    def register_table_dim(self, table_id: int, dim: int):
        self._dims[table_id] = dim

    def _dim(self, table_id: int, dim: Optional[int]) -> int:
        d = dim or self._dims.get(table_id)
        assert d, f"dim unknown for table {table_id}; call register_table_dim"
        return d

    def _shards(self, ids: np.ndarray):
        """Route ids to their owning server (the ONE partitioning rule:
        id % n_servers). Yields (server_conn, mask, contiguous_ids)."""
        flat = np.ascontiguousarray(ids, dtype=np.uint64).reshape(-1)
        for s in range(self.n_servers):
            mask = (flat % self.n_servers) == s
            if mask.any():
                yield self._conns[s], mask, np.ascontiguousarray(flat[mask])

    # ---- sparse (reference ps_client.h PullSparse/PushSparse) ----
    def pull_sparse(self, table_id: int, ids: np.ndarray,
                    dim: Optional[int] = None) -> np.ndarray:
        d = self._dim(table_id, dim)
        n = int(np.asarray(ids).size)
        out = np.empty((n, d), dtype=np.float32)
        for conn, mask, sub in self._shards(ids):
            rows = np.empty((sub.size, d), dtype=np.float32)
            rc = self._lib.ps_pull_sparse(conn, table_id, sub.ctypes.data,
                                          sub.size, rows.ctypes.data, d)
            if rc != 0:
                raise RuntimeError(f"pull_sparse(table={table_id}) rc={rc}")
            out[mask] = rows
        return out.reshape(*np.asarray(ids).shape, d)

    def push_sparse(self, table_id: int, ids: np.ndarray, grads: np.ndarray,
                    dim: Optional[int] = None) -> None:
        d = self._dim(table_id, dim)
        n = int(np.asarray(ids).size)
        g = np.ascontiguousarray(grads, dtype=np.float32).reshape(n, d)
        for conn, mask, sub in self._shards(ids):
            gsub = np.ascontiguousarray(g[mask])
            rc = self._lib.ps_push_sparse(conn, table_id, sub.ctypes.data,
                                          sub.size, gsub.ctypes.data, d)
            if rc != 0:
                raise RuntimeError(f"push_sparse(table={table_id}) rc={rc}")

    # ---- dense: table lives on server table_id % n ----
    def _dense_conn(self, table_id: int):
        return self._conns[table_id % self.n_servers]

    def pull_dense(self, table_id: int, dim: Optional[int] = None) -> np.ndarray:
        d = self._dim(table_id, dim)
        out = np.empty(d, dtype=np.float32)
        rc = self._lib.ps_pull_dense(self._dense_conn(table_id), table_id,
                                     out.ctypes.data, d)
        if rc != 0:
            raise RuntimeError(f"pull_dense(table={table_id}) rc={rc}")
        return out

    def push_dense(self, table_id: int, grads: np.ndarray) -> None:
        g = np.ascontiguousarray(grads, dtype=np.float32).reshape(-1)
        rc = self._lib.ps_push_dense(self._dense_conn(table_id), table_id,
                                     g.ctypes.data, g.size)
        if rc != 0:
            raise RuntimeError(f"push_dense(table={table_id}) rc={rc}")

    def push_dense_param(self, table_id: int, values: np.ndarray) -> None:
        v = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
        rc = self._lib.ps_push_dense_param(self._dense_conn(table_id), table_id,
                                           v.ctypes.data, v.size)
        if rc != 0:
            raise RuntimeError(f"push_dense_param(table={table_id}) rc={rc}")

    # ---- geo-SGD deltas (reference memory_sparse_geo_table.cc): the server
    # ADDS trainer deltas; aggregation across trainers is the sum ----
    def push_dense_delta(self, table_id: int, delta: np.ndarray) -> None:
        v = np.ascontiguousarray(delta, dtype=np.float32).reshape(-1)
        rc = self._lib.ps_push_dense_delta(self._dense_conn(table_id), table_id,
                                           v.ctypes.data, v.size)
        if rc != 0:
            raise RuntimeError(f"push_dense_delta(table={table_id}) rc={rc}")

    def push_sparse_delta(self, table_id: int, ids: np.ndarray,
                          deltas: np.ndarray,
                          dim: Optional[int] = None) -> None:
        d = self._dim(table_id, dim)
        n = int(np.asarray(ids).size)
        g = np.ascontiguousarray(deltas, dtype=np.float32).reshape(n, d)
        for conn, mask, sub in self._shards(ids):
            gsub = np.ascontiguousarray(g[mask])
            rc = self._lib.ps_push_sparse_delta(conn, table_id,
                                                sub.ctypes.data, sub.size,
                                                gsub.ctypes.data, d)
            if rc != 0:
                raise RuntimeError(
                    f"push_sparse_delta(table={table_id}) rc={rc}")

    # ---- graph (reference common_graph_table.cc): nodes shard by id ----
    def graph_add_edges(self, table_id: int, src: np.ndarray,
                        dst: np.ndarray) -> None:
        d_flat = np.ascontiguousarray(dst, dtype=np.uint64).reshape(-1)
        assert np.asarray(src).size == d_flat.size
        for conn, mask, ss in self._shards(src):  # edges live with their src
            dd = np.ascontiguousarray(d_flat[mask])
            rc = self._lib.ps_graph_add_edges(conn, table_id, ss.ctypes.data,
                                              dd.ctypes.data, ss.size)
            if rc != 0:
                raise RuntimeError(f"graph_add_edges rc={rc}")

    def graph_degree(self, table_id: int, ids: np.ndarray) -> np.ndarray:
        out = np.zeros(int(np.asarray(ids).size), dtype=np.int64)
        for conn, mask, sub in self._shards(ids):
            deg = np.empty(sub.size, dtype=np.int64)
            rc = self._lib.ps_graph_degree(conn, table_id, sub.ctypes.data,
                                           sub.size, deg.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"graph_degree rc={rc}")
            out[mask] = deg
        return out.reshape(np.asarray(ids).shape)

    def graph_sample_neighbors(self, table_id: int, ids: np.ndarray, k: int,
                               seed: int = 0) -> np.ndarray:
        """k uniform samples (with replacement) per id; UINT64_MAX marks
        neighborless nodes."""
        out = np.full((int(np.asarray(ids).size), k),
                      np.iinfo(np.uint64).max, dtype=np.uint64)
        for conn, mask, sub in self._shards(ids):
            smp = np.empty((sub.size, k), dtype=np.uint64)
            rc = self._lib.ps_graph_sample(conn, table_id, sub.ctypes.data,
                                           sub.size, k, seed & 0xFFFFFFFF,
                                           smp.ctypes.data)
            if rc != 0:
                raise RuntimeError(f"graph_sample rc={rc}")
            out[mask] = smp
        return out.reshape(*np.asarray(ids).shape, k)

    def graph_set_feat(self, table_id: int, ids: np.ndarray,
                       feats: np.ndarray, dim: Optional[int] = None) -> None:
        d = self._dim(table_id, dim)
        f = np.ascontiguousarray(feats, dtype=np.float32).reshape(
            int(np.asarray(ids).size), d)
        for conn, mask, sub in self._shards(ids):
            fsub = np.ascontiguousarray(f[mask])
            rc = self._lib.ps_graph_set_feat(conn, table_id, sub.ctypes.data,
                                             sub.size, fsub.ctypes.data, d)
            if rc != 0:
                raise RuntimeError(f"graph_set_feat rc={rc}")

    def graph_get_feat(self, table_id: int, ids: np.ndarray,
                       dim: Optional[int] = None) -> np.ndarray:
        d = self._dim(table_id, dim)
        out = np.zeros((int(np.asarray(ids).size), d), dtype=np.float32)
        for conn, mask, sub in self._shards(ids):
            rows = np.empty((sub.size, d), dtype=np.float32)
            rc = self._lib.ps_graph_get_feat(conn, table_id, sub.ctypes.data,
                                             sub.size, rows.ctypes.data, d)
            if rc != 0:
                raise RuntimeError(f"graph_get_feat rc={rc}")
            out[mask] = rows
        return out.reshape(*np.asarray(ids).shape, d)

    # ---- control ----
    def save(self, path: str) -> None:
        for s, conn in enumerate(self._conns):
            rc = self._lib.ps_save(conn, f"{path}.part{s}".encode())
            if rc != 0:
                raise RuntimeError(f"save rc={rc}")

    def load(self, path: str) -> None:
        for s, conn in enumerate(self._conns):
            rc = self._lib.ps_load(conn, f"{path}.part{s}".encode())
            if rc != 0:
                raise RuntimeError(f"load rc={rc}")

    def barrier(self, generation: int, world: int) -> None:
        rc = self._lib.ps_barrier(self._conns[0], generation, world)
        if rc != 0:
            raise RuntimeError(f"barrier rc={rc}")

    def stop_servers(self) -> None:
        for conn in self._conns:
            self._lib.ps_stop_server(conn)

    def close(self):
        for conn in self._conns:
            self._lib.ps_client_free(conn)
        self._conns = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
