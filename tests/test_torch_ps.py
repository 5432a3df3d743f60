"""paddle_tpu_torch's parameter server (distributed/ps/, the native ps_table
library) on the CPU, against the JAX package's.

- The service: the JAX package's tests/test_ps.py and test_ps_geo_graph.py
  cases run on the port (deterministic per-id rows, SGD and Adam on the
  server, sharding by id % 2 across two servers, dense push / pull and
  param set, save / load, a reusable barrier, an unknown table that keeps
  the connection, geo deltas, graph edges, samples and features).
- Across the packages: a port client on a JAX server and a JAX client on a
  port server pull the rows the server's own package pulls; a save written
  by one package loads in the other.
- The lookup layer against the JAX package's, each on a fresh server of its
  own: the rows before and after the backward of a sum, exactly; the id
  that appears twice moves by twice the step; no push under no_grad.
- The launcher's PS mode: the children's environments, and one run of the
  port's Wide&Deep example with 1 server and 2 trainers on the CPU whose
  children import no jax.
- The loader: a missing g++ or a failing build raises, with no fallback.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch.distributed import ps as pps
from paddle_tpu_torch.distributed.ps.runtime import DenseSync

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables(ps):
    sparse = [ps.SparseTableConfig(table_id=0, dim=4, optimizer="sgd", learning_rate=0.5)]
    dense = [ps.DenseTableConfig(table_id=1, dim=6, optimizer="sgd", learning_rate=0.5),
             ps.DenseTableConfig(table_id=2, dim=3, optimizer="adam", learning_rate=0.1)]
    return sparse, dense


def _cluster(ps, n=2):
    sparse, dense = _tables(ps)
    servers = [ps.PSServer(0, sparse, dense) for _ in range(n)]
    client = ps.PSClient([f"127.0.0.1:{s.port}" for s in servers])
    for t in sparse + dense:
        client.register_table_dim(t.table_id, t.dim)
    return servers, client


def _close(servers, *clients):
    for c in clients:
        c.close()
    for s in servers:
        s.stop()


@pytest.fixture()
def cluster():
    """Two port servers and one client (the reference's ps_local_client mode)."""
    servers, client = _cluster(pps)
    yield servers, client
    _close(servers, client)


# ------------------------------------------------------------ the service

def test_sparse_pull_deterministic_init(cluster):
    servers, client = cluster
    ids = np.array([1, 2, 3, 2 ** 40 + 7], dtype=np.uint64)
    rows1 = client.pull_sparse(0, ids)
    np.testing.assert_array_equal(rows1, client.pull_sparse(0, ids))
    assert rows1.shape == (4, 4)
    assert np.abs(rows1).max() <= 0.1  # initial_range
    assert not np.allclose(rows1[0], rows1[1])


def test_sparse_push_applies_sgd(cluster):
    servers, client = cluster
    ids = np.array([10, 11], dtype=np.uint64)
    before = client.pull_sparse(0, ids)
    grads = np.ones((2, 4), dtype=np.float32)
    client.push_sparse(0, ids, grads)
    np.testing.assert_allclose(client.pull_sparse(0, ids), before - 0.5 * grads, rtol=1e-6)


def test_sparse_ids_shard_across_servers(cluster):
    servers, client = cluster
    client.pull_sparse(0, np.arange(100, dtype=np.uint64))
    assert [s.sparse_size(0) for s in servers] == [50, 50]  # id % 2


def test_dense_push_pull_and_param_set(cluster):
    servers, client = cluster
    init = np.arange(6, dtype=np.float32)
    client.push_dense_param(1, init)
    np.testing.assert_array_equal(client.pull_dense(1), init)
    client.push_dense(1, np.ones(6, dtype=np.float32))
    np.testing.assert_allclose(client.pull_dense(1), init - 0.5, rtol=1e-6)


def test_dense_adam_moves_param(cluster):
    servers, client = cluster
    client.push_dense_param(2, np.zeros(3, dtype=np.float32))
    for _ in range(3):
        client.push_dense(2, np.ones(3, dtype=np.float32))
    assert (client.pull_dense(2) < 0).all()


def test_save_load_roundtrip(cluster, tmp_path):
    servers, client = cluster
    ids = np.array([5, 6, 7], dtype=np.uint64)
    grads = np.full((3, 4), 2.0, dtype=np.float32)
    client.push_sparse(0, ids, grads)
    snap, dense_snap = client.pull_sparse(0, ids), client.pull_dense(1)
    client.save(str(tmp_path / "ckpt"))
    client.push_sparse(0, ids, grads)
    client.push_dense(1, np.ones(6, dtype=np.float32))
    client.load(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(client.pull_sparse(0, ids), snap)
    np.testing.assert_array_equal(client.pull_dense(1), dense_snap)


def test_barrier_is_reusable(cluster):
    servers, client = cluster
    client2 = pps.PSClient([f"127.0.0.1:{servers[0].port}"])
    results = []
    try:
        for step in range(3):
            t = threading.Thread(target=lambda: (client2.barrier(7, 2), results.append(step)))
            t.start()
            client.barrier(7, 2)  # through server 0
            t.join(timeout=10)
            assert not t.is_alive(), f"barrier round {step} did not release"
    finally:
        client2.close()
    assert results == [0, 1, 2]


def test_push_to_unknown_table_keeps_connection_usable(cluster):
    servers, client = cluster
    ids = np.array([1, 2], dtype=np.uint64)
    with pytest.raises(RuntimeError, match="rc=-2"):
        client.push_sparse(99, ids, np.ones((2, 4), dtype=np.float32), dim=4)
    assert client.pull_sparse(0, ids).shape == (2, 4)
    with pytest.raises(RuntimeError, match="rc=-2"):
        client.push_dense(99, np.ones(6, dtype=np.float32))
    client.push_dense_param(1, np.zeros(6, dtype=np.float32))
    np.testing.assert_array_equal(client.pull_dense(1), np.zeros(6))


def test_embedding_on_the_ps_trains_a_dense_net(cluster):
    """DistributedEmbedding's rows on the PS, a dense net on the trainer: the
    loss falls (the JAX package's Wide&Deep-style convergence case)."""
    from paddle_tpu_torch import nn, optimizer

    servers, client = cluster
    torch.manual_seed(0)
    emb = pps.DistributedEmbedding(table_id=0, embedding_dim=4, client=client)
    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                        nn.Linear(16, 2, device="cpu"))
    opt = optimizer.Adam(learning_rate=0.01, parameters=net.named_parameters())
    rng = np.random.RandomState(0)
    ids_all = torch.from_numpy(rng.randint(0, 50, (64, 2)).astype(np.int64))
    labels_all = ids_all.sum(1) % 2
    loss_fn = nn.CrossEntropyLoss()
    totals = []
    for _ in range(15):
        total = 0.0
        for i in range(0, 64, 16):
            loss = loss_fn(net(emb(ids_all[i:i + 16]).reshape(16, 8)), labels_all[i:i + 16])
            loss.backward()
            opt.step()
            opt.clear_grad()
            total += loss.item()
        totals.append(total)
    assert totals[-1] < totals[0] * 0.8, totals


def test_dense_sync_flow(cluster):
    """DenseSync pushes the trainer's gradient to the server's optimizer and
    writes the pulled values into the same parameter object."""
    from paddle_tpu_torch.nn.layers import Linear

    servers, client = cluster
    lin = Linear(2, 3, device="cpu")
    w = lin.weight
    sync = DenseSync(client, {1: w}, pull_interval=1)   # table 1: dim 6 == w.numel()
    np.testing.assert_array_equal(client.pull_dense(1).reshape(w.shape), w.detach().numpy())
    before = w.detach().clone()
    lin(torch.ones(4, 2)).sum().backward()
    grad = w.grad.clone()
    sync.step()
    assert lin.weight is w and w.grad is None
    np.testing.assert_allclose(w.detach().numpy(), (before - 0.5 * grad).numpy(), rtol=1e-6)


@pytest.fixture()
def geo():
    dense = [pps.DenseTableConfig(table_id=1, dim=6)]
    sparse = [pps.SparseTableConfig(table_id=0, dim=4, initial_range=0.0)]
    graph = [pps.GraphTableConfig(table_id=7, feat_dim=3)]
    servers = [pps.PSServer(0, sparse, dense, graph) for _ in range(2)]
    clients = [pps.PSClient([f"127.0.0.1:{s.port}" for s in servers]) for _ in range(2)]
    for c in clients:
        c.register_table_dim(0, 4)
        c.register_table_dim(1, 6)
    yield servers, clients
    _close(servers, *clients)


def test_dense_delta_aggregates_across_trainers(geo):
    _, (c1, c2) = geo
    init = np.arange(6, dtype=np.float32)
    c1.push_dense_param(1, init)
    d1 = np.full(6, 0.5, np.float32)
    d2 = np.asarray([1, -1, 2, -2, 3, -3], np.float32)
    c1.push_dense_delta(1, d1)
    c2.push_dense_delta(1, d2)
    np.testing.assert_allclose(c1.pull_dense(1), init + d1 + d2, rtol=1e-6)


def test_sparse_delta_adds_per_id(geo):
    _, (c1, c2) = geo
    ids = np.array([3, 11, 42], np.uint64)
    np.testing.assert_array_equal(c1.pull_sparse(0, ids), 0.0)
    c1.push_sparse_delta(0, ids, np.ones((3, 4), np.float32))
    c2.push_sparse_delta(0, ids[:1], 2 * np.ones((1, 4), np.float32))
    got = c2.pull_sparse(0, ids)
    np.testing.assert_allclose(got[0], 3.0)
    np.testing.assert_allclose(got[1:], 1.0)


def test_geo_sync_two_trainers_converge_to_merged_params(geo):
    """Two GeoSync trainers optimizing locally: after a sync both hold
    init + the sum of their deltas, written into the same parameters."""
    from paddle_tpu_torch.distributed.ps import GeoSync
    from paddle_tpu_torch.optimizer import SGD

    _, (c1, c2) = geo

    def trainer(client):
        p = torch.nn.Parameter(torch.zeros(2, 3))
        return p, SGD(learning_rate=0.1, parameters=[p]), GeoSync(client, {1: p},
                                                                    push_interval=2)

    p1, o1, g1 = trainer(c1)
    p2, o2, g2 = trainer(c2)
    for p, o, g, gr in ((p1, o1, g1, 1.0), (p2, o2, g2, 2.0)):
        for _ in range(2):  # one sync at step 2
            (p * gr).sum().backward()
            o.step()
            o.clear_grad()
            g.step()
    np.testing.assert_allclose(c1.pull_dense(1), -0.6, rtol=1e-5)
    np.testing.assert_allclose(p2.detach().numpy().reshape(-1), -0.6, rtol=1e-5)
    g1.sync()
    np.testing.assert_allclose(p1.detach().numpy().reshape(-1), -0.6, rtol=1e-5)
    assert o1._parameter_list[0] is p1


def test_graph_edges_degree_sample(geo):
    _, (c1, _) = geo
    g = pps.GraphClient(c1, table_id=7, feat_dim=3)
    g.add_edges(np.array([1, 1, 1, 2, 5], np.uint64), np.array([10, 11, 12, 20, 50], np.uint64))
    np.testing.assert_array_equal(g.degree(np.array([1, 2, 5, 9])), [3, 1, 1, 0])
    s = g.sample_neighbors(np.array([1, 2, 9]), k=8, seed=123)
    assert s.shape == (3, 8)
    assert set(s[0]) <= {10, 11, 12} and len(set(s[0])) > 1
    assert set(s[1]) == {20}
    assert (s[2] == np.iinfo(np.uint64).max).all()
    np.testing.assert_array_equal(s, g.sample_neighbors(np.array([1, 2, 9]), k=8, seed=123))


def test_graph_features_roundtrip_and_bidirectional(geo):
    _, (_, c2) = geo
    g = pps.GraphClient(c2, table_id=7, feat_dim=3)
    ids = np.array([100, 200, 300], np.uint64)
    feats = np.arange(9, dtype=np.float32).reshape(3, 3)
    g.set_node_feat(ids, feats)
    np.testing.assert_array_equal(g.get_node_feat(ids), feats)
    np.testing.assert_array_equal(g.get_node_feat(np.array([999])), 0.0)
    g.add_edges([100], [200], bidirectional=True)
    np.testing.assert_array_equal(g.degree(np.array([100, 200])), [1, 1])


def test_graph_save_load_roundtrip(geo, tmp_path):
    servers, (c1, _) = geo
    g = pps.GraphClient(c1, table_id=7, feat_dim=3)
    g.add_edges(np.array([77, 77]), np.array([1, 2]))
    g.set_node_feat(np.array([77]), np.array([[9.0, 8.0, 7.0]], np.float32))
    c1.save(str(tmp_path / "ckpt"))
    graph = [pps.GraphTableConfig(table_id=7, feat_dim=3)]
    fresh = [pps.PSServer(0, (), (), graph) for _ in range(2)]
    c3 = pps.PSClient([f"127.0.0.1:{s.port}" for s in fresh])
    try:
        c3.load(str(tmp_path / "ckpt"))
        g3 = pps.GraphClient(c3, table_id=7, feat_dim=3)
        np.testing.assert_array_equal(g3.degree(np.array([77])), [2])
        np.testing.assert_array_equal(g3.get_node_feat(np.array([77])), [[9.0, 8.0, 7.0]])
    finally:
        _close(fresh, c3)


# ------------------------------------------------------------ across the packages

@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_a_client_of_either_package_reads_a_server_of_the_other(server_pkg):
    """Rows pulled and pushed through the other package's client equal those
    of the server's own client, exactly."""
    own, other = (jps, pps) if server_pkg == "jax" else (pps, jps)
    servers, client = _cluster(own)
    foreign = other.PSClient([f"127.0.0.1:{s.port}" for s in servers])
    try:
        ids = np.array([0, 1, 2, 7, 2 ** 33 + 5, 1001], np.uint64)
        np.testing.assert_array_equal(foreign.pull_sparse(0, ids, 4), client.pull_sparse(0, ids))
        foreign.push_sparse(0, ids[:3], np.full((3, 4), 0.25, np.float32), 4)
        foreign.push_dense_param(1, np.arange(6, dtype=np.float32))
        np.testing.assert_array_equal(client.pull_sparse(0, ids), foreign.pull_sparse(0, ids, 4))
        np.testing.assert_array_equal(client.pull_dense(1), np.arange(6, dtype=np.float32))
        assert [s.sparse_size(0) for s in servers] == [2, 4]   # by id % 2
    finally:
        _close(servers, client, foreign)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_save_of_either_package_loads_in_the_other(writer, tmp_path):
    src, dst = (jps, pps) if writer == "jax" else (pps, jps)
    ids = np.arange(40, dtype=np.uint64)
    servers, client = _cluster(src)
    try:
        client.push_sparse(0, ids, np.linspace(-1, 1, 160, dtype=np.float32).reshape(40, 4))
        client.push_dense_param(1, np.arange(6, dtype=np.float32))
        client.push_dense(2, np.ones(3, np.float32))
        want = (client.pull_sparse(0, ids), client.pull_dense(1), client.pull_dense(2))
        client.save(str(tmp_path / "ckpt"))
    finally:
        _close(servers, client)
    servers, client = _cluster(dst)
    try:
        client.load(str(tmp_path / "ckpt"))
        got = (client.pull_sparse(0, ids), client.pull_dense(1), client.pull_dense(2))
        assert [s.sparse_size(0) for s in servers] == [20, 20]
    finally:
        _close(servers, client)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------ the lookup layer

def test_lookup_layer_matches_the_jax_layer():
    ids = np.array([[1, 2], [2, 3]], dtype=np.int64)
    uniq = np.array([1, 2, 3], dtype=np.uint64)
    runs = {}
    for pkg in ("jax", "port"):
        servers, client = _cluster(jps if pkg == "jax" else pps, n=1)
        try:
            before = client.pull_sparse(0, uniq)
            if pkg == "jax":
                rows = jps.distributed_lookup_table(paddle.to_tensor(ids), client, 0, 4)
                got = np.asarray(rows.numpy())
                rows.sum().backward()
            else:
                with torch.no_grad():
                    pps.distributed_lookup_table(torch.from_numpy(ids), client, 0, 4)
                np.testing.assert_array_equal(client.pull_sparse(0, uniq), before)  # no push
                rows = pps.distributed_lookup_table(torch.from_numpy(ids), client, 0, 4)
                assert rows.is_leaf and rows.requires_grad and tuple(rows.shape) == (2, 2, 4)
                got = rows.detach().numpy()
                rows.sum().backward()
            runs[pkg] = (before, got, client.pull_sparse(0, uniq))
        finally:
            _close(servers, client)
    for j, p in zip(runs["jax"], runs["port"]):
        np.testing.assert_array_equal(p, j)
    before, _, after = runs["port"]
    # d(sum)/d(row) = 1 an occurrence: id 2 appears twice
    counts = np.array([[1], [2], [1]], np.float32)
    np.testing.assert_array_equal(after, before - np.float32(0.5) * counts)


def test_lookup_layer_merges_a_weighted_cotangent_as_the_jax_layer():
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 12, (6, 5)).astype(np.int64)
    w = rng.randn(6, 5, 4).astype(np.float32)
    uniq = np.unique(ids).astype(np.uint64)
    after = {}
    for pkg in ("jax", "port"):
        servers, client = _cluster(jps if pkg == "jax" else pps, n=2)
        try:
            if pkg == "jax":
                rows = jps.distributed_lookup_table(paddle.to_tensor(ids), client, 0, 4)
                (rows * paddle.to_tensor(w)).sum().backward()
            else:
                rows = pps.distributed_lookup_table(torch.from_numpy(ids), client, 0, 4)
                (rows * torch.from_numpy(w)).sum().backward()
            after[pkg] = client.pull_sparse(0, uniq)
        finally:
            _close(servers, client)
    np.testing.assert_array_equal(after["port"], after["jax"])


def test_bind_model_wires_every_distributed_embedding(monkeypatch):
    from paddle_tpu_torch.models import WideDeep

    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "")
    rt = pps.TheOnePSRuntime()
    rt._client = object()
    m = WideDeep(sparse_feature_dim=10, num_fields=2, dense_dim=1, use_ps=True, device="cpu")
    rt.bind_model(m)
    assert m.wide_emb._client is rt._client and m.deep_emb.emb._client is rt._client


# ------------------------------------------------------------ the launcher

def test_ps_mode_environments():
    from paddle_tpu_torch.distributed.launch.main import _parse_args, ps_envs

    args = _parse_args(["--run_mode", "ps", "--server_num", "2", "--trainer_num", "3",
                        "--devices", "0", "train.py", "--x", "1"])
    assert args.training_script_args == ["--x", "1"]
    named = ps_envs(args, {"PATH": "/bin", "PYTHONPATH": "extra"}, [7001, 7002])
    assert [n for n, _ in named] == ["server.0", "server.1", "trainer.0", "trainer.1",
                                     "trainer.2"]
    eps = "127.0.0.1:7001,127.0.0.1:7002"
    for i, (_, env) in enumerate(named[:2]):
        assert (env["TRAINING_ROLE"], env["PADDLE_PORT"], env["PADDLE_PSERVER_ID"],
                env["PADDLE_PSERVERS_IP_PORT_LIST"]) == ("PSERVER", str(7001 + i), str(i), eps)
    for r, (_, env) in enumerate(named[2:]):
        assert env["TRAINING_ROLE"] == "TRAINER" and env["PADDLE_PSERVERS_IP_PORT_LIST"] == eps
        assert (env["PADDLE_TRAINER_ID"], env["PADDLE_TRAINERS_NUM"]) == (str(r), "3")
        assert env["FLAGS_selected_gpus"] == "0" and "PADDLE_PORT" not in env
        assert env["PYTHONPATH"].split(os.pathsep) == [ROOT, "extra"]


def test_the_example_runs_as_a_pod_on_the_cpu(tmp_path):
    """1 server and 2 trainers of the port's example through the launcher on
    the CPU; a ``jax`` that refuses to import sits first on the children's
    path, so a child that imports jax (or paddle_tpu) fails the run."""
    trap = tmp_path / "trap" / "jax"
    trap.mkdir(parents=True)
    (trap / "__init__.py").write_text("raise ImportError('the port imported jax')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path / "trap")
    save = tmp_path / "tables" / "wd"
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--run_mode", "ps",
         "--server_num", "1", "--trainer_num", "2", "--log_dir", str(tmp_path / "log"),
         os.path.join(ROOT, "paddle_tpu_torch", "examples", "train_widedeep_ps.py"),
         "--device", "cpu", "--save", str(save)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    for r in range(2):
        log = (tmp_path / "log" / f"trainer.{r}").read_text()
        assert "LOSSES [" in log, log
    assert (tmp_path / "tables" / "wd.part0.sparse.1").stat().st_size > 0


# ------------------------------------------------------------ the loader

def test_the_loader_raises_without_gpp(monkeypatch, tmp_path):
    from paddle_tpu_torch.core import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library("ps_table")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        pps.PSServer(0)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_loader_raises_with_the_compilers_message(monkeypatch, tmp_path):
    from paddle_tpu_torch.core import native

    (tmp_path / "broken.cc").write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="native broken build failed:(.|\\n)*error"):
        native.load_library("broken")
    assert not list((tmp_path / "build").glob("*"))


def test_the_native_sources_are_the_jax_packages_byte_for_byte():
    from paddle_tpu_torch.core import native

    for name in ("ps_table", "data_feed"):
        with open(os.path.join(ROOT, "paddle_tpu", "core", "native", f"{name}.cc"), "rb") as f:
            assert (native.SRC_DIR / f"{name}.cc").read_bytes() == f.read(), name
        assert native.library_path(name) == native.library_path(name)
        assert native.library_path(name).parent == native.BUILD_DIR
