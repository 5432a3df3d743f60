"""paddle_tpu_torch's CTR models (models/rec.py) against the JAX package's on
the CPU, from the same weights (models/convert.py) and numpy-drawn batches.

- trainer-side tables (vocab 1000, 5 fields, 3 dense features): logits
  within 1e-5, every parameter's gradient within 1e-5 of its largest entry,
  a 5-step Adam run's losses within 1e-5 relative; DeepFM's second-order
  term equals the explicit pairwise sum;
- Wide&Deep on the parameter server (vocab 1000, 4 fields; both tables on a
  fresh server of each package's own library): 10 steps' losses within 1e-5
  relative, the rows of both tables within 1e-6 afterwards;
- the weight conversion's Linear rule picks exactly the Linear weights, by
  class, in GPT, LeNet, ResNet, Wide&Deep and DeepFM;
- the models refuse to run on the CPU unless it is asked for.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group
from paddle_tpu.models import rec as jrec
from paddle_tpu_torch.models import DeepFM, WideDeep, ctr_loss, load_jax_state
from paddle_tpu_torch.models.convert import _is_linear_weight
from paddle_tpu_torch.optimizer import Adam

from torch_numpy_init import numpy_init

torch.set_num_threads(1)

LOGITS_TOL = 1e-5
GRAD_RTOL = 1e-5     # times the largest entry of the JAX gradient
LOSS_RTOL = 1e-5
ROWS_TOL = 1e-6
SMALL = dict(sparse_feature_dim=1000, embedding_dim=8, num_fields=5, dense_dim=3)
CLASSES = {"widedeep": (WideDeep, jrec.WideDeep), "deepfm": (DeepFM, jrec.DeepFM)}


def _pair(kind, **kw):
    port_cls, jax_cls = CLASSES[kind]
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        jm = jax_cls(**kw)
    pm = port_cls(device="cpu", **kw)
    if kw.get("use_ps"):   # the trainer holds no table rows
        assert all("emb" not in n for n, _ in pm.named_parameters())
    return jm, load_jax_state(pm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})


def _batch(rs, n=16, fields=5, dense=3, vocab=1000):
    return (rs.randint(0, vocab, (n, fields)).astype(np.int64),
            rs.rand(n, dense).astype(np.float32),
            rs.randint(0, 2, (n, 1)).astype(np.int64))


def _jax_step(jm, opt, ids, dense, lab):
    loss = jrec.ctr_loss(jm(paddle.to_tensor(ids), paddle.to_tensor(dense)),
                         paddle.to_tensor(lab))
    loss.backward()
    if opt is not None:
        opt.step()
        opt.clear_grad()
    return float(loss)


def _port_step(pm, opt, ids, dense, lab):
    loss = ctr_loss(pm(torch.from_numpy(ids), torch.from_numpy(dense)), torch.from_numpy(lab))
    loss.backward()
    if opt is not None:
        opt.step()
        opt.clear_grad()
    return loss.item()


@pytest.mark.parametrize("kind", ["widedeep", "deepfm"])
def test_logits_and_gradients_match_the_jax_model(kind):
    jm, pm = _pair(kind, **SMALL)
    ids, dense, lab = _batch(np.random.RandomState(0))
    want = np.asarray(jm(paddle.to_tensor(ids), paddle.to_tensor(dense))._data)
    got = pm(torch.from_numpy(ids), torch.from_numpy(dense)).detach().numpy()
    assert got.shape == want.shape == (16, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL)

    _jax_step(jm, None, ids, dense, lab)
    _port_step(pm, None, ids, dense, lab)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    pgrads = dict(pm.named_parameters())
    assert set(jgrads) == set(pgrads)
    for n, g in jgrads.items():
        pg = pgrads[n].grad.numpy()
        pg = pg.T if _is_linear_weight(n) else pg
        assert pg.shape == g.shape, n
        assert np.abs(pg - g).max() <= GRAD_RTOL * np.abs(g).max(), n


@pytest.mark.parametrize("kind", ["widedeep", "deepfm"])
def test_five_adam_steps_match_the_jax_model(kind):
    jm, pm = _pair(kind, **SMALL)
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jm.parameters())
    popt = Adam(learning_rate=1e-2, parameters=pm.named_parameters())
    rs = np.random.RandomState(1)
    for _ in range(5):
        batch = _batch(rs)
        want = _jax_step(jm, jopt, *batch)
        got = _port_step(pm, popt, *batch)
        assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


def test_deepfm_second_order_term_is_the_pairwise_sum():
    net = DeepFM(sparse_feature_dim=50, embedding_dim=4, num_fields=3, dense_dim=2,
                 hidden_sizes=(8,), device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 50, (2, 3)).astype(np.int64))
    emb = net.second_emb(ids).detach().numpy()     # [2, 3, 4]
    ref = np.zeros((2, 1), np.float32)
    for i in range(3):
        for j in range(i + 1, 3):
            ref[:, 0] += (emb[:, i] * emb[:, j]).sum(-1)
    # the model's term: its logit less the first order and the tower
    dense = torch.zeros(2, 2)
    with torch.no_grad():
        tower = net.out(torch.relu(net.mlp[0](torch.cat([net.second_emb(ids).reshape(2, -1),
                                                         dense], 1))))
        fm2 = net(ids, dense) - tower - net.first_emb(ids).sum(1)
    np.testing.assert_allclose(fm2.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_wide_deep_on_the_ps_matches_the_jax_model():
    """10 steps of each package's WideDeep, both tables on a fresh server of
    its own package (the same per-id initial rows), the dense tower from the
    same weights: the same losses and the same table rows after."""
    from paddle_tpu.distributed import ps as jps
    from paddle_tpu_torch.distributed import ps as pps

    kw = dict(sparse_feature_dim=1000, embedding_dim=8, num_fields=4, dense_dim=3,
              use_ps=True)
    runs = {}
    for pkg in ("jax", "port"):
        ps = jps if pkg == "jax" else pps
        tables = [ps.SparseTableConfig(table_id=0, dim=1, learning_rate=0.1),
                  ps.SparseTableConfig(table_id=1, dim=8, learning_rate=0.1)]
        server = ps.PSServer(0, tables, [])
        client = ps.PSClient([f"127.0.0.1:{server.port}"])
        try:
            for t in tables:
                client.register_table_dim(t.table_id, t.dim)
            jm, pm = _pair("widedeep", client=client, **kw)
            rs = np.random.RandomState(2)
            if pkg == "jax":
                opt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jm.parameters())
                losses = [_jax_step(jm, opt, *_batch(rs, fields=4)) for _ in range(10)]
            else:
                opt = Adam(learning_rate=1e-2, parameters=pm.named_parameters())
                losses = [_port_step(pm, opt, *_batch(rs, fields=4)) for _ in range(10)]
            ids = np.arange(1000, dtype=np.uint64)
            runs[pkg] = (losses, client.pull_sparse(0, ids), client.pull_sparse(1, ids))
        finally:
            client.close()
            server.stop()
    (jl, j0, j1), (pl, p0, p1) = runs["jax"], runs["port"]
    for got, want in zip(pl, jl):
        assert abs(got - want) <= LOSS_RTOL * abs(want), (pl, jl)
    np.testing.assert_allclose(p0, j0, rtol=0, atol=ROWS_TOL)
    np.testing.assert_allclose(p1, j1, rtol=0, atol=ROWS_TOL)
    assert not np.allclose(p1, _fresh_rows(pps, 8))   # the steps moved the rows


def _fresh_rows(ps, dim):
    server = ps.PSServer(0, [ps.SparseTableConfig(table_id=1, dim=dim)], [])
    client = ps.PSClient([f"127.0.0.1:{server.port}"])
    try:
        return client.pull_sparse(1, np.arange(1000, dtype=np.uint64), dim)
    finally:
        client.close()
        server.stop()


def _linear_names(model):
    from paddle_tpu_torch.distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                                      RowParallelLinear)
    from paddle_tpu_torch.nn.layers import Linear

    types = (torch.nn.Linear, Linear, ColumnParallelLinear, RowParallelLinear)
    ids = {id(m.weight) for m in model.modules() if isinstance(m, types)}
    return {n for n, p in model.named_parameters() if id(p) in ids}


@pytest.mark.parametrize("kind", ["gpt", "lenet", "resnet18", "widedeep", "deepfm"])
def test_the_linear_rule_picks_the_linear_weights_by_class(kind):
    from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
    from paddle_tpu_torch.vision.models import LeNet, resnet18

    model = {"gpt": lambda: GPTForPretraining(gpt_tiny(), device="cpu"),
             "lenet": lambda: LeNet(device="cpu"),
             "resnet18": lambda: resnet18(num_classes=10, device="cpu"),
             "widedeep": lambda: WideDeep(device="cpu", **SMALL),
             "deepfm": lambda: DeepFM(device="cpu", **SMALL)}[kind]()
    picked = {n for n in model.state_dict() if _is_linear_weight(n)}
    assert picked == _linear_names(model) and picked


def test_the_models_need_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (WideDeep, DeepFM):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(**SMALL)
        assert next(cls(device="cpu", **SMALL).parameters()).device.type == "cpu"
