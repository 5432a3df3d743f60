"""paddle_tpu_torch's metric, hapi (``Model``, its callbacks, ``summary``,
``flops``) and the MNIST example against the JAX package on the CPU.

The LeNets start from the same weights: the JAX LeNet is built under
``tests/torch_numpy_init.py``'s ``numpy_init`` and its state carried into
the port's by ``models/convert.py``'s ``load_jax_state``. Both packages get
the same batches: a fixed batch sampler, never ``shuffle=True`` (the JAX
``RandomSampler`` seeds from the sampler's ``id``; ROADMAP.md, "Deliberate
differences"). Tolerances: each batch's loss within 1e-5 relative in the
first epoch and 1e-4 after (Adam amplifies f32 rounding step by step);
accuracies and metric counts exactly; logits within 1e-4 x max(1,
max|ref|); ``summary`` and ``flops`` exactly, rows and totals. Torch runs
on one intra-op thread; every loader iterator is closed (``Model`` closes
the ones it opens).
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jio
import paddle_tpu.metric as jmetric
import paddle_tpu_torch as P
import paddle_tpu_torch.io as pio
import paddle_tpu_torch.metric as pmetric
from torch_numpy_init import numpy_init
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.vision.datasets import MNIST as JaxMNIST
from paddle_tpu_torch import hapi
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.examples import train_mnist_dygraph as example
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.models import load_jax_state
from paddle_tpu_torch.vision import models as pvm
from paddle_tpu_torch.vision.datasets import MNIST

torch.set_num_threads(1)
FIRST_RTOL, LATER_RTOL = 1e-5, 1e-4
LOGITS_TOL = 1e-4


# ------------------------------------------------------------ metric

def _logits_labels(n=50, c=6, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(n, c).astype(np.float32), rng.randint(0, c, (n, 1)).astype(np.int64)


def test_accuracy_top_k_matches():
    p, j = pmetric.Accuracy(topk=(1, 3)), jmetric.Accuracy(topk=(1, 3))
    assert p.name() == j.name() == "acc"
    for seed in range(3):
        x, y = _logits_labels(seed=seed)
        pc = p.compute(torch.from_numpy(x), torch.from_numpy(y))
        jc = j.compute(paddle.to_tensor(x), paddle.to_tensor(y))
        np.testing.assert_array_equal(pc, np.asarray(jc))
        assert p.update(pc) == j.update(jc)
    assert p.accumulate() == j.accumulate()
    p.reset()
    assert p.accumulate() == [0.0, 0.0]
    x, y = _logits_labels(seed=9)
    got = pmetric.accuracy(torch.from_numpy(x), torch.from_numpy(y), k=2)
    want = jmetric.accuracy(paddle.to_tensor(x), paddle.to_tensor(y), k=2)
    assert got.dtype == torch.float32 and float(got) == float(want.numpy())


def test_precision_recall_auc_match():
    rng = np.random.RandomState(2)
    pairs = [(pmetric.Precision(), jmetric.Precision()), (pmetric.Recall(), jmetric.Recall()),
             (pmetric.Auc(num_thresholds=255), jmetric.Auc(num_thresholds=255))]
    for _ in range(3):
        prob = rng.rand(40).astype(np.float32)
        lab = rng.randint(0, 2, 40).astype(np.int64)
        two = np.stack([1 - prob, prob], 1)
        for p, j in pairs:
            arg = two if isinstance(p, pmetric.Auc) else prob
            p.update(torch.from_numpy(arg), torch.from_numpy(lab))
            j.update(arg, lab)
    for p, j in pairs:
        assert p.accumulate() == j.accumulate() and p.name() == j.name()
        assert 0.0 < p.accumulate() < 1.0


# ------------------------------------------------------------ summary, flops

def _jax_net(kind):
    set_hybrid_communicate_group(None)
    with numpy_init(0):
        return (paddle.vision.models.LeNet() if kind == "lenet"
                else paddle.vision.models.resnet18(num_classes=10))


def _port_net(kind, jm):
    pm = pvm.LeNet(device="cpu") if kind == "lenet" else pvm.resnet18(num_classes=10,
                                                                      device="cpu")
    return load_jax_state(pm, {k: np.asarray(v._data) for k, v in jm.state_dict().items()})


@pytest.mark.parametrize("kind,shape", [("lenet", (1, 1, 28, 28)), ("resnet18", (1, 3, 32, 32))])
def test_summary_and_flops_match(kind, shape, capsys):
    jm = _jax_net(kind)
    pm = _port_net(kind, jm)
    capsys.readouterr()
    want = paddle.summary(jm, shape)
    want_out = capsys.readouterr().out
    got = P.summary(pm, shape)
    assert got == want and capsys.readouterr().out == want_out
    assert hapi.Model(pm).summary(shape) == want
    capsys.readouterr()
    want_flops = paddle.flops(jm, list(shape), print_detail=True)
    want_out = capsys.readouterr().out
    assert P.flops(pm, list(shape), print_detail=True) == want_flops > 0
    assert capsys.readouterr().out == want_out
    assert pm.training   # summary and flops leave the train flag as it was
    with torch.no_grad():
        assert P.flops(pm, inputs=torch.zeros(shape)) == want_flops


# ------------------------------------------------------------ Model

def _lenet_pair():
    jm = _jax_net("lenet")
    return jm, _port_net("lenet", jm)


def _fixed_batches(n, bs=64, seed=0):
    """The batches of ``DistributedBatchSampler(ds, bs, 1, 0, shuffle=True)``
    at epoch ``seed``, as a fixed list."""
    perm = np.random.RandomState(seed).permutation(n).tolist()
    return [perm[i:i + bs] for i in range(0, n, bs)]


def _loaders(size, batches):
    return (pio.DataLoader(MNIST(mode="train", size=size), batch_sampler=batches,
                           device="cpu", timeout=30),
            jio.DataLoader(JaxMNIST(mode="train", size=size), batch_sampler=batches))


def _recorder(cb_mod):
    class Record(cb_mod.Callback):
        def __init__(self):
            super().__init__()
            self.losses, self.logs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(np.asarray(logs["loss"]).reshape(-1)[0]))
            self.logs.append(dict(logs))
    return Record()


def _losses_close(got, want, per_epoch):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        rtol = FIRST_RTOL if i < per_epoch else LATER_RTOL
        assert abs(g - w) <= rtol * abs(w), (i, g, w)


def _prepare(pm, jm, metrics=True, lr=1e-3):
    pmodel = hapi.Model(pm).prepare(popt.Adam(learning_rate=lr,
                                              parameters=pm.named_parameters()),
                                    pnn.CrossEntropyLoss(),
                                    pmetric.Accuracy() if metrics else None)
    jmodel = JaxModel(jm).prepare(paddle.optimizer.Adam(learning_rate=lr,
                                                        parameters=jm.parameters()),
                                  paddle.nn.CrossEntropyLoss(),
                                  jmetric.Accuracy() if metrics else None)
    return pmodel, jmodel


def test_fit_evaluate_predict_match_the_jax_model():
    jm, pm = _lenet_pair()
    pmodel, jmodel = _prepare(pm, jm)
    batches = _fixed_batches(256)
    ploader, jloader = _loaders(256, batches)
    prec, jrec = _recorder(pcb), _recorder(jcb)
    ph = pmodel.fit(ploader, epochs=2, verbose=0, callbacks=[prec])
    jh = jmodel.fit(jloader, epochs=2, verbose=0, callbacks=[jrec])
    assert pmodel._engine is None and jmodel._engine is None   # metrics: the eager route
    _losses_close(prec.losses, jrec.losses, len(batches))
    assert [r["acc"] for r in prec.logs] == [r["acc"] for r in jrec.logs]
    assert [h["acc"] for h in ph] == [h["acc"] for h in jh]
    assert all(r["reader_cost"] >= 0 and r["batch_size"] == 1 for r in prec.logs)

    pe = pmodel.evaluate(MNIST(mode="test", size=256), batch_size=64, verbose=0)
    je = jmodel.evaluate(JaxMNIST(mode="test", size=256), batch_size=64, verbose=0)
    assert pe.keys() == je.keys() == {"loss", "acc"}
    assert pe["acc"] == je["acc"] > 0.2
    assert abs(pe["loss"] - je["loss"]) <= LATER_RTOL * abs(je["loss"])

    pp = pmodel.predict(MNIST(mode="test", size=256), batch_size=100, stack_outputs=True,
                        verbose=0)
    jp = jmodel.predict(JaxMNIST(mode="test", size=256), batch_size=100, stack_outputs=True,
                        verbose=0)
    assert len(pp) == len(jp) == 1 and pp[0].shape == jp[0].shape == (256, 10)
    err = np.abs(pp[0] - np.asarray(jp[0])).max()
    assert err <= LOGITS_TOL * max(1.0, np.abs(np.asarray(jp[0])).max())
    per_batch = pmodel.predict(MNIST(mode="test", size=256), batch_size=100, verbose=0)
    assert [a.shape[0] for a in per_batch[0]] == [100, 100, 56]


@pytest.mark.parametrize("metrics", [False, True], ids=["engine", "eager"])
def test_accumulation_takes_the_jax_models_route_and_matches_it(metrics):
    """fit(accumulate_grad_batches=2) over 5 batches an epoch (a tail group
    of one): without metrics both packages take the engine route, with
    metrics the eager one (tail gradients flushed); the losses match."""
    jm, pm = _lenet_pair()
    pmodel, jmodel = _prepare(pm, jm, metrics=metrics)
    batches = _fixed_batches(320)
    ploader, jloader = _loaders(320, batches)
    prec, jrec = _recorder(pcb), _recorder(jcb)
    pmodel.fit(ploader, epochs=2, verbose=0, callbacks=[prec], accumulate_grad_batches=2)
    jmodel.fit(jloader, epochs=2, verbose=0, callbacks=[jrec], accumulate_grad_batches=2)
    assert (pmodel._engine is None) == (jmodel._engine is None) == metrics
    n = len(prec.losses) // 2
    assert len(prec.losses) == (10 if metrics else 6)
    _losses_close(prec.losses, jrec.losses, n)
    if not metrics:
        # the network holds the engine's weights after the fit
        for name, p in pm.named_parameters():
            assert torch.equal(p, pmodel._engine.params[name]), name


def test_the_engine_route_rule_and_no_swallowed_error(monkeypatch):
    jm, pm = _lenet_pair()
    part = popt.Adam(parameters=list(pm.features.named_parameters()))
    assert "not one of the optimizer's" in hapi.model.engine_route_refusal(pm, part, [])
    assert hapi.model.engine_route_refusal(pm, None, []) == "no optimizer is configured"
    model = hapi.Model(pm).prepare(part, pnn.CrossEntropyLoss())
    loader = _loaders(128, _fixed_batches(128))[0]
    model.fit(loader, epochs=1, verbose=0, accumulate_grad_batches=2)
    assert model._engine is None   # the eager route, by the rule

    from paddle_tpu_torch.distributed import TrainStepEngine

    def broken(self, *batch):
        raise RuntimeError("engine step failed")

    monkeypatch.setattr(TrainStepEngine, "step", broken)
    model = hapi.Model(pm).prepare(popt.Adam(parameters=pm.named_parameters()),
                                   pnn.CrossEntropyLoss())
    with pytest.raises(RuntimeError, match="engine step failed"):
        model.fit(loader, epochs=1, verbose=0, accumulate_grad_batches=2)


def test_fit_over_a_dataset_and_a_list_of_batches():
    _, pm = _lenet_pair()
    model = hapi.Model(pm).prepare(popt.Adam(parameters=pm.named_parameters()),
                                   pnn.CrossEntropyLoss(), pmetric.Accuracy())
    h = model.fit(MNIST(size=128), eval_data=MNIST(mode="test", size=128), batch_size=32,
                  epochs=2, verbose=0, num_workers=2)
    assert len(h) == 2 and {"loss", "acc", "eval_loss", "eval_acc"} <= h[0].keys()
    ds = MNIST(size=64)
    batches = [[np.stack([ds[i][0] for i in range(k, k + 16)]),
                np.stack([ds[i][1] for i in range(k, k + 16)])] for k in (0, 16, 32)]
    h = model.fit((b for b in batches), epochs=2, verbose=0, num_iters=2)
    assert len(h) == 2 and np.isfinite(h[-1]["loss"])


# ------------------------------------------------------------ callbacks

def test_callbacks_match_the_jax_packages(tmp_path, monkeypatch, capsys):
    """ProgBarLogger's lines (timings aside), ModelCheckpoint's files,
    LRScheduler stepping a StepDecay, EarlyStopping, VisualDL's scalars and
    the TelemetryCallback attached by PADDLE_TPU_TELEMETRY_DIR."""
    jm, pm = _lenet_pair()
    psched = popt.lr.StepDecay(learning_rate=1e-3, step_size=2, gamma=0.5)
    jsched = paddle.optimizer.lr.StepDecay(learning_rate=1e-3, step_size=2, gamma=0.5)
    pmodel = hapi.Model(pm).prepare(popt.Adam(learning_rate=psched,
                                              parameters=pm.named_parameters()),
                                    pnn.CrossEntropyLoss(), pmetric.Accuracy())
    jmodel = JaxModel(jm).prepare(paddle.optimizer.Adam(learning_rate=jsched,
                                                        parameters=jm.parameters()),
                                  paddle.nn.CrossEntropyLoss(), jmetric.Accuracy())
    batches = _fixed_batches(128, bs=32)
    ploader, jloader = _loaders(128, batches)
    out = {}
    for name, model, loader, cb, ds in (
            ("p", pmodel, ploader, pcb, MNIST(mode="test", size=64)),
            ("j", jmodel, jloader, jcb, JaxMNIST(mode="test", size=64))):
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY_DIR", str(tmp_path / name / "tele"))
        stop = cb.EarlyStopping(monitor="acc", mode="max", patience=0, verbose=0)
        capsys.readouterr()
        model.fit(loader, eval_data=ds, batch_size=32, epochs=4, verbose=2, log_freq=2,
                  save_dir=str(tmp_path / name / "ckpt"),
                  callbacks=[stop, cb.VisualDL(str(tmp_path / name / "vdl"))])
        printed = [line.rsplit(" - ", 1)[0] for line in capsys.readouterr().out.splitlines()
                   if not line.startswith("Eval samples")]
        with open(tmp_path / name / "vdl" / "scalars.jsonl") as f:
            scalars = [json.loads(line) for line in f]
        with open(tmp_path / name / "tele" / "fit_telemetry.jsonl") as f:
            tele = [json.loads(line) for line in f]
        out[name] = dict(printed=printed, scalars=scalars, tele=tele,
                         files=sorted(os.listdir(tmp_path / name / "ckpt")),
                         stopped=(model.stop_training, stop.stopped_epoch),
                         lr=model._optimizer.get_lr())
    p, j = out["p"], out["j"]
    assert p["files"] == j["files"] and "final.pdparams" in p["files"]
    assert p["stopped"] == j["stopped"] and p["lr"] == j["lr"]
    assert [s["tag"] for s in p["scalars"]] == [s["tag"] for s in j["scalars"]]
    assert [s.get("acc") for s in p["scalars"]] == [s.get("acc") for s in j["scalars"]]
    assert len(p["tele"]) == len(j["tele"]) == sum(s["tag"] == "train" for s in p["scalars"])
    _losses_close([r["loss"] for r in p["tele"]], [r["loss"] for r in j["tele"]],
                  len(batches))
    assert len(p["printed"]) == len(j["printed"]) > 0
    for a, b in zip(p["printed"], j["printed"]):
        if "loss:" not in a:
            assert a == b


def test_save_and_load_round_trip(tmp_path):
    """Model.save writes the network's and the optimizer's state dicts
    (framework/io.py's files, the port's layout: a Linear weight [out, in]);
    Model.load into a fresh network gives the same logits bit for bit and
    the optimizer's state."""
    _, pm = _lenet_pair()
    pmodel = hapi.Model(pm).prepare(popt.Adam(parameters=pm.named_parameters()),
                                    pnn.CrossEntropyLoss())
    pmodel.fit(_loaders(128, _fixed_batches(128))[0], epochs=1, verbose=0)
    pmodel.save(str(tmp_path / "p"))
    assert sorted(os.listdir(tmp_path)) == ["p.pdopt", "p.pdparams"]
    x = np.random.RandomState(5).rand(4, 1, 28, 28).astype(np.float32)
    want = pmodel.predict_batch([x])[0]
    fresh = pvm.LeNet(device="cpu", seed=3)
    fmodel = hapi.Model(fresh).prepare(popt.Adam(parameters=fresh.named_parameters()))
    fmodel.load(str(tmp_path / "p"))
    np.testing.assert_array_equal(fmodel.predict_batch([x])[0], want)
    assert fmodel._optimizer._step_count == pmodel._optimizer._step_count == 2
    for n, s in fmodel._optimizer._states.items():
        for a, b in zip(s, pmodel._optimizer._states[n]):
            assert torch.equal(a, b), n
    fmodel.save(str(tmp_path / "q"), training=False)
    assert not os.path.exists(tmp_path / "q.pdopt")


# ------------------------------------------------------------ the example

def _jax_example_losses(jm, size, epochs):
    """The JAX example's loop (examples/train_mnist_dygraph.py) on the
    batches of DistributedBatchSampler(ds, 64, 1, 0, shuffle=True) with
    set_epoch(epoch)."""
    ds = JaxMNIST(mode="train", size=size)
    sampler = jio.DistributedBatchSampler(ds, 64, num_replicas=1, rank=0, shuffle=True)
    loader = jio.DataLoader(ds, batch_sampler=sampler)
    opt = paddle.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    means = []
    for epoch in range(epochs):
        sampler.set_epoch(epoch)
        losses = []
        for imgs, labels in loader:
            loss = loss_fn(jm(imgs), labels.squeeze(-1))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.item()))
        means.append(float(np.mean(losses)))
    return means


def test_the_example_loop_matches_the_jax_example():
    jm, pm = _lenet_pair()
    ds = MNIST(mode="train", size=256)
    sampler = pio.DistributedBatchSampler(ds, example.BATCH, num_replicas=1, rank=0,
                                          shuffle=True)
    got = example.train(pm, example.make_loader(ds, "cpu", sampler, num_workers=2), 2)
    want = _jax_example_losses(jm, 256, 2)
    assert abs(got[0] - want[0]) <= FIRST_RTOL * want[0]
    assert abs(got[1] - want[1]) <= LATER_RTOL * want[1]
    assert got[1] < got[0]


def test_the_example_runs_on_the_cpu(capsys):
    assert example.main(["--device", "cpu", "--size", "128", "--epochs", "2"]) == 0
    out = capsys.readouterr().out
    assert out.count("epoch ") == 2 and "reloaded model batch accuracy" in out
    assert example.main(["--device", "cpu", "--size", "128", "--epochs", "1", "--fit"]) == 0
    assert "test: loss" in capsys.readouterr().out
