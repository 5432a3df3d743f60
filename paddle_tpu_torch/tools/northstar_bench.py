"""BASELINE's single-card benchmarks beyond the GPT step, on the port (the
counterpart of the repository's tools/northstar_bench.py).

    python -m paddle_tpu_torch.tools.northstar_bench [--config all|mnist_dygraph|
        resnet50|widedeep] [--device cpu] [--smoke]

Legs, one JSON line each, with nvidia-smi's card name and power limit
beside the numbers (``card``; "cpu" on the CPU):
  1 mnist_dygraph  LeNet's eager train step (Adam 1e-3, batch 64): ms a step,
                   images/s over 50 steps after 3 warm-up ones
  2 resnet50       ResNet-50 images/s through TrainStepEngine (Momentum 0.1,
                   0.9, weight decay 1e-4; [64, 3, 224, 224], bf16 auto_cast
                   on the card), 20 steps after 2
  5 widedeep       Wide&Deep examples/s with both sparse tables (wide dim 1,
                   deep dim 8, server-side SGD at lr 0.05) on a live
                   PSServer in host RAM (core/native/ps_table.cc) and the
                   dense tower (128, 64, 32; Adam 1e-3) on the card: vocab
                   1,000,000, 26 sparse fields, 13 dense features (the Criteo
                   widths), batch 512, ids, features and labels drawn from
                   RandomState(0) each step; 30 steps after 2. Also the
                   step's shares in pull_sparse and push_sparse (host wall
                   time; the push waits for the backward up to the rows'
                   gradient)

The card unless ``--device cpu``; ``--smoke`` shrinks every leg for a CPU
sanity run.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

WIDEDEEP = dict(vocab=1_000_000, fields=26, dense_dim=13, embedding_dim=8, batch=512,
                steps=30, warmup=2, table_lr=0.05, lr=1e-3)


def _card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    from paddle_tpu_torch.bench import card_name_and_power_limit

    return card_name_and_power_limit()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_mnist_dygraph(smoke: bool, device=None) -> dict:
    from paddle_tpu_torch import nn, optimizer, resolve_device
    from paddle_tpu_torch.vision.models import LeNet

    dev = resolve_device(device)
    model = LeNet(device=dev, seed=0)
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.named_parameters())
    loss_fn = nn.CrossEntropyLoss()
    rs = np.random.RandomState(0)
    batch, steps = 64, (5 if smoke else 50)
    img = torch.from_numpy(rs.rand(batch, 1, 28, 28).astype(np.float32)).to(dev)
    lab = torch.from_numpy(rs.randint(0, 10, (batch,)).astype(np.int64)).to(dev)

    def step():
        loss = loss_fn(model(img), lab)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for _ in range(3):
        step().item()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    final = loss.item()
    dt = time.perf_counter() - t0
    return {"config": "mnist_dygraph", "metric": "eager_step_latency",
            "value": dt / steps * 1e3, "unit": "ms/step", "batch": batch, "steps": steps,
            "imgs_per_sec": steps * batch / dt, "final_loss": final, "card": _card(dev)}


def bench_resnet50(smoke: bool, device=None) -> dict:
    import contextlib

    from paddle_tpu_torch import nn, resolve_device
    from paddle_tpu_torch.amp import auto_cast
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    dev = resolve_device(device)
    model = resnet50(num_classes=1000, device=dev, seed=0)
    opt = Momentum(0.1, momentum=0.9, parameters=model.named_parameters(),
                   weight_decay=1e-4)
    eng = TrainStepEngine(model, opt, loss_fn=nn.CrossEntropyLoss())
    rs = np.random.RandomState(0)
    batch, hw = (4, 32) if smoke else (64, 224)
    steps = 2 if smoke else 20
    img = torch.from_numpy(rs.rand(batch, 3, hw, hw).astype(np.float32)).to(dev)
    lab = torch.from_numpy(rs.randint(0, 1000, (batch,)).astype(np.int64)).to(dev)
    amp = auto_cast(dtype="bfloat16") if dev.type == "cuda" else contextlib.nullcontext()
    with amp:
        for _ in range(2):
            eng.step(img, lab).item()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = eng.step(img, lab)
        final = loss.item()
        dt = time.perf_counter() - t0
    return {"config": "resnet50", "metric": "resnet50_imgs_per_sec_per_chip",
            "value": steps * batch / dt, "unit": "imgs/s/card", "batch": batch, "image": hw,
            "steps": steps, "step_ms": dt / steps * 1e3,
            "amp": "bfloat16 O1" if dev.type == "cuda" else "f32", "final_loss": final,
            "card": _card(dev)}


def bench_widedeep(smoke: bool, device=None, steps=None, warmup=None, check_steps=10,
                   sample=4096, profile=None) -> dict:
    """The widedeep leg. Besides its line's numbers the row holds
    ``losses`` (every step's), and, after ``check_steps`` steps, ``sample_ids``
    (``sample`` of the ids pulled so far, drawn from RandomState(1)) with their
    rows of both tables (``sample_rows``, numpy). ``profile(step)``, when
    given, is called with the step function after the timed steps and its
    dict lands under ``profile``."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.distributed.ps import PSClient, PSServer, SparseTableConfig
    from paddle_tpu_torch.models.rec import WideDeep, ctr_loss
    from paddle_tpu_torch.optimizer import Adam

    w = dict(WIDEDEEP)
    if smoke:
        w.update(vocab=10_000, batch=64, steps=3)
    steps = w["steps"] if steps is None else steps
    warmup = w["warmup"] if warmup is None else warmup
    dev = resolve_device(device)
    sparse = [SparseTableConfig(table_id=0, dim=1, learning_rate=w["table_lr"]),
              SparseTableConfig(table_id=1, dim=w["embedding_dim"],
                                learning_rate=w["table_lr"])]
    server = PSServer(0, sparse, [])
    client = PSClient([f"127.0.0.1:{server.port}"])
    try:
        for t in sparse:
            client.register_table_dim(t.table_id, t.dim)
        host_s = {"pull_sparse": 0.0, "push_sparse": 0.0}

        def timed(name, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    host_s[name] += time.perf_counter() - t
            return call

        client.pull_sparse = timed("pull_sparse", client.pull_sparse)
        client.push_sparse = timed("push_sparse", client.push_sparse)
        net = WideDeep(sparse_feature_dim=w["vocab"], embedding_dim=w["embedding_dim"],
                       num_fields=w["fields"], dense_dim=w["dense_dim"], use_ps=True,
                       wide_table_id=0, deep_table_id=1, client=client, device=dev, seed=0)
        opt = Adam(learning_rate=w["lr"], parameters=net.named_parameters())
        rs = np.random.RandomState(0)
        b, seen, losses, row, excluded = w["batch"], [], [], {}, [0.0]

        def one_step():
            ids = rs.randint(0, w["vocab"], (b, w["fields"])).astype(np.int64)
            dense = rs.rand(b, w["dense_dim"]).astype(np.float32)
            lab = rs.randint(0, 2, (b, 1)).astype(np.int64)
            loss = ctr_loss(net(torch.from_numpy(ids).to(dev), torch.from_numpy(dense).to(dev)),
                            torch.from_numpy(lab).to(dev))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
            if len(losses) <= check_steps:
                seen.append(ids.reshape(-1))
            if len(losses) == check_steps:   # kept out of the timed window
                t_pick, pulled = time.perf_counter(), host_s["pull_sparse"]
                uniq = np.unique(np.concatenate(seen))
                pick = np.sort(np.random.RandomState(1).choice(
                    uniq, min(sample, uniq.size), replace=False)).astype(np.uint64)
                row["sample_ids"] = pick
                row["sample_rows"] = {t.table_id: client.pull_sparse(t.table_id, pick)
                                      for t in sparse}
                host_s["pull_sparse"] = pulled
                excluded[0] += time.perf_counter() - t_pick

        for _ in range(warmup):
            one_step()
        _sync(dev)
        for k in host_s:
            host_s[k] = 0.0
        excluded[0] = 0.0
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        _sync(dev)
        dt = time.perf_counter() - t0 - excluded[0]
        row.update({"config": "widedeep", "metric": "widedeep_examples_per_sec",
                    "value": steps * b / dt, "unit": "examples/s", "batch": b,
                    "steps": steps, "warmup": warmup, "vocab": w["vocab"],
                    "fields": w["fields"], "dense_dim": w["dense_dim"],
                    "ps": "cpp_ps_table", "step_ms": dt / steps * 1e3,
                    "pull_sparse_share": host_s["pull_sparse"] / dt,
                    "push_sparse_share": host_s["push_sparse"] / dt,
                    "table_rows": {t.table_id: server.sparse_size(t.table_id) for t in sparse},
                    "final_loss": losses[-1], "losses": losses, "card": _card(dev)})
        if profile is not None:
            row["profile"] = profile(one_step)
        return row
    finally:
        client.close()
        server.stop()  # the live server must not outlive the leg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="all",
                    choices=("all", "mnist_dygraph", "resnet50", "widedeep"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, few steps")
    args = ap.parse_args(argv)
    benches = {"mnist_dygraph": bench_mnist_dygraph, "resnet50": bench_resnet50,
               "widedeep": bench_widedeep}
    names = list(benches) if args.config == "all" else [args.config]
    for name in names:
        row = benches[name](args.smoke, args.device)
        row = {k: v for k, v in row.items() if not k.startswith("sample_")}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
