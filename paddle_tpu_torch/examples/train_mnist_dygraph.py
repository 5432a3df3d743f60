"""Dygraph quickstart on the port: LeNet on MNIST, save and load (the
counterpart of the repository's examples/train_mnist_dygraph.py).

    python -m paddle_tpu_torch.examples.train_mnist_dygraph [--device cpu]
        [--size N] [--epochs E] [--fit]

LeNet (weights from seed 0), ``Adam(1e-3)``, ``CrossEntropyLoss``,
``MNIST(mode="train", size=N)`` (the synthetic set when no files are given),
batches of 64 shuffled, E epochs, each epoch's mean loss printed. Then the
state dict is saved, loaded into a fresh LeNet, and that model's accuracy
on one batch printed. ``--fit`` trains the same way through
``hapi.Model.fit`` with ``metric.Accuracy()`` and evaluates on
``mode="test"``. The card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

import paddle_tpu_torch as P
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision.datasets import MNIST
from paddle_tpu_torch.vision.models import LeNet

BATCH = 64
LR = 1e-3


def make_loader(dataset, device, batch_sampler=None, num_workers=0):
    """The example's loader: batches of BATCH, shuffled, unless
    ``batch_sampler`` gives the batches."""
    if batch_sampler is not None:
        return DataLoader(dataset, batch_sampler=batch_sampler, num_workers=num_workers,
                          device=device)
    return DataLoader(dataset, batch_size=BATCH, shuffle=True, num_workers=num_workers,
                      device=device)


def train(model, loader, epochs, batch_losses=None):
    """The eager loop: Adam(LR) and CrossEntropyLoss over ``epochs`` epochs of
    ``loader`` (its batch sampler's ``set_epoch`` called first, where it has
    one). Returns each epoch's mean loss; ``batch_losses``, a list, also
    gets every batch's."""
    opt = optimizer.Adam(learning_rate=LR, parameters=model.named_parameters())
    loss_fn = nn.CrossEntropyLoss()
    model.train()
    means = []
    for epoch in range(epochs):
        sampler = getattr(loader, "batch_sampler", None)
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        losses = []
        for imgs, labels in loader:
            loss = loss_fn(model(imgs), labels.squeeze(-1))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.item()))
        means.append(float(np.mean(losses)))
        if batch_losses is not None:
            batch_losses.extend(losses)
    return means


def batch_accuracy(model, imgs, labels):
    model.eval()
    pred = model(imgs).argmax(-1)
    return float((pred == labels.squeeze(-1)).float().mean().item())


def fit(model, size, epochs):
    """The same training through ``hapi.Model.fit`` with ``Accuracy()``;
    returns (the fit's history, evaluate's logs on ``mode="test"``)."""
    from paddle_tpu_torch.hapi import Model
    from paddle_tpu_torch.metric import Accuracy

    m = Model(model)
    m.prepare(optimizer.Adam(learning_rate=LR, parameters=model.named_parameters()),
              nn.CrossEntropyLoss(), Accuracy())
    history = m.fit(MNIST(mode="train", size=size), batch_size=BATCH, epochs=epochs,
                    shuffle=True, verbose=0)
    logs = m.evaluate(MNIST(mode="test", size=size), batch_size=BATCH, verbose=0)
    return history, logs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--size", type=int, default=512, help="training samples")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--fit", action="store_true", help="train through hapi.Model.fit")
    args = ap.parse_args(argv)
    device = P.resolve_device(args.device)

    model = LeNet(device=device, seed=0)
    if args.fit:
        history, logs = fit(model, args.size, args.epochs)
        for epoch, h in enumerate(history):
            print(f"epoch {epoch}: loss {h['loss']:.4f} acc {h['acc']:.4f}")
        print(f"test: loss {logs['loss']:.4f} acc {logs['acc']:.2%}")
        return 0

    train_loader = make_loader(MNIST(mode="train", size=args.size), device)
    for epoch, loss in enumerate(train(model, train_loader, args.epochs)):
        print(f"epoch {epoch}: loss {loss:.4f}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lenet.pdparams")
        P.save(model.state_dict(), path)
        model2 = LeNet(device=device, seed=1)
        model2.load_state_dict(P.load(path, device=device))
    it = iter(train_loader)
    try:
        imgs, labels = next(it)
    finally:
        it.close()
    print(f"reloaded model batch accuracy: {batch_accuracy(model2, imgs, labels):.2%}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
