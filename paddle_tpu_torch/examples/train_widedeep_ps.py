"""Wide&Deep in parameter-server mode on the port: C++ sparse tables in host
RAM, the dense tower on the card (the counterpart of the repository's
examples/train_widedeep_ps.py).

Servers host the sharded embedding tables behind the native TCP service
(core/native/ps_table.cc); each trainer pulls the rows of its batch, runs
the dense step on its device and pushes the rows' merged gradient back.

A pod of S servers and T trainers on this host, trainers on card 0:

    python -m paddle_tpu_torch.distributed.launch --run_mode ps \\
        --server_num 2 --trainer_num 2 --devices 0 \\
        paddle_tpu_torch/examples/train_widedeep_ps.py [--save PATH]

Without the launcher's environment it hosts one server in process (the
reference's ps_local_client mode):

    python -m paddle_tpu_torch.examples.train_widedeep_ps [--device cpu]

Each trainer trains WideDeep (vocab 100000, 8 fields, 4 dense features,
weights from seed 0) with Adam(1e-3) on the dense tower for STEPS steps of
one batch of 32 drawn from ``RandomState(trainer id)``, prints each step's
loss and, last, ``LOSSES`` and a JSON list. With ``--save PATH`` trainer 0
saves the tables (``PATH.part<s>`` a server) after every trainer is done.
The card unless ``--device cpu``; a launched trainer takes card
``FLAGS_selected_gpus``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from paddle_tpu_torch import nn, optimizer, resolve_device
from paddle_tpu_torch.distributed.ps import (PSClient, PSServer, SparseTableConfig,
                                             TheOnePSRuntime)
from paddle_tpu_torch.models import WideDeep

TABLES = [
    SparseTableConfig(table_id=0, dim=1, learning_rate=0.1),   # wide
    SparseTableConfig(table_id=1, dim=8, learning_rate=0.1),   # deep
]
VOCAB, FIELDS, DENSE, BATCH, STEPS = 100000, 8, 4, 32, 10


def batch(seed=0):
    """(ids [BATCH, FIELDS] int64, dense [BATCH, DENSE] f32, labels [BATCH, 1]
    f32) from ``RandomState(seed)``, the reference example's draws."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (BATCH, FIELDS)).astype(np.int64)
    dense = rng.rand(BATCH, DENSE).astype(np.float32)
    labels = ((ids.sum(1) % 3 == 0)[:, None]).astype(np.float32)
    return ids, dense, labels


def train(client, device, seed=0):
    """STEPS steps of WideDeep on ``device`` over ``client``'s tables;
    returns the losses."""
    model = WideDeep(sparse_feature_dim=VOCAB, embedding_dim=8, num_fields=FIELDS,
                     dense_dim=DENSE, use_ps=True, client=client, device=device, seed=0)
    opt = optimizer.Adam(learning_rate=1e-3, parameters=model.named_parameters())
    bce = nn.BCEWithLogitsLoss()
    ids, dense, labels = (torch.from_numpy(a).to(device) for a in batch(seed))
    losses = []
    for step in range(STEPS):
        loss = bce(model(ids, dense), labels)
        loss.backward()     # the rows' gradients push to the tables
        opt.step()          # the dense tower updates on the trainer
        opt.clear_grad()
        losses.append(loss.item())
        print(f"step {step}: loss {losses[-1]!r}", flush=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--save", default=None, help="trainer 0 saves the tables here")
    args = ap.parse_args(argv)
    if args.save:
        os.makedirs(os.path.dirname(os.path.abspath(args.save)), exist_ok=True)
    if os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST"):
        # launcher mode: a process of a pod
        runtime = TheOnePSRuntime(sparse_tables=TABLES)
        if runtime.is_server():
            runtime.init_server()
            runtime.run_server()
            return
        device = resolve_device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("FLAGS_selected_gpus", "0")))
        client = runtime.init_worker()
        losses = train(client, device, seed=runtime.trainer_id)
        runtime.barrier_worker(generation=1)
        if args.save and runtime.trainer_id == 0:
            runtime.save_persistables(args.save)
        runtime.stop_worker()
    else:
        # standalone: one server in this process
        device = resolve_device(args.device)
        server = PSServer(0, TABLES, [])
        client = PSClient([f"127.0.0.1:{server.port}"])
        for t in TABLES:
            client.register_table_dim(t.table_id, t.dim)
        try:
            losses = train(client, device)
            if args.save:
                client.save(args.save)
        finally:
            client.close()
            server.stop()
    print("LOSSES " + json.dumps(losses), flush=True)


if __name__ == "__main__":
    main()
