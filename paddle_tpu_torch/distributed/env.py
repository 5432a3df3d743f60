"""Distributed environment of the port (counterpart of
paddle_tpu/distributed/env.py): one process per GPU on ``torch.distributed``.

The environment contract is the reference's: ``PADDLE_TRAINER_ID`` (rank),
``PADDLE_TRAINERS_NUM`` (world size), ``MASTER_ADDR`` / ``MASTER_PORT``
(the rendezvous store) and ``FLAGS_selected_gpus`` (the rank's card). The
launcher (``python -m paddle_tpu_torch.distributed.launch``) and ``spawn``
set all of them; they host the store themselves and tell the ranks so
through torch's ``TORCHELASTIC_USE_AGENT_STORE``, so no rank binds a port.

The backend follows the device: NCCL on the card, gloo when the caller asks
for the CPU. Every process group gets a timeout, so a rank that dies ends
its peers' collectives with an error instead of a hang.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

#: how long a collective or the rendezvous waits for a missing peer
DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


class ParallelEnv:
    def __init__(self):
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.world_size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.device_id = int(os.environ.get("FLAGS_selected_gpus", "0").split(",")[0])
        self.master_addr = os.environ.get("MASTER_ADDR", "")
        self.master_port = os.environ.get("MASTER_PORT", "")

    @property
    def local_rank(self):
        return int(os.environ.get("PADDLE_LOCAL_RANK", self.rank))

    @property
    def nranks(self):
        return self.world_size

    @property
    def dev_id(self):
        return self.device_id


def init_parallel_env(device=None, timeout=None, init_method=None):
    """Join the process group of this job (once; later calls return the
    environment). ``device``: None (the card ``FLAGS_selected_gpus``, NCCL)
    or "cpu" (gloo). ``init_method`` overrides the environment's rendezvous
    (e.g. ``file://...``). A world of one without a master address gets an
    in-memory store, so its collectives run as the identity."""
    env = ParallelEnv()
    if dist.is_initialized():
        return env
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(env.device_id)
        backend = "nccl"
    else:
        backend = "gloo"
    kw = dict(backend=backend, rank=env.rank, world_size=env.world_size,
              timeout=timeout or DEFAULT_TIMEOUT)
    if init_method is not None:
        dist.init_process_group(init_method=init_method, **kw)
    elif env.master_addr and env.master_port:
        dist.init_process_group(init_method="env://", **kw)
    elif env.world_size == 1:
        dist.init_process_group(store=dist.HashStore(), **kw)
    else:
        raise RuntimeError(
            f"a world of {env.world_size} ranks needs MASTER_ADDR and MASTER_PORT; "
            "start it with `python -m paddle_tpu_torch.distributed.launch` or spawn()")
    return env


def get_rank(group=None):
    if group is not None:
        return group.rank
    return dist.get_rank() if dist.is_initialized() else ParallelEnv().rank


def get_world_size(group=None):
    if group is not None:
        return group.world_size
    return dist.get_world_size() if dist.is_initialized() else ParallelEnv().world_size


def is_initialized():
    return dist.is_initialized()
