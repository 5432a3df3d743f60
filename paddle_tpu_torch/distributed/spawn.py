"""``spawn``: start one process per rank on this host (counterpart of
paddle_tpu/distributed/spawn.py).

``spawn(func, args, nprocs)`` runs ``func(*args)`` in ``nprocs`` processes
started with the ``spawn`` method (a fresh interpreter each: ``func`` and
``args`` must pickle, and ``func``'s module is imported again in the
child). Each child gets the environment of ``env.py``: its rank, the world
size, its card (``FLAGS_selected_gpus`` = its rank) and the address of a
rendezvous store that this process hosts.

**One deliberate difference from the reference:** the reference's spawn
joins its children without looking at how they ended. Here the join
watches them: when a child exits non-zero, the others are ended and
``spawn`` raises ``ProcessExitedError``; past ``timeout`` seconds every
child is ended and it raises ``TimeoutError``. A rank that fails or hangs
therefore fails the run instead of wedging its peers.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time

import torch
import torch.distributed as dist


class ProcessExitedError(RuntimeError):
    def __init__(self, rank, exitcode):
        super().__init__(f"spawned rank {rank} exited with code {exitcode}")
        self.rank, self.exitcode = rank, exitcode


def host_store():
    """A rendezvous store on a free port of this host, served by this
    process, and the environment that points a rank at it."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    return store, {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(store.port),
                   "TORCHELASTIC_USE_AGENT_STORE": "True"}


def end_processes(procs, grace=5.0):
    """SIGTERM every live process, then SIGKILL those still alive after
    ``grace`` seconds. Works on ``multiprocessing`` and ``subprocess``
    processes alike."""
    alive = [p for p in procs if _exitcode(p) is None]
    for p in alive:
        p.terminate()
    deadline = time.time() + grace
    for p in alive:
        while _exitcode(p) is None and time.time() < deadline:
            time.sleep(0.05)
        if _exitcode(p) is None:
            p.kill()
        p.join() if hasattr(p, "join") else p.wait()


def _exitcode(p):
    return p.exitcode if hasattr(p, "exitcode") else p.poll()


def _worker(func, args, env):
    os.environ.update(env)
    func(*args)


class SpawnContext:
    def __init__(self, procs, store):
        self.processes = procs
        self._store = store  # served for the children's rendezvous

    def join(self, timeout=None):
        """Wait for every child; raise as the module docstring says."""
        deadline = None if timeout is None else time.time() + timeout
        try:
            while True:
                codes = [p.exitcode for p in self.processes]
                for rank, code in enumerate(codes):
                    if code not in (None, 0):
                        raise ProcessExitedError(rank, code)
                if all(c == 0 for c in codes):
                    return True
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(f"spawned ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            end_processes(self.processes)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, timeout=None, **options):
    """Run ``func(*args)`` in ``nprocs`` ranks (-1: one per visible card, or
    one without a card). With ``join`` (the default) wait for them as
    ``SpawnContext.join(timeout)`` does; else return the context."""
    if nprocs in (-1, 0):
        nprocs = max(1, torch.cuda.device_count())
    store, base = host_store()
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(nprocs):
        env = dict(base, PADDLE_TRAINER_ID=str(rank), PADDLE_TRAINERS_NUM=str(nprocs),
                   PADDLE_LOCAL_RANK=str(rank), FLAGS_selected_gpus=str(rank))
        p = ctx.Process(target=_worker, args=(func, args, env), daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, store)
    if join:
        context.join(timeout)
    return context
