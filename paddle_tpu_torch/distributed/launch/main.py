"""The launcher of the port (counterpart of
paddle_tpu/distributed/launch/main.py, collective mode on one node):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        [--devices 0,1,...] [--master HOST:PORT] [--log_dir DIR] \\
        (-m MODULE | SCRIPT) [ARGS ...]

starts N processes of the script or module, each with the environment of
``env.py``: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` and
``FLAGS_selected_gpus`` (the rank's entry of ``--devices``, else its local
rank). Without ``--master`` the launcher serves the rendezvous store itself
on a free port (the ranks connect to it as clients); with it, rank 0 serves
it at that address.

Rank 0 writes to this process's standard output and error; the others to
``<log_dir>/workerlog.<rank>``. When a rank exits non-zero, the launcher
ends the others, prints the tail of the failed rank's log and exits with
that rank's code; otherwise it exits 0 when all have finished. The JAX
launcher's multi-node rendezvous (and with it the per-rank endpoint
variables), parameter-server mode and elastic restarts are not ported.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from ..spawn import end_processes, host_store


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.distributed.launch",
                                description="paddle_tpu_torch distributed launcher")
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint host:port (rank 0 serves the store)")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", 1)))
    p.add_argument("--devices", default=os.environ.get("PADDLE_DEVICES", ""),
                   help="comma-separated card ordinals handed to the ranks")
    p.add_argument("--log_dir", default=os.environ.get("PADDLE_LOG_DIR", "log"))
    p.add_argument("-m", "--module", default=None,
                   help="run a module (python -m style) instead of a script")
    p.add_argument("training_script", nargs="?", default=None)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.module is None and args.training_script is None:
        p.error("a training script or -m MODULE is required")
    return args


def child_envs(args, base_env, store_env):
    """The environment of each rank (a list, by rank)."""
    n = args.nproc_per_node
    devices = [d for d in args.devices.split(",") if d]
    if args.master:
        addr, port = args.master.rsplit(":", 1)
        store_env = {"MASTER_ADDR": addr, "MASTER_PORT": port}
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    pythonpath = os.pathsep.join(q for q in [pkg_root, base_env.get("PYTHONPATH", "")] if q)
    envs = []
    for rank in range(n):
        env = {k: v for k, v in base_env.items() if k != "TORCHELASTIC_USE_AGENT_STORE"}
        env.update(store_env)
        env.update({
            "PYTHONPATH": pythonpath,
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(n),
            "PADDLE_LOCAL_RANK": str(rank),
            "PADDLE_NNODES": "1",
            "FLAGS_selected_gpus": devices[rank % len(devices)] if devices else str(rank),
        })
        envs.append(env)
    return envs


def _tail(path, n=30):
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def launch(argv=None) -> int:
    args = _parse_args(argv)
    # the store is served by this process for as long as the ranks run
    store, store_env = (None, {}) if args.master else host_store()  # noqa: F841
    cmd = ([sys.executable, "-m", args.module] if args.module
           else [sys.executable, args.training_script])
    if args.module and args.training_script is not None:
        cmd.append(args.training_script)  # the first argument of the module
    cmd += args.training_script_args
    os.makedirs(args.log_dir, exist_ok=True)
    procs, logs = [], []
    for rank, env in enumerate(child_envs(args, dict(os.environ), store_env)):
        if rank == 0:
            log = None
            procs.append(subprocess.Popen(cmd, env=env))
        else:
            log = os.path.join(args.log_dir, f"workerlog.{rank}")
            with open(log, "ab") as f:
                procs.append(subprocess.Popen(cmd, env=env, stdout=f,
                                              stderr=subprocess.STDOUT))
        logs.append(log)
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                end_processes(procs)
                tail = (f"--- tail of {logs[r]} ---\n{_tail(logs[r])}" if logs[r]
                        else "(its output is above)")
                print(f"paddle_tpu_torch.launch: rank {r} exited with code {codes[r]}; "
                      f"the other ranks were ended.\n{tail}", file=sys.stderr, flush=True)
                return codes[r] if codes[r] > 0 else 128 - codes[r]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    except KeyboardInterrupt:
        end_processes(procs)
        return 130


def main():
    sys.exit(launch())
