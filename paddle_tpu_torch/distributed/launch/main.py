"""The launcher of the port (counterpart of
paddle_tpu/distributed/launch/main.py), on one node, in two modes.

Collective mode (the default):

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        [--devices 0,1,...] [--master HOST:PORT] [--log_dir DIR] \\
        (-m MODULE | SCRIPT) [ARGS ...]

starts N processes of the script or module, each with the environment of
``env.py``: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` and
``FLAGS_selected_gpus`` (the rank's entry of ``--devices``, else its local
rank). Without ``--master`` the launcher serves the rendezvous store itself
on a free port (the ranks connect to it as clients); with it, rank 0 serves
it at that address. Rank 0 writes to this process's standard output and
error; the others to ``<log_dir>/workerlog.<rank>``.

Parameter-server mode (the reference's PS controller, launch/main.py
``--run_mode ps``):

    python -m paddle_tpu_torch.distributed.launch --run_mode ps \\
        --server_num S --trainer_num T [--devices ...] [--log_dir DIR] \\
        (-m MODULE | SCRIPT) [ARGS ...]

starts S servers and T trainers of the same script, each on a free port of
127.0.0.1 for the servers (``ps_envs``). Servers get ``TRAINING_ROLE=PSERVER``,
``PADDLE_PORT``, ``PADDLE_PSERVER_ID`` and ``PADDLE_PSERVERS_IP_PORT_LIST``;
trainers get ``TRAINING_ROLE=TRAINER``, the list, ``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM`` and ``FLAGS_selected_gpus`` (as in collective mode:
T trainers may share one card). distributed/ps/runtime.py's
``TheOnePSRuntime`` reads this contract. Every process writes to
``<log_dir>/server.<i>`` or ``<log_dir>/trainer.<i>``.

In both modes, when a process exits non-zero the launcher ends the others,
prints the tail of the failed process's log and exits with its code;
otherwise it exits 0 when all have finished. The JAX launcher's multi-node
rendezvous (and with it the per-rank endpoint variables and multi-node PS
endpoints) and elastic restarts are not ported.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

from ..spawn import end_processes, host_store


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.distributed.launch",
                                description="paddle_tpu_torch distributed launcher",
                                allow_abbrev=False)
    p.add_argument("--master", default=None,
                   help="rendezvous endpoint host:port (rank 0 serves the store)")
    p.add_argument("--nproc_per_node", type=int,
                   default=int(os.environ.get("PADDLE_NPROC_PER_NODE", 1)))
    p.add_argument("--devices", default=os.environ.get("PADDLE_DEVICES", ""),
                   help="comma-separated card ordinals handed to the ranks")
    p.add_argument("--log_dir", default=os.environ.get("PADDLE_LOG_DIR", "log"))
    p.add_argument("--run_mode", default="collective", choices=["collective", "ps"])
    p.add_argument("--server_num", type=int, default=1, help="PS mode: servers")
    p.add_argument("--trainer_num", type=int, default=1, help="PS mode: trainers")
    p.add_argument("-m", "--module", default=None,
                   help="run a module (python -m style) instead of a script")
    p.add_argument("training_script", nargs="?", default=None)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    if args.module is None and args.training_script is None:
        p.error("a training script or -m MODULE is required")
    return args


def _trainer_env(args, base_env, rank, n):
    """A trainer's (a rank's) environment: the package on PYTHONPATH, its
    rank and count, and its card."""
    devices = [d for d in args.devices.split(",") if d]
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    pythonpath = os.pathsep.join(q for q in [pkg_root, base_env.get("PYTHONPATH", "")] if q)
    env = {k: v for k, v in base_env.items() if k != "TORCHELASTIC_USE_AGENT_STORE"}
    env.update({
        "PYTHONPATH": pythonpath,
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(n),
        "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_NNODES": "1",
        "FLAGS_selected_gpus": devices[rank % len(devices)] if devices else str(rank),
    })
    return env


def child_envs(args, base_env, store_env):
    """The environment of each rank (a list, by rank)."""
    n = args.nproc_per_node
    if args.master:
        addr, port = args.master.rsplit(":", 1)
        store_env = {"MASTER_ADDR": addr, "MASTER_PORT": port}
    envs = []
    for rank in range(n):
        env = _trainer_env(args, base_env, rank, n)
        env.update(store_env)
        envs.append(env)
    return envs


def ps_envs(args, base_env, server_ports):
    """PS mode: [(log name, environment)] of the servers (one a port of
    ``server_ports``), then of the ``args.trainer_num`` trainers."""
    eps = ",".join(f"127.0.0.1:{p}" for p in server_ports)
    out = []
    for i, port in enumerate(server_ports):
        env = _trainer_env(args, base_env, 0, args.trainer_num)
        env.update({"TRAINING_ROLE": "PSERVER", "PADDLE_PORT": str(port),
                    "PADDLE_PSERVER_ID": str(i), "PADDLE_PSERVERS_IP_PORT_LIST": eps})
        out.append((f"server.{i}", env))
    for rank in range(args.trainer_num):
        env = _trainer_env(args, base_env, rank, args.trainer_num)
        env.update({"TRAINING_ROLE": "TRAINER", "PADDLE_PSERVERS_IP_PORT_LIST": eps})
        out.append((f"trainer.{rank}", env))
    return out


def _free_ports(n):
    """``n`` distinct free ports of 127.0.0.1 (held open until all are
    picked, so no two are the same)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _tail(path, n=30):
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-n:])
    except OSError:
        return "<no log>"


def _children(args, cmd):
    """Start the processes of ``args``' mode: ([(process, name, log path or
    None)], the rendezvous store this process serves or None)."""
    os.makedirs(args.log_dir, exist_ok=True)
    store = None
    if args.run_mode == "ps":
        named = ps_envs(args, dict(os.environ), _free_ports(args.server_num))
    else:
        # the store is served by this process for as long as the ranks run
        store, store_env = (None, {}) if args.master else host_store()
        named = [(f"workerlog.{rank}", env)
                 for rank, env in enumerate(child_envs(args, dict(os.environ), store_env))]
    out = []
    for i, (name, env) in enumerate(named):
        if args.run_mode != "ps" and i == 0:
            out.append((subprocess.Popen(cmd, env=env), "rank 0", None))
            continue
        log = os.path.join(args.log_dir, name)
        with open(log, "ab") as f:
            out.append((subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT),
                        name if args.run_mode == "ps" else f"rank {i}", log))
    return out, store


def launch(argv=None) -> int:
    args = _parse_args(argv)
    cmd = ([sys.executable, "-m", args.module] if args.module
           else [sys.executable, args.training_script])
    if args.module and args.training_script is not None:
        cmd.append(args.training_script)  # the first argument of the module
    cmd += args.training_script_args
    children, store = _children(args, cmd)  # noqa: F841 (the store lives as long)
    procs, names, logs = (list(c) for c in zip(*children))
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                end_processes(procs)
                tail = (f"--- tail of {logs[r]} ---\n{_tail(logs[r])}" if logs[r]
                        else "(its output is above)")
                print(f"paddle_tpu_torch.launch: {names[r]} exited with code {codes[r]}; "
                      f"the others were ended.\n{tail}", file=sys.stderr, flush=True)
                return codes[r] if codes[r] > 0 else 128 - codes[r]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    except KeyboardInterrupt:
        end_processes(procs)
        return 130


def main():
    sys.exit(launch())
