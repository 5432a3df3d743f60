"""Starting the ranks: the port's ``spawn`` and its launcher
(``python -m paddle_tpu_torch.distributed.launch``), on the CPU.

Every rank's environment follows paddle_tpu/distributed/env.py's contract
(rank, world, card, rendezvous); a rank that exits non-zero ends the
others and fails ``spawn`` and the launcher (the one deliberate
difference from the JAX package's spawn, which joins without looking);
and the port's bench under a 2-rank launch prints one bench.py line with
``devices`` 2. Each process joins with a deadline.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import torch_dp_workers as W
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.launch.main import _parse_args, child_envs
from paddle_tpu_torch.distributed.spawn import ProcessExitedError

ROOT = Path(__file__).resolve().parents[1]
DEADLINE_S = 120


def test_launcher_child_environment():
    args = _parse_args(["--nproc_per_node", "3", "--devices", "4,5,6",
                        "-m", "pkg.mod", "first", "--flag"])
    assert (args.module, args.training_script) == ("pkg.mod", "first")
    assert args.training_script_args == ["--flag"]
    store = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29123",
             "TORCHELASTIC_USE_AGENT_STORE": "True"}
    envs = child_envs(args, {"PATH": "/bin", "PYTHONPATH": "extra"}, store)
    assert len(envs) == 3
    for rank, env in enumerate(envs):
        assert env["PADDLE_TRAINER_ID"] == str(rank)
        assert env["PADDLE_TRAINERS_NUM"] == "3"
        assert env["PADDLE_LOCAL_RANK"] == str(rank)
        assert env["FLAGS_selected_gpus"] == str(4 + rank)
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("127.0.0.1", "29123")
        assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
        assert env["PYTHONPATH"].split(os.pathsep) == [str(ROOT), "extra"]
        assert "PADDLE_TRAINER_ENDPOINTS" not in env and "PADDLE_CURRENT_ENDPOINT" not in env
        assert env["PATH"] == "/bin"
    # with --master, rank 0 serves the store there: no agent store
    args = _parse_args(["--nproc_per_node", "2", "--master", "10.0.0.1:6000", "train.py"])
    envs = child_envs(args, {"TORCHELASTIC_USE_AGENT_STORE": "True"}, {})
    assert [e["FLAGS_selected_gpus"] for e in envs] == ["0", "1"]
    assert all((e["MASTER_ADDR"], e["MASTER_PORT"]) == ("10.0.0.1", "6000") for e in envs)
    assert all("TORCHELASTIC_USE_AGENT_STORE" not in e for e in envs)


def test_spawn_gives_each_rank_its_environment(tmp_path):
    spawn(W.write_env, args=(str(tmp_path),), nprocs=2, timeout=DEADLINE_S)
    ports = set()
    for rank in range(2):
        env = dict(line.split("=", 1) for line in
                   (tmp_path / f"env{rank}.txt").read_text().splitlines())
        assert env["PADDLE_TRAINER_ID"] == env["PADDLE_LOCAL_RANK"] == str(rank)
        assert env["PADDLE_TRAINERS_NUM"] == "2"
        assert env["FLAGS_selected_gpus"] == str(rank)
        assert env["MASTER_ADDR"] == "127.0.0.1" and int(env["MASTER_PORT"]) > 0
        assert env["TORCHELASTIC_USE_AGENT_STORE"] == "True"
        ports.add(env["MASTER_PORT"])
    assert len(ports) == 1


def test_a_failing_rank_fails_spawn_and_ends_the_others():
    t0 = time.time()
    with pytest.raises(ProcessExitedError) as err:
        spawn(W.fail_on_rank, args=(1, 3), nprocs=2, timeout=DEADLINE_S)
    assert (err.value.rank, err.value.exitcode) == (1, 3)
    assert time.time() - t0 < DEADLINE_S / 2   # rank 0 was ended, not waited for


def test_spawn_ends_ranks_past_its_timeout():
    with pytest.raises(TimeoutError):
        spawn(W.hang, nprocs=2, timeout=5)


def _launch(args, tmp_path, env=None, timeout=DEADLINE_S):
    full = dict(os.environ, OMP_NUM_THREADS="2", **(env or {}))
    full.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch", "--nproc_per_node",
         "2", "--log_dir", str(tmp_path / "log")] + args,
        cwd=str(ROOT), env=full, capture_output=True, text=True, timeout=timeout)


def test_a_failing_rank_fails_the_launcher(tmp_path):
    script = tmp_path / "train.py"
    script.write_text(
        "import os, time\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    print('rank 1 fails'); raise SystemExit(7)\n"
        "time.sleep(600)\n")
    t0 = time.time()
    res = _launch([str(script)], tmp_path)
    assert res.returncode == 7, res.stderr
    assert time.time() - t0 < 60
    assert "rank 1 exited with code 7" in res.stderr and "rank 1 fails" in res.stderr
    assert (tmp_path / "log" / "workerlog.1").exists()


def test_the_bench_under_a_two_rank_launch_prints_one_line(tmp_path):
    res = _launch(["-m", "paddle_tpu_torch.bench"], tmp_path,
                  env={"PADDLE_TPU_BENCH_DEVICE": "cpu", "PADDLE_TPU_BENCH_STEPS": "2",
                       "PADDLE_TPU_BENCH_WINDOWS": "2"})
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    row = json.loads(lines[0])
    assert row["metric"] == "gpt_pretrain_tokens_per_sec_per_chip" and row["value"] > 0
    ex = row["extra"]
    assert ex["devices"] == 2 and ex["batch"] == 8 and ex["platform"] == "cpu"
    assert ex["grad_comm"] == {"dtype": "f32", "error_feedback": False,
                               "zero_update": False, "bytes_per_step": (544256 + 1) * 4}
    # value is per card: the windows' global rate over the world
    assert row["value"] < max(ex["timing"]["window_tokens_per_sec"])
