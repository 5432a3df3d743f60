"""The port's bench (paddle_tpu_torch/bench.py) against the repository's
bench.py: the window helpers and the FLOPs accounting equal bench.py's and
the JAX package's, and ``main()`` on the CPU prints one parseable line.
bench.py's module scope imports only numpy, so it is imported here as is.
"""
import json

import pytest
import torch

import bench as jax_bench
from paddle_tpu.observability.flops import \
    transformer_flops_per_token as jax_flops
from paddle_tpu_torch import bench
from paddle_tpu_torch.observability import (peak_flops_per_sec,
                                            transformer_flops_per_token)


@pytest.mark.parametrize("steps", [1, 2, 3, 5, 10, 20, 23])
@pytest.mark.parametrize("n_windows", [0, 1, 2, 3, 4, 7, 30])
def test_window_plan_equals_bench_py(steps, n_windows):
    assert bench._window_plan(steps, n_windows) == jax_bench._window_plan(steps, n_windows)
    assert sum(bench._window_plan(steps, n_windows)) == steps


@pytest.mark.parametrize("dts", [
    [], [(0.5, 3)], [(0.5, 3), (0.4, 3), (0.6, 4)], [(1.0, 0), (0.0, 2), (0.3, 1)],
    [(0.123456, 7), (0.111111, 7)], [(2.5, 10), (2.4, 10), (2.6, 10), (3.1, 10)]])
@pytest.mark.parametrize("batch,seq", [(8, 1024), (1, 7)])
def test_window_stats_equal_bench_py(dts, batch, seq):
    assert bench._window_stats(dts, batch, seq) == jax_bench._window_stats(dts, batch, seq)


@pytest.mark.parametrize("name", ["base", "medium"])
def test_bench_config_equals_bench_py(name):
    mine, theirs = bench.bench_config(name), jax_bench.bench_config(name)
    assert mine[1:] == theirs[1:]
    for key in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                "ffn_hidden_size", "max_seq_len"):
        assert getattr(mine[0], key) == getattr(theirs[0], key), key


@pytest.mark.parametrize("args", [(124_000_000,), (354_000_000, 24, 1024, 1024),
                                  (1_300_000_000, 24, 2048, 2048), (0, 2, 128, 128)])
def test_flops_per_token_equals_jax(args):
    assert transformer_flops_per_token(*args) == jax_flops(*args)


def test_peak_is_the_h100_dense_bf16_rate():
    assert peak_flops_per_sec("h100") == 989e12
    assert peak_flops_per_sec("cpu") is None


def test_main_on_the_cpu_prints_one_line(monkeypatch, capsys):
    for knob in bench.UNPORTED:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("PADDLE_TPU_BENCH_STEPS", "3")
    monkeypatch.setenv("PADDLE_TPU_BENCH_BATCH", "4")
    monkeypatch.setenv("PADDLE_TPU_BENCH_ACCUM", "2")
    monkeypatch.setenv("PADDLE_TPU_BENCH_RECOMPUTE", "1")
    monkeypatch.setenv("PADDLE_TPU_BENCH_DECODE", "1")
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "gpt_pretrain_tokens_per_sec_per_chip"
    assert row["unit"] == "tokens/s/chip" and row["value"] > 0
    ex = row["extra"]
    assert (ex["batch"], ex["seq"], ex["steps"], ex["warmup"]) == (4, 128, 3, 1)
    assert ex["timing"]["windows"] == 3 and ex["timing"]["rel_spread"] is not None
    assert ex["platform"] == "cpu" and ex["mfu_vs_h100_bf16_peak"] is None
    assert ex["max_memory_allocated_bytes"] is None and ex["card"] is None
    assert ex["recompute"] == "full" and ex["microbatches"] == 2
    assert ex["decode_tokens_per_sec"] > 0
    assert ex["final_loss"] < ex["first_loss"]


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_BENCH_DEVICE", raising=False)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()


@pytest.mark.parametrize("knob", sorted(bench.UNPORTED))
def test_an_unported_knob_stops_the_script(monkeypatch, capsys, knob):
    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE", "cpu")
    monkeypatch.setenv(knob, "1")
    with pytest.raises(SystemExit, match=f"{knob} is not ported: .*ROADMAP.md"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_the_int8_decode_knob_quantizes_every_projection(monkeypatch, capsys):
    """PADDLE_TPU_BENCH_DECODE_INT8=1 (bench.py's knob): the decode model's
    4 projections a block become weight-only int8 QuantizedLinears (the
    tied head stays the embedding) and decode reports its tokens/s."""
    from paddle_tpu_torch.incubate.quantization import QuantizedLinear
    from paddle_tpu_torch.models import GPTForPretraining

    decoded = []
    real = GPTForPretraining.generate

    def spy(self, *a, **k):
        decoded.append([(n, type(m).__name__, getattr(m, "mode", None))
                        for n, m in self.named_modules()
                        if isinstance(m, (torch.nn.Linear, QuantizedLinear))])
        return real(self, *a, **k)

    monkeypatch.setattr(GPTForPretraining, "generate", spy)
    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("PADDLE_TPU_BENCH_STEPS", "1")
    monkeypatch.setenv("PADDLE_TPU_BENCH_BATCH", "2")
    monkeypatch.setenv("PADDLE_TPU_BENCH_WINDOWS", "1")
    monkeypatch.setenv("PADDLE_TPU_BENCH_DECODE", "1")
    monkeypatch.setenv("PADDLE_TPU_BENCH_DECODE_INT8", "1")
    bench.main()
    ex = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["extra"]
    assert ex["decode_tokens_per_sec"] > 0
    assert len(decoded) == 2 and decoded[0] == decoded[1]
    assert len(decoded[0]) == 8 and {(t, m) for _, t, m in decoded[0]} == {
        ("QuantizedLinear", "weight_only_int8")}
    assert {n.rsplit(".", 1)[1] for n, _, _ in decoded[0]} == {
        "qkv_proj", "out_proj", "fc1", "fc2"}


def test_an_unknown_model_stops_the_script(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_BENCH_DEVICE", raising=False)
    monkeypatch.setenv("PADDLE_TPU_BENCH_MODEL", "large")
    with pytest.raises(SystemExit, match="'base' or 'medium'"):
        bench.main()


def _cpu_main(monkeypatch, capsys, **knobs):
    monkeypatch.setenv("PADDLE_TPU_BENCH_DEVICE", "cpu")
    monkeypatch.setenv("PADDLE_TPU_BENCH_STEPS", "3")
    monkeypatch.setenv("PADDLE_TPU_BENCH_BATCH", "4")
    for knob in ("PADDLE_TPU_BENCH_SCAN", "PADDLE_TPU_BENCH_PREFETCH"):
        monkeypatch.delenv(knob, raising=False)
    for knob, value in knobs.items():
        monkeypatch.setenv(knob, value)
    bench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["extra"]


@pytest.mark.parametrize("knob", ["PADDLE_TPU_BENCH_SCAN", "PADDLE_TPU_BENCH_PREFETCH"])
def test_the_scan_and_prefetch_knobs_take_the_plain_runs_steps(monkeypatch, capsys, knob):
    """bench.py's _SCAN (the warm-up and the timed steps each one run_steps
    call, one window) and _PREFETCH (the steps through engine.prefetch):
    the plain run's losses, the knob recorded as bench.py records it. One
    intra-op thread: the same bits in both runs, and no spinning against
    other test processes."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = _cpu_main(monkeypatch, capsys)
        ex = _cpu_main(monkeypatch, capsys, **{knob: "1"})
    finally:
        torch.set_num_threads(was)
    assert (ex["first_loss"], ex["final_loss"]) == (plain["first_loss"], plain["final_loss"])
    scan = knob.endswith("SCAN")
    assert (ex["scan"], ex["prefetch"]) == (("1", None) if scan else (None, "1"))
    assert plain["scan"] is plain["prefetch"] is None
    assert ex["timing"]["windows"] == (1 if scan else 3)
