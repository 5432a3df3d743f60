"""grad_comm's pure functions, the flags and counters, the topology and
fleet of the port (paddle_tpu_torch/core/, distributed/grad_comm.py,
mesh.py, fleet/) against the JAX package's, in one process: the int8
quantiser bit for bit, the payload functions over a grid, and the one-rank
engine without a process group (its low-precision payloads still
round-trip, as the JAX engine's do on one replica).
"""
import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.distributed import TrainStepEngine
from paddle_tpu_torch.distributed import grad_comm as gc
from paddle_tpu_torch.distributed.fleet import DistributedStrategy, Fleet
from paddle_tpu_torch.distributed.mesh import HybridCommunicateGroup
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.optimizer import AdamW


@pytest.fixture(autouse=True)
def _default_flags():
    set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False,
               "grad_comm_chunk": 1024, "zero_update": False})
    yield
    set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False,
               "grad_comm_chunk": 1024, "zero_update": False})


def _quant_input(n, chunk, seed):
    """Values over four decades, a run of exact zeros as long as a chunk,
    and halves of the scale (round half to even)."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.logspace(-4, 0, n)).astype(np.float32)
    if n > 2 * chunk:
        x[chunk:2 * chunk] = 0.0             # an all-zero chunk
    if n > 5:                                # scale 1 in chunk 0: exact ties
        x[:5] = [127.0, 0.5, 1.5, 2.5, -2.5]
    return x


@pytest.mark.parametrize("n,chunk", [(5000, 256), (4096, 1024), (1000, 128), (3, 1024),
                                     (2049, 1024)])
def test_quantize_int8_is_bit_equal_to_jax(n, chunk):
    x = _quant_input(n, chunk, seed=n)
    q, s = gc._quantize_int8(torch.from_numpy(x), chunk)
    jq, js = jgc._quantize_int8(jnp.asarray(x), chunk)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    back = gc._dequantize_int8(q, s, n).numpy()
    np.testing.assert_array_equal(back, np.asarray(jgc._dequantize_int8(jq, js, n)))


def test_quantize_in_blocks_changes_nothing(monkeypatch):
    x = torch.from_numpy(_quant_input(10_000, 128, seed=1))
    q, s = gc._quantize_int8(x, 128)
    monkeypatch.setattr(gc, "BLOCK", 300)   # 2 chunk rows a block
    q2, s2 = gc._quantize_int8(x, 128)
    assert torch.equal(q, q2) and torch.equal(s, s2)
    out = torch.empty(10_000)
    gc._sub_dequantized(out, x, q, s, 10_000)
    assert torch.equal(out, x - gc._dequantize_int8(q, s, 10_000))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("chunk", [1, 128, 1024, 4096])
@pytest.mark.parametrize("nrep", [1, 2, 3, 4, 8])
def test_payload_functions_equal_jax(dtype, chunk, nrep):
    for n in (1, 1023, 1024, 1025, 544_256, 124_475_904, 354_871_296):
        assert gc.payload_bytes(n, dtype, chunk) == jgc.payload_bytes(n, dtype, chunk)
        assert gc.zero_pad_elems(n, nrep, chunk) == jgc.zero_pad_elems(n, nrep, chunk)
        assert (gc.zero_payload_bytes(n, nrep, dtype, chunk)
                == jgc.zero_payload_bytes(n, nrep, dtype, chunk))


def test_flags_read_the_environment_and_set_flags():
    env = dict(os.environ, FLAGS_grad_comm_dtype="int8", FLAGS_zero_update="1",
               FLAGS_grad_comm_chunk="256")
    code = ("from paddle_tpu_torch import get_flags; print(sorted(get_flags("
            "['grad_comm_dtype', 'zero_update', 'grad_comm_chunk']).items()))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == ("[('FLAGS_grad_comm_chunk', 256), ('FLAGS_grad_comm_dtype', "
                           "'int8'), ('FLAGS_zero_update', True)]")
    set_flags({"FLAGS_grad_comm_dtype": "bfloat16"})
    assert get_flags("grad_comm_dtype") == {"FLAGS_grad_comm_dtype": "bfloat16"}
    assert gc.comm_dtype() == "bf16"
    with pytest.raises(KeyError, match="unknown flag"):
        set_flags({"no_such_flag": 1})
    set_flags({"grad_comm_dtype": "fp8"})
    with pytest.raises(ValueError, match="grad_comm_dtype"):
        gc.comm_dtype()
    set_flags({"grad_comm_chunk": 0})
    with pytest.raises(ValueError, match="positive"):
        gc.chunk_size()


def test_counters_count_and_keep_their_peak():
    s = monitor.stat("test_torch_grad_comm.counter")
    assert monitor.stat("test_torch_grad_comm.counter") is s
    s.set(0)
    assert s.increase(5) == 5 and s.decrease(2) == 3
    assert (s.get(), s.peak()) == (3, 5)
    assert "test_torch_grad_comm.counter" in monitor.registry().names()
    assert monitor.registry().report()["test_torch_grad_comm.counter"] == {
        "value": 3, "peak": 5}


def test_one_process_topology_and_its_limits():
    hcg = HybridCommunicateGroup()
    assert not hcg.distributed and hcg.nranks == 1
    assert hcg.topology()["dp"] == 1 and hcg.get_parallel_mode() == "data_parallel"
    assert hcg.replica_group().process_group is None
    # the pp and ep axes build their groups: one rank, its own stage and experts
    assert hcg.get_pipe_parallel_world_size() == hcg.get_expert_parallel_world_size() == 1
    assert hcg.get_pipe_parallel_group().ranks == hcg.get_expert_parallel_group().ranks == [0]
    assert hcg.get_stage_id() == hcg.get_expert_parallel_rank() == 0
    assert hcg.topology() == {"pp": 1, "dp": 1, "sharding": 1, "sp": 1, "ep": 1, "mp": 1}
    with pytest.raises(ValueError, match="must equal the world"):
        HybridCommunicateGroup(dp_degree=2)
    # every axis is ported: one rank cannot hold two of an axis's ranks
    for kw in ({"mp_degree": 2}, {"sp_degree": 2}, {"pp_degree": 2}, {"pp_degree": 4},
               {"ep_degree": 2}, {"ep_degree": 4}):
        with pytest.raises(ValueError, match="does not divide the world of 1 ranks"):
            HybridCommunicateGroup(**kw)


def test_strategy_merges_dicts_and_fleet_refuses_the_planner():
    s = DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4, "sharding_degree": 2}
    assert (s.hybrid_configs.dp_degree, s.hybrid_configs.sharding_degree) == (4, 2)
    assert s.hybrid_configs.mp_degree == 1
    with pytest.raises(ValueError, match="unknown hybrid_configs key"):
        s.hybrid_configs = {"dp": 2}
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="planner"):
        Fleet().distributed_engine(m, AdamW(parameters=m.named_parameters()), auto=True)


def _batch(b=4, s=128):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 1024, (b, s)).astype(np.int64)
    return ids, np.roll(ids, -1, 1)


def _one_rank(steps=3, **kw):
    m = GPTForPretraining(gpt_tiny(), device="cpu", seed=3)
    e = TrainStepEngine(m, AdamW(1e-3, parameters=m.named_parameters()), **kw)
    ids, labels = _batch()
    return [e.step(ids, labels).item() for _ in range(steps)], m, e


def _jax_one_replica(steps=3, **kw):
    """The JAX engine on a 1-device mesh with the port's weights."""
    from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
    from paddle_tpu.distributed.mesh import (HybridCommunicateGroup as JaxHcg,
                                             set_hybrid_communicate_group)
    from paddle_tpu.models import GPTForPretraining as JaxGPT
    from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
    import jax

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    for p in jm.parameters():
        p.dist_attr = None
    pm = GPTForPretraining(gpt_tiny(), device="cpu")
    from paddle_tpu_torch.models import load_jax_state

    load_jax_state(pm, {n: np.asarray(v._data) for n, v in jm.state_dict().items()})
    jeng = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters()),
                     hcg=JaxHcg(dp_degree=1, devices=jax.devices()[:1]), **kw)
    peng = TrainStepEngine(pm, AdamW(1e-3, parameters=pm.named_parameters()), **kw)
    ids, labels = _batch()
    jl = [float(jeng.step(paddle.to_tensor(ids), paddle.to_tensor(labels)).item())
          for _ in range(steps)]
    pl = [peng.step(ids, labels).item() for _ in range(steps)]
    return jl, pl, peng


@pytest.mark.parametrize("dtype,ef", [("bf16", False), ("int8", True)])
def test_one_rank_round_trips_the_low_precision_payloads_as_jax_does(dtype, ef):
    paddle.set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef})
    set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef})
    try:
        jl, pl, peng = _jax_one_replica()
    finally:
        paddle.set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False})
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert pl[-1] < pl[0]
    assert (peng._grad_residual is not None) == ef


def test_one_rank_zero_is_the_plain_step_and_counts_no_bytes():
    torch.use_deterministic_algorithms(True)
    try:
        b0 = gc.BYTES_MOVED.get()
        plain, mp, _ = _one_rank()
        zero, mz, ez = _one_rank(zero_update=True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert plain == zero
    for (n, a), (_, b) in zip(mp.named_parameters(), mz.named_parameters()):
        assert torch.equal(a, b), n
    assert ez._zero_opt is not None and ez.optimizer._states == {}
    assert gc.BYTES_MOVED.get() == b0     # no process group: no collective


def test_the_strategy_sharding_turns_zero_on():
    s = DistributedStrategy()
    assert not s.sharding
    s.sharding = True
    torch.use_deterministic_algorithms(True)
    try:
        plain, mp, _ = _one_rank()
        zero, mz, ez = _one_rank(strategy=s)
    finally:
        torch.use_deterministic_algorithms(False)
    assert ez._zero_opt is not None and plain == zero
    for (n, a), (_, b) in zip(mp.named_parameters(), mz.named_parameters()):
        assert torch.equal(a, b), n


def test_the_flag_turns_zero_on_and_a_non_uniform_rule_warns_once():
    set_flags({"zero_update": True})
    m = GPTForPretraining(gpt_tiny(), device="cpu")
    e = TrainStepEngine(m, AdamW(parameters=m.named_parameters(),
                                 apply_decay_param_fun=lambda n: "ln" not in n))
    ids, labels = _batch()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        e.step(ids, labels)
        e.step(ids, labels)
    msgs = [str(w.message) for w in caught if "zero_update" in str(w.message)]
    assert len(msgs) == 1 and "per-parameter rule kwargs differ" in msgs[0]
    assert e._zero_opt is None
