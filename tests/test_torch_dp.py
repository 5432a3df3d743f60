"""Data parallelism of the port (paddle_tpu_torch/distributed/: fleet, the
one fused gradient reduce of grad_comm.py, ZeRO) in 2 gloo ranks against
the JAX engine on a 2-device mesh.

One group of 2 ranks (``spawn``, with a deadline) runs every case of
tests/torch_dp_workers.py once; each test reads its case from the ranks'
result files. The JAX side: the same gpt_tiny weights (carried over by
``load_jax_state``), ids [8, 128] from ``RandomState``, AdamW(1e-3, weight
decay 0.01), 3 steps, on ``HybridCommunicateGroup(dp_degree=2)`` with the
model's parameters replicated (their mp annotations cleared: at mp 1 they
change no placement, and the JAX engine takes its pure data-parallel path,
the one fused reduce and ZeRO, only for replicated parameters).

Bars: f32, losses rtol 1e-5 and parameters under tests/test_torch_accum.py's
rule (atol 5 x lr, at most 0.1% of the entries more than 1e-5 apart: Adam
moves an entry by about lr where a gradient within rounding of 0 takes the
other sign); bf16 and int8 payloads, losses rtol 1e-4 against JAX at the
same payload and 2e-2 against the f32 trajectory (the JAX package's bar,
tests/test_grad_comm.py); ZeRO against the port's replicated update at f32,
bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_dp_workers as W
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import (HybridCommunicateGroup,
                                         set_hybrid_communicate_group)
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import state_from_jax

DEADLINE_S = 240    # the whole group of ranks; it takes ~20 s
LOWP_RTOL_VS_JAX = 1e-4
LOWP_RTOL_VS_F32 = 2e-2

PAYLOAD_CASES = {  # case: (microbatches, payload, error feedback, zero, unequal labels)
    "f32_k1": (1, "f32", False, False, False),
    "f32_k2": (2, "f32", False, False, True),
    "bf16": (1, "bf16", False, False, False),
    "bf16_ef": (1, "bf16", True, False, False),
    "int8": (1, "int8", False, False, False),
    "int8_ef": (1, "int8", True, False, False),
    "zero_f32": (1, "f32", False, True, False),
    "zero_bf16": (1, "bf16", False, True, False),
    "zero_int8_ef": (1, "int8", True, True, False),
}


def _jax_model():
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    for p in jm.parameters():
        p.dist_attr = None
    return jm


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, one dict a rank."""
    d = tmp_path_factory.mktemp("dp")
    state = {n: np.asarray(v._data) for n, v in _jax_model().state_dict().items()}
    np.savez(d / "state.npz", **state)
    spawn(W.run_cases, args=(str(d), str(d / "state.npz")), nprocs=2,
          timeout=DEADLINE_S)
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


_JAX = {}


def jax_run(case):
    """The JAX engine's 3 steps of a PAYLOAD_CASES case at dp 2: (losses,
    parameters in the port's layout)."""
    if case not in _JAX:
        k, dtype, ef, zero, unequal = PAYLOAD_CASES[case]
        paddle.set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef})
        try:
            jm = _jax_model()
            hcg = HybridCommunicateGroup(dp_degree=2, devices=jax.devices()[:2])
            opt = paddle.optimizer.AdamW(learning_rate=W.LR, parameters=jm.parameters(),
                                         weight_decay=0.01)
            eng = JaxEngine(jm, opt, hcg=hcg, microbatches=k, zero_update=zero)
            ids, labels = (paddle.to_tensor(t.numpy()) for t in W.batch(unequal=unequal))
            losses = [float(eng.step(ids, labels).item()) for _ in range(W.STEPS)]
            assert (eng._zero_opt is not None) == zero
            params = {n: v.numpy() for n, v in state_from_jax(
                {n: np.asarray(a) for n, a in eng.params.items()}).items()}
        finally:
            paddle.set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False})
        _JAX[case] = (losses, params)
    return _JAX[case]


def assert_params_close(got, want, lr=W.LR):
    """tests/test_torch_accum.py's rule."""
    apart = total = 0
    for n in sorted(want):
        g = got[n].numpy()
        np.testing.assert_allclose(g, want[n], atol=5 * lr, rtol=0, err_msg=n)
        apart += int((np.abs(g - want[n]) > 1e-5).sum())
        total += want[n].size
    assert apart <= 1e-3 * total, (apart, total)


@pytest.mark.parametrize("case", ["f32_k1", "f32_k2", "zero_f32"])
def test_f32_steps_match_the_jax_engine(ranks, case):
    mine = ranks[0]["payloads"][case]
    losses, params = jax_run(case)
    np.testing.assert_allclose(mine["losses"], losses, rtol=1e-5)
    assert mine["losses"][-1] < mine["losses"][0]
    assert_params_close(mine["params"], params)
    assert mine["zero_engaged"] == case.startswith("zero")


@pytest.mark.parametrize("case", ["bf16", "bf16_ef", "int8", "int8_ef", "zero_bf16",
                                  "zero_int8_ef"])
def test_low_precision_payloads_match_the_jax_engine(ranks, case):
    mine = ranks[0]["payloads"][case]
    np.testing.assert_allclose(mine["losses"], jax_run(case)[0], rtol=LOWP_RTOL_VS_JAX)
    np.testing.assert_allclose(mine["losses"], ranks[0]["payloads"]["f32_k1"]["losses"],
                               rtol=LOWP_RTOL_VS_F32)
    assert mine["losses"][-1] < mine["losses"][0]


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_every_rank_holds_the_same_weights_and_loss(ranks, case):
    a, b = ranks[0]["payloads"][case], ranks[1]["payloads"][case]
    assert a["digest"] == b["digest"]
    assert a["losses"] == b["losses"]


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_byte_counters_equal_the_payload_functions(ranks, case):
    k, dtype, _, zero, _ = PAYLOAD_CASES[case]
    for r in ranks:
        got = r["payloads"][case]
        c, n, s = got["counters"], got["n"], W.STEPS
        rs, ag = jgc.zero_payload_bytes(n, 2, dtype, 1024) if zero else (0, 0)
        want = rs + ag if zero else jgc.payload_bytes(n, dtype, 1024)
        assert c["grad_comm.bytes_moved"] == s * want
        assert (c["grad_comm.rs_bytes"], c["grad_comm.ag_bytes"]) == (s * rs, s * ag)
        assert c["grad_comm.steps"] == s and c["grad_comm.microbatches"] == s * k
        assert c["grad_comm.lowp_steps"] == (s if dtype != "f32" else 0)


@pytest.mark.parametrize("case", ["bf16_ef", "int8_ef", "zero_int8_ef"])
def test_error_feedback_keeps_a_nonzero_residual_of_n(ranks, case):
    for r in ranks:
        got = r["payloads"][case]
        assert got["residual_numel"] == got["n"]
        assert got["residual_absmax"] > 0


def test_zero_is_the_replicated_step_bit_for_bit(ranks):
    res = ranks[0]["zero_vs_replicated"]
    rep, zer = res["replicated"], res["zero"]
    assert zer["losses"] == rep["losses"] and len(rep["losses"]) == 5
    for n, p in rep["params"].items():
        assert torch.equal(zer["params"][n], p), n
    assert zer["zero_engaged"] and not rep["zero_engaged"]


def test_each_rank_owns_its_slice_of_the_sorted_flat_state(ranks):
    for rank, r in enumerate(ranks):
        res = r["zero_vs_replicated"]
        names, offs = res["names"], res["offsets"]
        assert names == sorted(names)
        sizes = {n: p.numel() for n, p in ranks[0]["zero_vs_replicated"]["replicated"]
                 ["params"].items()}
        assert [offs[n] for n in names] == list(np.cumsum([0] + [sizes[n] for n in names])[:-1])
        assert res["n_pad"] == jgc.zero_pad_elems(res["n"], 2, 1024)
        assert res["shard"] * 2 == res["n_pad"]
        assert res["own_shard_equal"] == [True, True], rank
        assert res["state_dict_equal"]
        assert res["opt_states_left"] == 0
        assert res["zero_opt_numel"] == [res["shard"]] * 2
        mm = res["memory_model"]
        assert mm["replicated_opt_bytes"] == 2 * res["n"] * 4
        assert mm["sharded_opt_bytes_per_device"] == 2 * res["shard"] * 4


@pytest.mark.parametrize("case", ["decay_exclusion", "clip_by_norm"])
def test_a_zero_fallback_warns_once_and_is_the_replicated_step(ranks, case):
    for r in ranks:
        got = r["fallbacks"][case]
        zer, rep = got["zero"], got["replicated"]
        assert len(zer["warnings"]) == 1 and "falling back" in zer["warnings"][0]
        assert not zer["zero_engaged"]
        assert zer["losses"] == rep["losses"] and zer["digest"] == rep["digest"]


def test_zero_takes_the_elementwise_and_global_clips(ranks):
    got = ranks[0]["fallbacks"]
    by_value, by_norm = got["clip_by_value"], got["clip_by_global_norm"]
    assert by_value["zero"]["zero_engaged"] and not by_value["zero"]["warnings"]
    assert by_value["zero"]["digest"] == by_value["replicated"]["digest"]
    # the global norm sums in another order on the shards: rounding, not bits
    assert by_norm["zero"]["zero_engaged"] and not by_norm["zero"]["warnings"]
    np.testing.assert_allclose(by_norm["zero"]["losses"], by_norm["replicated"]["losses"],
                               rtol=1e-6)
    assert_params_close(by_norm["zero"]["params"],
                        {n: p.numpy() for n, p in by_norm["replicated"]["params"].items()})


def test_sharding_degree_runs_the_zero_update(ranks):
    for rank, r in enumerate(ranks):
        got = r["sharding_degree"]
        assert got["mode"] == "sharding_parallel" and got["sharding_rank"] == rank
        assert got["sharding_group"] == [0, 1]
        assert got["run"]["zero_engaged"]
        assert got["run"]["losses"] == r["payloads"]["zero_f32"]["losses"]
        assert got["run"]["digest"] == r["payloads"]["zero_f32"]["digest"]


def test_dropout_masks_differ_across_ranks_and_runs_repeat(ranks):
    a, b = ranks[0]["dropout"], ranks[1]["dropout"]
    for r in (a, b):
        assert r["runs"][0] == r["runs"][1] and r["masks_repeat"]
    assert a["runs"][0] == b["runs"][0]          # the loss is the mean over ranks
    assert not torch.equal(a["mask"], b["mask"])
    assert 0.4 < a["mask"].float().mean().item() < 0.6


def test_a_batch_not_divisible_by_microbatches_times_replicas_raises(ranks):
    for r in ranks:
        got = r["divisibility"]
        assert "batch dim 6 is not divisible by microbatches = 2 x replicas = 2" in got["message"]
        assert np.isfinite(got["four_rows"])


def test_the_eager_collectives_and_the_fleet_queries(ranks):
    for rank, r in enumerate(ranks):
        got = r["collectives"]
        assert got["degrees"]["dp"] == 2 and got["nranks"] == 2
        assert got["dp_rank"] == rank and got["worker_index"] == rank
        assert got["global_rank"] == rank and got["dp_world"] == 2
        assert got["dp_group"] == [0, 1] and got["sharding_world"] == 1
        assert got["worker_num"] == 2 and got["first"] == (rank == 0)
        assert got["all_reduce"] == [3.0, 20.0]
        assert got["all_reduce_max"] == [2.0, 10.0]
        assert got["all_reduce_avg"] == [1.5, 10.0]
        assert got["all_gather"] == [[1.0, 10.0], [2.0, 10.0]]
        assert got["reduce_scatter"] == ([1.0, 3.0] if rank == 0 else [5.0, 7.0])
        assert got["broadcast"] == [2.0, 10.0]
        assert got["wait"] == [rank + 1.0, 10.0]
        assert got["all_to_all"] == ([0, 1, 10, 11] if rank == 0 else [2, 3, 12, 13])
