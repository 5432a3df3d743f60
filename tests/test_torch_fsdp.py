"""FSDP of the port (paddle_tpu_torch/distributed/: grad_comm's buckets and
collectives, the engine's sharded step) in gloo ranks against the JAX
engine's ``fsdp=True`` on a 2-device mesh, and checkpoints of a sharded
engine across rank counts.

Two groups of ranks (``spawn``, each with a deadline): 4 ranks save an FSDP
engine's checkpoint (tests/torch_fsdp_workers.py ``save_world4``), then 2
ranks run every case of ``run_cases`` once, the world-4 checkpoint's
restores among them; each test reads its case from the ranks' result
files. The JAX side is tests/test_torch_dp.py's: the same gpt_tiny weights,
ids [8, 128] from ``RandomState``, AdamW(1e-3, weight decay 0.01), 3 steps,
``HybridCommunicateGroup(dp_degree=2)`` with the parameters replicated.

Bars: f32 against JAX, losses rtol 1e-5 and parameters under
``assert_params_close``; bf16 and int8 with error feedback, losses rtol 1e-4
against JAX at the same payload; FSDP against the port's replicated step at
f32, bit for bit (losses, gathered parameters and optimizer slots), and
every prefetch depth bit for bit; the checkpoint's parameters bit for bit
in every target. Adamax, Adagrad, Adadelta and RMSProp run FSDP bit for bit
against the replicated update; Lamb and Lars warn once and run the
replicated update, bit for bit.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_fsdp_workers as FW
from paddle_tpu.distributed import grad_comm as jgc
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import HybridCommunicateGroup
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu_torch.distributed import grad_comm as pgc
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.models import GPTConfig, state_from_jax
from paddle_tpu_torch.models.gpt import GPTForPretraining as TorchGPT
from paddle_tpu_torch.models.gpt import GPTModel as TorchGPTModel
from test_torch_dp import _jax_model, assert_params_close

DEADLINE_S = 240    # each group of ranks; they take ~10 s and ~25 s
LOWP_RTOL_VS_JAX = 1e-4

JAX_CASES = {  # case: (microbatches, payload, error feedback, unequal labels)
    "f32_k1": (1, "f32", False, False),
    "f32_k2": (2, "f32", False, True),
    "bf16_ef": (1, "bf16", True, False),
    "int8_ef": (1, "int8", True, False),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's results, one dict a rank, and the world-4 save."""
    d = tmp_path_factory.mktemp("fsdp")
    state = {n: np.asarray(v._data) for n, v in _jax_model().state_dict().items()}
    np.savez(d / "state.npz", **state)
    ckpt = str(d / "ckpt4")
    spawn(FW.save_world4, args=(str(d), str(d / "state.npz"), ckpt), nprocs=4,
          timeout=DEADLINE_S)
    spawn(FW.run_cases, args=(str(d), str(d / "state.npz"), ckpt), nprocs=2,
          timeout=DEADLINE_S)
    return ([torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)],
            torch.load(d / "saved4.pt", weights_only=False))


_JAX = {}


def jax_run(case):
    """The JAX engine's 3 FSDP steps of a JAX_CASES case at dp 2: (losses,
    parameters in the port's layout, the memory model)."""
    if case not in _JAX:
        k, dtype, ef, unequal = JAX_CASES[case]
        paddle.set_flags({"grad_comm_dtype": dtype, "grad_comm_error_feedback": ef})
        try:
            jm = _jax_model()
            hcg = HybridCommunicateGroup(dp_degree=2, devices=jax.devices()[:2])
            opt = paddle.optimizer.AdamW(learning_rate=FW.W.LR, parameters=jm.parameters(),
                                         weight_decay=0.01)
            eng = JaxEngine(jm, opt, hcg=hcg, microbatches=k, fsdp=True)
            ids, labels = (paddle.to_tensor(t.numpy()) for t in FW.W.batch(unequal=unequal))
            losses = [float(eng.step(ids, labels).item()) for _ in range(FW.STEPS)]
            assert eng._fsdp_params is not None
            params = {n: v.numpy() for n, v in state_from_jax(
                {n: np.asarray(a) for n, a in eng._gather_fsdp_params().items()}).items()}
            mm = eng.fsdp_memory_model()
        finally:
            paddle.set_flags({"grad_comm_dtype": "f32", "grad_comm_error_feedback": False})
        _JAX[case] = (losses, params, mm)
    return _JAX[case]


@pytest.mark.parametrize("case", ["f32_k1", "f32_k2"])
def test_f32_fsdp_matches_the_jax_engine(ranks, case):
    mine = ranks[0][0]["payloads"][case]
    losses, params, _ = jax_run(case)
    assert mine["fsdp_engaged"]
    np.testing.assert_allclose(mine["losses"], losses, rtol=1e-5)
    assert mine["losses"][-1] < mine["losses"][0]
    assert_params_close(mine["params"], params)


@pytest.mark.parametrize("case", ["bf16_ef", "int8_ef"])
def test_low_precision_fsdp_matches_the_jax_engine(ranks, case):
    mine = ranks[0][0]["payloads"][case]
    assert mine["fsdp_engaged"]
    np.testing.assert_allclose(mine["losses"], jax_run(case)[0], rtol=LOWP_RTOL_VS_JAX)
    assert mine["losses"][-1] < mine["losses"][0]
    for r in ranks[0]:
        got = r["payloads"][case]
        assert got["residual_numel"] == got["n"]


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_every_rank_holds_the_same_weights_and_loss(ranks, case):
    a, b = (r["payloads"][case] for r in ranks[0])
    assert a["digest"] == b["digest"] and a["losses"] == b["losses"]


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_byte_counters_equal_fsdp_payload_bytes(ranks, case):
    k, dtype, _, _ = JAX_CASES[case]
    for r in ranks[0]:
        got = r["payloads"][case]
        shards = [b["shard"] for b in got["memory_model"]["buckets"]]
        rs, ag, _ = jgc.fsdp_payload_bytes(shards, 2, dtype, 1024)
        c, s = got["counters"], FW.STEPS
        assert (c["grad_comm.rs_bytes"], c["grad_comm.ag_bytes"]) == (s * rs, s * ag)
        assert c["grad_comm.bytes_moved"] == s * (rs + ag)
        assert c["grad_comm.steps"] == s and c["grad_comm.microbatches"] == s * k
        assert c["grad_comm.lowp_steps"] == (s if dtype != "f32" else 0)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_memory_model_equals_the_jax_engines(ranks, case):
    mine = ranks[0][0]["payloads"][case]["memory_model"]
    want = jax_run(case)[2]
    assert set(mine) == set(want)
    for key in want:
        assert mine[key] == want[key], key


def test_fsdp_is_the_replicated_step_bit_for_bit(ranks):
    for rank, r in enumerate(ranks[0]):
        rep, fs = r["vs_replicated"]["replicated"], r["vs_replicated"]["fsdp"]
        assert fs["fsdp_engaged"] and not rep["fsdp_engaged"]
        assert fs["losses"] == rep["losses"] and len(rep["losses"]) == 5
        assert fs["digest"] == rep["digest"], rank
        if rank == 0:
            for n, p in rep["params"].items():
                assert torch.equal(fs["params"][n], p), n
            for n, slots in rep["opt"].items():
                for a, b in zip(fs["opt"][n], slots):
                    assert torch.equal(a, b), n


def test_each_rank_holds_only_its_shards(ranks):
    for r in ranks[0]:
        got = r["vs_replicated"]["fsdp"]
        held, mm = got["held"], got["memory_model"]
        shards = [b["shard"] for b in mm["buckets"]]
        assert held["model_numel"] == 0 and held["opt_states"] == 0
        assert held["param_shards"] == shards
        assert held["opt_shards"] == [shards, shards]
        assert sum(shards) * 2 == sum(b["pad"] for b in mm["buckets"])
        assert mm["sharded_param_bytes_per_device"] == sum(shards) * 4
        # the forward's order: embeddings, the blocks, the final norm
        keys = [b["key"] for b in mm["buckets"]]
        assert [keys[i] for i in held["order"]] == [
            "embeddings", "gpt.blocks.0", "gpt.blocks.1", "final"]


def test_every_prefetch_depth_gives_the_same_bits(ranks):
    for r in ranks[0]:
        runs = r["prefetch"]
        assert {d: runs[d]["held"]["prefetch"] for d in runs} == {0: 0, 1: 1, 2: 2, 3: 2}
        for d in (1, 2, 3):
            assert runs[d]["losses"] == runs[0]["losses"]
            assert runs[d]["digest"] == runs[0]["digest"]


def test_fsdp_supersedes_zero_and_the_flag_engages_it(ranks):
    base = ranks[0][0]["payloads"]["f32_k1"]
    for r in ranks[0]:
        for case in ("with_zero", "flag"):
            got = r["modes"][case]
            assert got["fsdp_engaged"] and not got["zero_engaged"], case
            assert got["losses"] == base["losses"] and got["digest"] == base["digest"]
            assert not got["warnings"]


def test_an_ineligible_clip_warns_once_and_is_the_replicated_step(ranks):
    for r in ranks[0]:
        fs, rep = r["modes"]["clip_fsdp"], r["modes"]["clip_replicated"]
        assert len(fs["warnings"]) == 1 and "fsdp requested but falling back" in fs["warnings"][0]
        assert not fs["fsdp_engaged"]
        assert fs["losses"] == rep["losses"] and fs["digest"] == rep["digest"]


@pytest.mark.parametrize("rule", sorted(FW.W.RULE_KW))
def test_each_rule_under_fsdp_is_the_replicated_step(ranks, rule):
    elementwise = rule not in ("Lamb", "Lars")
    for r in ranks[0]:
        fs, rep = r["rules"][rule]["fsdp"], r["rules"][rule]["replicated"]
        assert fs["fsdp_engaged"] == elementwise
        if elementwise:
            assert not fs["warnings"]
        else:
            assert len(fs["warnings"]) == 1
            assert "fsdp requested but falling back" in fs["warnings"][0]
            assert rule.lower() in fs["warnings"][0]
        assert fs["losses"] == rep["losses"] and fs["digest"] == rep["digest"]
    if elementwise:
        fs, rep = (ranks[0][0]["rules"][rule][m] for m in ("fsdp", "replicated"))
        for n, slots in rep["opt"].items():
            assert len(fs["opt"][n]) == len(slots)
            for a, b in zip(fs["opt"][n], slots):
                assert torch.equal(a, b), n


def test_a_world4_fsdp_checkpoint_restores_at_world2_bit_for_bit(ranks):
    results, saved = ranks
    assert saved["fsdp_engaged"]
    for r in results:
        got = r["restore_world4"]
        assert got["fsdp"]["digest"] == got["zero"]["digest"] == got["replicated"]["digest"]
        for mode in ("fsdp", "zero", "replicated"):
            assert got[mode]["step"] == 2 and got[mode]["engine_step"] == 2 + FW.STEPS
        assert got["fsdp"]["fsdp_engaged"] and got["zero"]["zero_engaged"]
        # at 2 ranks the three updates are one another's bit for bit
        assert got["fsdp"]["continued"] == got["replicated"]["continued"]
        assert got["zero"]["continued"] == got["replicated"]["continued"]
    got = results[0]["restore_world4"]
    for mode in ("fsdp", "zero", "replicated"):
        for n, p in saved["params"].items():
            assert torch.equal(got[mode]["params"][n], p), (mode, n)
        for n, slots in saved["opt"].items():
            for a, b in zip(got[mode]["opt"][n], slots):
                assert torch.equal(a, b), (mode, n)


# ---------------------------------------------------------- the bucket arithmetic

def _port_shapes(cfg):
    with torch.device("meta"):
        m = torch.nn.Module()
        m.gpt = TorchGPTModel(cfg)
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


def _jax_shapes(port_shapes):
    """The JAX package's shapes: its Linear weights [in, out]."""
    return {n: tuple(reversed(s)) if n.endswith(("proj.weight", "fc1.weight", "fc2.weight"))
            else s for n, s in port_shapes.items()}


@functools.lru_cache(maxsize=None)
def _shape_sets():
    jm = _jax_model()
    tiny_jax = {n: tuple(v.shape) for n, v in jm.state_dict().items()}
    tiny_port = _port_shapes(GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                                       num_heads=4, max_seq_len=128))
    base_port = _port_shapes(GPTConfig())
    return {"gpt_tiny": (tiny_port, tiny_jax), "gpt2_124m": (base_port, _jax_shapes(base_port))}


@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
@pytest.mark.parametrize("model", ["gpt_tiny", "gpt2_124m"])
def test_the_bucket_functions_are_the_references(model, nrep):
    port_shapes, jax_shapes = _shape_sets()[model]
    assert {n: math.prod(s) for n, s in port_shapes.items()} == \
        {n: math.prod(s) for n, s in jax_shapes.items()}
    key = TorchGPT.fsdp_layer_key
    assert all(key(n) == JaxGPT.fsdp_layer_key(n) for n in port_shapes)
    for chunk in (1024, 256):
        mine = pgc.fsdp_buckets(port_shapes, nrep, chunk, layer_key=key)
        want = jgc.fsdp_buckets(jax_shapes, nrep, chunk, layer_key=JaxGPT.fsdp_layer_key)
        assert mine == want
        assert [n for b in mine for n in b["names"]].count("gpt.wte.weight") == 1
        assert pgc.fsdp_buckets(port_shapes, nrep, chunk) == jgc.fsdp_buckets(
            jax_shapes, nrep, chunk)
        shards = [b["shard"] for b in mine]
        for dtype in ("f32", "bf16", "int8"):
            assert pgc.fsdp_payload_bytes(shards, nrep, dtype, chunk) == \
                jgc.fsdp_payload_bytes(shards, nrep, dtype, chunk)
        for depth in range(0, 6):
            assert pgc.fsdp_window_bytes(mine, depth) == jgc.fsdp_window_bytes(want, depth)
            assert pgc.fsdp_prefetch_ahead_bytes(mine, depth) == \
                jgc.fsdp_prefetch_ahead_bytes(want, depth)
            assert pgc.fsdp_prefetch_depth(mine, depth) == jgc.fsdp_prefetch_depth(want, depth)
    for n in port_shapes:
        assert pgc.default_layer_key(n) == jgc.default_layer_key(n)
