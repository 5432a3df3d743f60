"""Tensor and sequence parallelism of the port (distributed/mesh.py's mp and sp
axes, meta_parallel/mp_layers.py, parallel_layers.py, sequence_parallel.py,
the engine's mp and sp step) against the JAX package.

Two spawns of gloo ranks (4, then 8; rank bodies in
tests/torch_tp_workers.py, torch on one intra-op thread) run every rank
case once; each test reads its case from the ranks' result files. The JAX
side runs the same gpt_tiny weights (the JAX model's state, which each port
rank loads as its mp shards) and the same global batch (ids [4, 64] from
``RandomState(0)``) on the 8 virtual CPU devices of tests/conftest.py, its
engine on a ``HybridCommunicateGroup`` of the same degrees.

Bars: mp, losses rtol 1e-5 over 3 SGD steps and every gathered parameter
within 1e-5 relative (atol 1e-5 x max|p|) after them; AdamW losses rtol
1e-4 (Adam turns gradient noise near zero into whole lr steps, so it is not
held per parameter). sp (ring at sep 2, Ulysses at sep 4, dp 2) and dp 2 x
mp 2 x sp 2: losses rtol 1e-4, tighter than test_sequence_parallel.py's
3e-4. Ring and Ulysses attention against JAX ``ring_attention`` /
``ulysses_attention`` on test_sequence_parallel.py's ``qkv`` at sp 4:
output atol 2e-5, gradients 5e-5. Port against port (one world): ZeRO at
dp 2 x mp 2 is the replicated update bit for bit; the mp-aware global-norm
clip matches dp 4's at rtol 1e-5; an mp run's gathered state
(``state_dict``) and its checkpoint resume in an mp = 1 engine, and the
checkpoint in the JAX engine, at rtol 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import torch_tp_workers as W
from paddle_tpu.distributed import DistributedStrategy as JaxStrategy
from paddle_tpu.distributed.engine import TrainStepEngine as JaxEngine
from paddle_tpu.distributed.mesh import HybridCommunicateGroup as JaxHCG
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group as jax_set_hcg
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.distributed.meta_parallel import mp_layers
from paddle_tpu_torch.models import (GPTForPretraining, gather_to_jax, gpt_tiny,
                                     load_jax_state, state_from_jax)
from paddle_tpu_torch.models.convert import mp_split_of

DEADLINE_S = 240     # each spawn; ~10 s alone
SP_RTOL = 1e-4


def _jax_model(hcg=None):
    jax_set_hcg(hcg)
    paddle.seed(0)
    return JaxGPT(jax_gpt_tiny())


@pytest.fixture(scope="module")
def state():
    return {n: np.asarray(v._data) for n, v in _jax_model().state_dict().items()}


def _spawn(tmp_path_factory, state, world):
    d = tmp_path_factory.mktemp(f"tp{world}")
    np.savez(d / "state.npz", **state)
    spawn(W.run_world, args=(str(d), str(d / "state.npz"), world), nprocs=world,
          timeout=DEADLINE_S)
    ranks = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    ranks[0]["ckpt_dir"] = d / "ckpt_mp2"
    return ranks


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, state):
    return _spawn(tmp_path_factory, state, 4)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory, state):
    return _spawn(tmp_path_factory, state, 8)


_JAX = {}


def jax_run(degrees, rule="AdamW", impl="ulysses"):
    """The JAX engine's STEPS steps at ``degrees``: (losses, parameters in
    the port's layout)."""
    key = (tuple(sorted(degrees.items())), rule, impl)
    if key not in _JAX:
        d = {a: degrees.get(f"{a}_degree", 1) for a in ("dp", "mp", "sep")}
        hcg = JaxHCG(dp_degree=d["dp"], mp_degree=d["mp"], sp_degree=d["sep"],
                     devices=jax.devices()[:d["dp"] * d["mp"] * d["sep"]])
        jm = _jax_model(hcg)
        if rule == "SGD":
            opt = paddle.optimizer.SGD(learning_rate=W.SGD_LR, parameters=jm.parameters())
        else:
            opt = paddle.optimizer.AdamW(learning_rate=W.LR, parameters=jm.parameters(),
                                         weight_decay=0.01)
        s = JaxStrategy()
        s.sep_impl = impl
        try:
            eng = JaxEngine(jm, opt, hcg=hcg, strategy=s)
            ids, labels = (paddle.to_tensor(t.numpy()) for t in W.batch())
            losses = [float(eng.step(ids, labels).item()) for _ in range(W.STEPS)]
            params = {n: v.numpy() for n, v in state_from_jax(
                {n: np.asarray(a) for n, a in eng.params.items()}).items()}
        finally:
            jax_set_hcg(None)
        _JAX[key] = (losses, params)
    return _JAX[key]


def assert_params_close(got, want):
    for n in sorted(want):
        g = got[n].numpy()
        np.testing.assert_allclose(g, want[n], rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(want[n]).max()), err_msg=n)


# ------------------------------------------------------------------ mp

@pytest.mark.parametrize("case,degrees", [
    ("dp2mp2_sgd", {"dp_degree": 2, "mp_degree": 2}),
    ("dp2mp4_sgd", {"dp_degree": 2, "mp_degree": 4})])
def test_mp_sgd_steps_match_the_jax_engine(ranks4, ranks8, case, degrees):
    ranks = ranks4 if "mp2" in case else ranks8
    losses, params = jax_run(degrees, rule="SGD")
    np.testing.assert_allclose(ranks[0][case]["losses"], losses, rtol=1e-5)
    assert_params_close(ranks[0][case]["params"], params)
    assert all(r[case]["losses"] == ranks[0][case]["losses"] for r in ranks)


@pytest.mark.parametrize("case,degrees", [
    ("dp2mp2_adamw", {"dp_degree": 2, "mp_degree": 2}),
    ("dp2mp4_adamw", {"dp_degree": 2, "mp_degree": 4})])
def test_mp_adamw_losses_match_the_jax_engine(ranks4, ranks8, case, degrees):
    ranks = ranks4 if "mp2" in case else ranks8
    losses, _ = jax_run(degrees)
    np.testing.assert_allclose(ranks[0][case]["losses"], losses, rtol=1e-4)
    assert losses[-1] < losses[0]


def test_zero_composes_with_mp_bit_for_bit(ranks4):
    """ZeRO over the 2-rank replica group at dp 2 x mp 2 is the replicated
    update, losses and every gathered parameter."""
    rep, zero = ranks4[0]["dp2mp2_adamw"], ranks4[0]["dp2mp2_zero"]
    assert zero["losses"] == rep["losses"]
    assert all(torch.equal(zero["params"][n], rep["params"][n]) for n in rep["params"])


def test_zero_and_microbatches_compose_with_sp(ranks4):
    """sharding 2 x sp 2 ring (ZeRO over the replica group) at 2
    microbatches against dp 2 x sp 2 ring in one microbatch: losses rtol
    1e-5; weights under tests/test_torch_dp.py's AdamW rule (atol 5 x lr,
    at most 0.1% of the entries more than 1e-5 apart: Adam moves an entry
    by about lr where a gradient within rounding of 0 takes the other
    sign)."""
    got, want = ranks4[0]["sharding2sp2_ring_k2"], ranks4[0]["dp2sp2_ring"]
    assert got["zero"] and not want["zero"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    apart = total = 0
    for n, p in want["params"].items():
        g, w = got["params"][n].numpy(), p.numpy()
        np.testing.assert_allclose(g, w, atol=5 * W.LR, rtol=0, err_msg=n)
        apart += int((np.abs(g - w) > 1e-5).sum())
        total += w.size
    assert apart <= 1e-3 * total, (apart, total)


@pytest.mark.parametrize("case", ["dp2mp2_clip", "dp2mp2_zero_clip"])
def test_the_global_norm_clip_counts_mp_shards_once(ranks4, case):
    """ClipGradByGlobalNorm(0.5) at dp 2 x mp 2 (replicated and ZeRO)
    against dp 4, where every rank holds whole parameters."""
    got, want = ranks4[0][case], ranks4[0]["dp4_clip"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for n, p in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_an_mp_run_resumes_at_mp_one(ranks4, state):
    """The dp 2 x mp 2 run's gathered state (after 3 steps) in an mp = 1
    engine takes the next steps as the mp run did; set_state_dict gives the
    mp ranks their shards back bit for bit."""
    from paddle_tpu_torch.distributed import TrainStepEngine
    from paddle_tpu_torch.optimizer import AdamW

    mine = ranks4[0]["dp2mp2_adamw"]
    assert all(r["dp2mp2_adamw"]["set_state_dict_same"] for r in ranks4)
    torch.manual_seed(0)
    m = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    eng = TrainStepEngine(m, AdamW(learning_rate=W.LR, parameters=m.named_parameters(),
                                   weight_decay=0.01))
    eng.set_state_dict(mine["state"])
    assert eng._step_count == W.STEPS
    ids, labels = W.batch()
    resumed = [eng.step(ids, labels).item() for _ in range(W.RESUME_STEPS)]
    np.testing.assert_allclose(resumed, mine["resumed"], rtol=1e-5)


def test_an_mp_checkpoint_resumes_at_mp_one_and_in_the_jax_package(ranks4, state):
    """The dp 2 x mp 2 run's checkpoint (elastic.CheckpointManager after 3
    steps: the logical tensors in the JAX package's layout, written by rank
    0) restores into an mp = 1 port engine and into the JAX engine; both
    take the next steps as the mp run did."""
    from paddle_tpu.distributed import elastic as jelastic
    from paddle_tpu_torch.distributed import TrainStepEngine, elastic
    from paddle_tpu_torch.optimizer import AdamW

    ckpt = str(ranks4[0]["ckpt_dir"])
    want = ranks4[0]["dp2mp2_adamw"]["resumed"]
    ids, labels = W.batch()
    m = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"),
                       {n: np.zeros_like(v) for n, v in state.items()})
    eng = TrainStepEngine(m, AdamW(learning_rate=W.LR, parameters=m.named_parameters(),
                                   weight_decay=0.01))
    assert elastic.restore_latest(eng, ckpt) == W.STEPS
    got = [eng.step(ids, labels).item() for _ in range(W.RESUME_STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)

    hcg = JaxHCG(dp_degree=1, devices=jax.devices()[:1])
    jm = _jax_model(hcg)
    try:
        je = JaxEngine(jm, paddle.optimizer.AdamW(learning_rate=W.LR,
                                                  parameters=jm.parameters(),
                                                  weight_decay=0.01), hcg=hcg)
        assert jelastic.restore_latest(je, ckpt) == W.STEPS
        jids, jlabels = (paddle.to_tensor(t.numpy()) for t in (ids, labels))
        got = [float(je.step(jids, jlabels).item()) for _ in range(W.RESUME_STEPS)]
    finally:
        jax_set_hcg(None)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------------------ sp

@pytest.mark.parametrize("case,degrees,impl", [
    ("dp2sp2_ring", {"dp_degree": 2, "sep_degree": 2}, "ring"),
    ("dp2sp4_ulysses", {"dp_degree": 2, "sep_degree": 4}, "ulysses"),
    ("dp2mp2sp2", {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}, "ulysses"),
    ("dp2mp2sp2_ring", {"dp_degree": 2, "mp_degree": 2, "sep_degree": 2}, "ring")])
def test_sp_train_losses_match_the_jax_engine(ranks4, ranks8, case, degrees, impl):
    ranks = ranks4 if case == "dp2sp2_ring" else ranks8
    # the JAX step of dp 2 x mp 2 x sp 2 runs Ulysses (its default); the
    # port's ring at the same degrees is held to it too
    losses, _ = jax_run(degrees, impl="ulysses" if "mp2" in case else impl)
    got = ranks[0][case]["losses"]
    np.testing.assert_allclose(got, losses, rtol=SP_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("granularity", ["full", "selective"])
def test_recompute_replays_the_ring_under_its_scope(ranks4, granularity):
    """A recomputed block replays its ring attention over the ranks (the sp
    scope is carried into the backward's replay): the steps' losses and
    weights are the run without recompute's bit for bit."""
    got, want = ranks4[0][f"dp2sp2_ring_{granularity}"], ranks4[0]["dp2sp2_ring"]
    assert got["losses"] == want["losses"]
    assert all(torch.equal(got["params"][n], want["params"][n]) for n in want["params"])


def _jax_attention(impl, causal):
    from jax.sharding import Mesh

    from paddle_tpu.distributed.meta_parallel.sequence_parallel import (
        ring_attention, ulysses_attention)

    fn = ring_attention if impl == "ring" else ulysses_attention
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("sp", "dp"))
    q, k, v = (jax.numpy.asarray(t.numpy()) for t in W.qkv())

    def loss(q, k, v):
        return jax.numpy.sum(fn(q, k, v, mesh, axis="sp", causal=causal) * v)

    out = jax.jit(lambda q, k, v: fn(q, k, v, mesh, axis="sp", causal=causal))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_matches_jax_at_sp4(ranks4, impl, causal):
    """The four ranks' blocks of the output and of dq, dk, dv of
    sum(out * v) against the JAX function over the 4-way sp mesh."""
    want = _jax_attention(impl, causal)
    got = [torch.cat([r["attention"][(impl, causal)][i] for r in ranks4], dim=1).numpy()
           for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=5e-5)


def test_ulysses_refuses_heads_that_do_not_divide():
    from paddle_tpu_torch.distributed.mesh import CommGroup
    from paddle_tpu_torch.distributed.meta_parallel.sequence_parallel import (
        ulysses_attention)

    q = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match=r"num_heads \(3\) divisible by its size \(2\)"):
        ulysses_attention(q, q, q, group=CommGroup("sp", [0, 1]))


# ------------------------------------------------------------------ layers

@pytest.fixture
def deterministic():
    """One order for the CPU embedding backward's accumulation."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_the_mp_layers_at_mp_one_are_the_dense_model_bit_for_bit(state, deterministic):
    """The GPT built from the mp layers at mp = 1 (no topology) is the
    dense arithmetic: its loss and gradients equal those of the same model
    with plain torch Linear / embedding calls in place of the mp layers'."""
    import torch.nn.functional as TF

    m = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    assert type(m.gpt.blocks[0].attn.qkv_proj) is mp_layers.ColumnParallelLinear
    assert m.mp_size == 1 and not any(x.mp_size > 1 for x in m.modules()
                                      if hasattr(x, "mp_splits"))
    ids, labels = W.batch()
    loss = m(ids, labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    for mod in m.modules():
        if isinstance(mod, (mp_layers.ColumnParallelLinear, mp_layers.RowParallelLinear)):
            mod.forward = (lambda x, mod=mod: TF.linear(x, mod.weight, mod.bias))
        elif isinstance(mod, mp_layers.VocabParallelEmbedding):
            mod.forward = (lambda i, mod=mod: mod.weight[i])
    loss2 = m(ids, labels)
    loss2.backward()
    assert torch.equal(loss, loss2)
    for n, p in m.named_parameters():
        assert torch.equal(grads[n], p.grad), n


@pytest.mark.parametrize("mp", [2, 4])
def test_convert_round_trips_the_per_head_qkv_split_bit_for_bit(state, mp):
    shards = [state_from_jax(state, r, mp) for r in range(mp)]
    back = gather_to_jax(shards)
    assert back.keys() == state.keys()
    for n, a in state.items():
        assert back[n].dtype == a.dtype and np.array_equal(back[n], a), n
    # rank r's qkv shard is its heads of q, of k and of v
    w = state["gpt.blocks.0.attn.qkv_proj.weight"]          # JAX [H, 3H]
    h = w.shape[0]
    nh, hd = 4, h // 4
    heads = w.reshape(h, 3, nh, hd)
    for r in range(mp):
        want = heads[:, :, r * nh // mp:(r + 1) * nh // mp].reshape(h, -1).T
        np.testing.assert_array_equal(
            shards[r]["gpt.blocks.0.attn.qkv_proj.weight"].numpy(), want)


def test_convert_names_the_model_layers_splits():
    m = GPTForPretraining(gpt_tiny(tie_word_embeddings=False), device="cpu")
    splits = mp_layers.sharded_parameters(m)
    for n, _ in m.named_parameters():
        assert mp_split_of(n) == (splits[n][0] if n in splits else None), n
    assert set(splits) >= {"gpt.wte.weight", "lm_head.weight",
                           "gpt.blocks.1.attn.qkv_proj.bias", "gpt.blocks.0.mlp.fc2.weight"}


def test_parallel_cross_entropy_matches_the_jax_loss_and_gradient(ranks4):
    from paddle_tpu.distributed.meta_parallel.mp_layers import (
        ParallelCrossEntropy as JaxPCE)

    logits, labels = W.ce_inputs()
    x = paddle.to_tensor(logits, stop_gradient=False)
    loss = JaxPCE()(x, paddle.to_tensor(labels))
    loss.mean().backward()
    for r in ranks4:
        np.testing.assert_allclose(r["parallel_ce"]["loss"].numpy(), loss.numpy(),
                                   rtol=1e-6, atol=1e-6)
    grad = torch.cat([r["parallel_ce"]["grad"] for r in ranks4], dim=-1).numpy()
    np.testing.assert_allclose(grad, x.grad.numpy(), rtol=1e-6, atol=1e-7)
    assert not grad[[2, 9]].any()   # ignore_index rows


def test_parallel_cross_entropy_at_mp_one_matches_jax():
    from paddle_tpu.distributed.meta_parallel.mp_layers import (
        ParallelCrossEntropy as JaxPCE)
    from paddle_tpu_torch.distributed.meta_parallel import ParallelCrossEntropy

    logits, labels = W.ce_inputs()
    x = torch.from_numpy(logits).requires_grad_()
    loss = ParallelCrossEntropy()(x, torch.from_numpy(labels))
    loss.mean().backward()
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JaxPCE()(jx, paddle.to_tensor(labels))
    jl.mean().backward()
    np.testing.assert_allclose(loss.detach().numpy(), jl.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_rng_tracker_masks_differ_across_mp_and_agree_across_dp(ranks4):
    by = {(r["rng"]["dp_rank"], r["rng"]["mp_rank"]): r["rng"] for r in ranks4}
    assert set(by) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for dp in (0, 1):
        assert not torch.equal(by[(dp, 0)]["inside"], by[(dp, 1)]["inside"])
    for mp in (0, 1):
        assert torch.equal(by[(0, mp)]["inside"], by[(1, mp)]["inside"])
    # outside the tracker every rank draws from the same global seed
    assert all(torch.equal(r["outside"], by[(0, 0)]["outside"]) for r in by.values())


# ------------------------------------------------------------------ topology

def test_the_topology_of_each_world(ranks4, ranks8):
    t4 = [r["topology"] for r in ranks4]
    assert [t["mp_group"] for t in t4] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [t["replica_group"] for t in t4] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert all(t["mode"] == "tensor_parallel" and t["mp_world"] == 2 for t in t4)
    t8 = [r["topology"] for r in ranks8]
    # rank = ((dp * sp) + sp_i) * mp + mp_i
    assert t8[5]["mp_group"] == [4, 5] and t8[5]["sp_group"] == [5, 7]
    assert t8[5]["replica_group"] == [1, 3, 5, 7] and t8[5]["sp_world"] == 2


def test_what_still_raises_names_item_9(ranks4):
    refused = ranks4[0]["refusals"]
    assert set(refused) == {"health", "bf16", "fsdp", "clip_by_norm", "generate",
                            "distributed_model"}
    for name, msg in refused.items():
        assert msg is not None and "item 9" in msg, (name, msg)
