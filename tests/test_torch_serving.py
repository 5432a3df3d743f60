"""paddle_tpu_torch ServingEngine vs the JAX package's ServingEngine.

Both engines serve ``gpt_tiny`` with the same weights (JAX from
``paddle.seed(0)``, carried into the port by models/convert.py). Greedy
tokens must be equal exactly. Sampled tokens differ between the packages by
design (threefry keys there, torch.Generator streams here), so sampling is
held to determinism, slot independence and its distribution. The sampling
filter must agree with JAX's on the same numpy logits (f32 atol 1e-6).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import bucketing as jax_bucketing
from paddle_tpu.serving import filter_topk_topp as jax_filter
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.serving import (ServingEngine, bucketing, filter_topk_topp,
                                      gumbel_noise, sample_tokens)


@pytest.fixture(scope="module")
def models():
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    pm = load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)
    return jm, pm


def _engine(model, cls=ServingEngine, **kw):
    args = dict(slot_count=3, ladder=(8, 16, 32), max_new_cap=16,
                steps_per_dispatch=4)
    args.update(kw)
    return cls(model, **args)


def test_greedy_tokens_equal_jax_engine(models):
    """The mixed-length case of tests/test_serving_engine.py through both
    engines: token-identical, same finish reasons."""
    jm, pm = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 1024, (n,)).astype(np.int64)
               for n in (5, 7, 9, 12, 3, 17)]
    out = []
    for cls, model in ((JaxEngine, jm), (ServingEngine, pm)):
        eng = _engine(model, cls)
        reqs = [eng.submit(p, max_new_tokens=6, temperature=0.0) for p in prompts]
        eng.run()
        out.append(reqs)
    for jr, pr in zip(*out):
        assert pr.done and pr.finish_reason == jr.finish_reason == "length"
        assert pr.tokens == jr.tokens
        np.testing.assert_array_equal(pr.output_ids(), jr.output_ids())


def test_eos_retirement_never_alters_survivors(models):
    """A slot retiring mid-flight on EOS must not change another slot's
    tokens: the survivor equals its solo run and the JAX engine's."""
    jm, pm = models
    rng = np.random.RandomState(1)
    pA = rng.randint(0, 1024, (6,)).astype(np.int64)
    pB = rng.randint(0, 1024, (9,)).astype(np.int64)
    probe = _engine(pm, slot_count=2, ladder=(8, 16))
    eosA = probe.submit(pA, max_new_tokens=2, temperature=0.0)
    probe.run()
    eosA = eosA.tokens[-1]         # greedy decoding of A emits it second

    solo = _engine(pm, slot_count=2, ladder=(8, 16))
    rB_alone = solo.submit(pB, max_new_tokens=10, temperature=0.0)
    solo.run()

    eng = _engine(pm, slot_count=2, ladder=(8, 16))
    rA = eng.submit(pA, max_new_tokens=10, temperature=0.0, eos_token_id=eosA)
    rB = eng.submit(pB, max_new_tokens=10, temperature=0.0)
    eng.run()
    assert rA.finish_reason == "eos" and len(rA.tokens) < 10
    assert rA.tokens[-1] == eosA
    assert rB.tokens == rB_alone.tokens

    jeng = _engine(jm, JaxEngine, slot_count=2, ladder=(8, 16))
    jA = jeng.submit(pA, max_new_tokens=10, temperature=0.0, eos_token_id=eosA)
    jB = jeng.submit(pB, max_new_tokens=10, temperature=0.0)
    jeng.run()
    assert rA.tokens == jA.tokens and rB.tokens == jB.tokens


def test_sampling_deterministic_and_slot_independent(models):
    """Same (prompt, seed) -> same tokens whatever the neighbours or slot; a
    different seed diverges."""
    _, pm = models
    rng = np.random.RandomState(2)
    p = rng.randint(0, 1024, (6,)).astype(np.int64)
    other = rng.randint(0, 1024, (11,)).astype(np.int64)

    eng1 = _engine(pm, slot_count=2, ladder=(8, 16))
    solo = eng1.submit(p, max_new_tokens=8, temperature=0.8, top_k=50,
                       top_p=0.9, seed=7)
    eng1.run()

    eng2 = _engine(pm, slot_count=3, ladder=(8, 16))
    n1 = eng2.submit(other, max_new_tokens=8, temperature=0.0)
    n2 = eng2.submit(other, max_new_tokens=8, temperature=1.2, top_k=5, seed=3)
    crowded = eng2.submit(p, max_new_tokens=8, temperature=0.8, top_k=50,
                          top_p=0.9, seed=7)
    reseeded = eng2.submit(p, max_new_tokens=8, temperature=0.8, top_k=50,
                           top_p=0.9, seed=8)
    eng2.run()
    assert crowded.tokens == solo.tokens
    assert reseeded.tokens != solo.tokens
    assert n1.done and n2.done
    for r in (solo, crowded, reseeded, n2):
        assert len(r.tokens) == 8 and all(0 <= t < 1024 for t in r.tokens)


def test_gumbel_draws_follow_softmax():
    """4000 positions of one stream family: empirical frequencies within
    0.03 of softmax(logits) (about 4 standard errors)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, 0.5]])
    n = 4000
    noise = gumbel_noise([11] * n, list(range(n)), 5)
    toks = sample_tokens(logits.expand(n, 5), noise, [1.0] * n, [0] * n, [1.0] * n)
    freq = torch.bincount(toks, minlength=5).float() / n
    assert (freq - torch.softmax(logits[0], -1)).abs().max().item() < 0.03
    again = sample_tokens(logits.expand(n, 5), gumbel_noise([11] * n, list(range(n)), 5),
                          [1.0] * n, [0] * n, [1.0] * n)
    assert torch.equal(toks, again)


def test_greedy_rows_take_argmax_first_on_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    assert sample_tokens(logits, None, [0.0, 0.0], [0, 0], [1.0, 1.0]).tolist() == [1, 0]


@pytest.mark.parametrize("top_k,top_p", [
    ([0, 0, 0, 0], [1.0, 1.0, 1.0, 1.0]),
    ([5, 1, 50, 0], [1.0, 1.0, 1.0, 1.0]),
    ([0, 0, 0, 0], [0.9, 0.5, 0.1, 0.99]),
    ([10, 3, 0, 100], [0.8, 0.95, 0.5, 0.7]),
])
def test_filter_topk_topp_matches_jax(top_k, top_p):
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    logits = rng.randn(4, 50).astype(np.float32) * 3
    want = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(top_k, jnp.int32),
                                 jnp.asarray(top_p, jnp.float32)))
    got = filter_topk_topp(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-6, rtol=0)


@pytest.mark.parametrize("ladder", [(64, 128, 256, 512), (8, 16, 32), (100,), (512, 8, 8)])
def test_bucketing_matches_jax(ladder):
    for max_len, reserve in ((1024, 32), (128, 16), (64, 60), (16, 0)):
        assert (bucketing.clip_ladder(ladder, max_len, reserve)
                == jax_bucketing.clip_ladder(ladder, max_len, reserve))
    for n in range(1, 600, 7):
        try:
            want = jax_bucketing.bucket_for(n, ladder)
        except ValueError:
            with pytest.raises(ValueError):
                bucketing.bucket_for(n, ladder)
            continue
        assert bucketing.bucket_for(n, ladder) == want
        assert bucketing.resolve_bucket(n, ladder) == jax_bucketing.resolve_bucket(n, ladder)
    assert bucketing.DEFAULT_LADDER == jax_bucketing.DEFAULT_LADDER
    with pytest.raises(ValueError):
        bucketing.bucket_for(0, ladder)
    with pytest.raises(TypeError):
        bucketing.resolve_bucket(4, True)


def test_score_prompt_matches_model_forward(models):
    """The bucketed prefill (dense masked path, right-padded) gives the
    causal forward's last-position logits."""
    _, pm = models
    prompt = np.random.RandomState(6).randint(0, 1024, (13,)).astype(np.int64)
    eng = _engine(pm)
    got = eng.score_prompt(prompt)
    with torch.no_grad():
        want = pm.logits(torch.from_numpy(prompt)[None])[0, -1]
    assert (got - want).abs().max().item() < 1e-5


def test_refresh_params_snapshots_weights(models):
    _, pm = models
    model = GPTForPretraining(gpt_tiny(), device="cpu")
    model.load_state_dict(pm.state_dict())
    prompt = np.arange(1, 10, dtype=np.int64)
    eng = _engine(model)
    before = eng.score_prompt(prompt)
    with torch.no_grad():
        model.gpt.ln_f.bias.add_(1.0)
    assert torch.equal(eng.score_prompt(prompt), before)
    eng.refresh_params()
    assert not torch.equal(eng.score_prompt(prompt), before)


@pytest.mark.parametrize("kw", [{"kv_layout": "ragged"},
                                {"kv_layout": "paged", "kv_cache_dtype": "fp8"}],
                         ids=["layout", "page_dtype"])
def test_engine_rejects_unported_layouts(models, kw):
    """An unknown KV layout or page dtype raises ValueError, as the JAX
    engine's constructor does."""
    jm, pm = models
    for cls, model in ((JaxEngine, jm), (ServingEngine, pm)):
        with pytest.raises(ValueError):
            _engine(model, cls, **kw)
