"""Speculative decoding in paddle_tpu_torch's ServingEngine against the JAX
package's engine.

Both packages serve ``gpt_tiny`` at tests/test_speculative_decoding.py's
sizes (3 slots, ladder (8, 16, 32), max_new_cap 16, steps_per_dispatch 4,
spec_ladder (4,)), with the target's weights from JAX ``paddle.seed(0)`` and
the draft's from ``paddle.seed(1)``, carried into the port by
``models.load_jax_state``; the self draft is the target itself. Each
scenario's JAX engine runs once (a module-scoped cache). Compared exactly:
greedy tokens, finish reasons, every request's ``spec_proposed``,
``spec_accepted`` and ``spec_bonus``, and the deltas of the ``serving.*``
counters a verify dispatch moves. Greedy speculative tokens must also equal
the port's engine without a draft and ``generate``'s.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import monitor as jax_monitor
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.models import (GPTConfig, GPTForPretraining, gpt_tiny,
                                     load_jax_state)
from paddle_tpu_torch.serving import ServingEngine

COUNTERS = ("serving.verify_dispatches", "serving.spec.proposed",
            "serving.spec.accepted", "serving.spec.bonus",
            "serving.draft_prefill_dispatches", "serving.prefill_dispatches",
            "serving.prefill_skips", "serving.steps", "serving.tokens",
            "serving.requests")


def _jax_model(seed):
    paddle.seed(seed)
    m = JaxGPT(jax_gpt_tiny())
    m.eval()
    return m


def _port_of(jm):
    state = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    return load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)


@pytest.fixture(scope="module")
def models():
    """{"jax": (target, draft), "port": (target, draft)}."""
    from paddle_tpu.distributed.mesh import set_hybrid_communicate_group

    set_hybrid_communicate_group(None)
    jt, jd = _jax_model(0), _jax_model(1)
    return {"jax": (jt, jd), "port": (_port_of(jt), _port_of(jd))}


def _engine(cls, target, draft, paged=False, **kw):
    args = dict(slot_count=3, ladder=(8, 16, 32), max_new_cap=16,
                steps_per_dispatch=4, draft_model=draft, spec_ladder=(4,))
    if paged:
        args.update(max_new_cap=8, max_seq_len=48, kv_layout="paged",
                    kv_page_tokens=8)
    args.update(kw)
    return cls(target, **args)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 1024, (n,)).astype(np.int64) for n in lengths]


def _mixed_work():
    """The reference test's mix: spec and non-spec greedy slots sharing the
    verify dispatches."""
    return [{"prompt": p, "max_new_tokens": 8, "speculate_k": 4 if i % 2 == 0 else 0}
            for i, p in enumerate(_prompts(0, (5, 7, 9, 12, 3, 17)))]


def _bf16_work():
    """The bf16 engines' prompts: those of test_torch_paged_serving.py's
    bf16 test, on which the two packages' bf16 engines without a draft give
    the same tokens. On ``_mixed_work``'s 17-token prompt they part at a
    one-ulp tie of the bf16 logits (f32 logits 1.2381 and 1.2300 for the two
    tokens), with or without a draft."""
    return [{"prompt": p, "max_new_tokens": 8, "speculate_k": 4 if i % 2 == 0 else 0}
            for i, p in enumerate(_prompts(7, (5, 11, 16, 23)))]


def _eos_request(port_target):
    """A request whose eos is the third token of its own greedy stream: it
    fires inside a verify window (the reference's EOS test)."""
    p = _prompts(2, (6,))[0]
    gen = _generate(port_target, p, 10)[len(p):]
    return {"prompt": p, "max_new_tokens": 10, "speculate_k": 4,
            "eos_token_id": int(gen[2])}


def _paged_work():
    """Two passes: a 16-token prompt (two whole pages) that speculates, a
    5-token one that does not, and an 11-token one that speculates across
    the page boundary at position 16 (a rejected window there leaves a page
    for truncate_row); the second pass replays the first's pages (a full-hit
    seat that takes a spec rung)."""
    prompt = _prompts(3, (16,))[0]
    short, cross = _prompts(4, (5, 11))
    one = [{"prompt": prompt, "max_new_tokens": 5, "speculate_k": 4},
           {"prompt": short, "max_new_tokens": 5},
           {"prompt": cross, "max_new_tokens": 8, "speculate_k": 4}]
    return [one, one]


def _generate(model, prompt, n_new, eos=None):
    out = model.generate(torch.from_numpy(prompt)[None], max_new_tokens=n_new,
                         temperature=0.0, eos_token_id=eos)
    return out[0].numpy()


def _counter(read, name):
    return read().get(name, {}).get("value", 0)


def _serve(eng, passes, read):
    """Submit each pass and run it; the requests, the counter deltas and
    the engine."""
    c0 = {n: _counter(read, n) for n in COUNTERS}
    reqs = []
    for work in passes:
        reqs += [eng.submit(w["prompt"], max_new_tokens=w["max_new_tokens"],
                            temperature=0.0, eos_token_id=w.get("eos_token_id"),
                            speculate_k=w.get("speculate_k", 0)) for w in work]
        eng.run()
    deltas = {n: _counter(read, n) - c0[n] for n in COUNTERS}
    return {"reqs": reqs, "counters": deltas, "engine": eng,
            "tokens": [[int(t) for t in r.tokens] for r in reqs],
            "finish": [r.finish_reason for r in reqs],
            "spec": [(r.spec_proposed, r.spec_accepted, r.spec_bonus) for r in reqs]}


SCENARIOS = ("contiguous_draft", "contiguous_self", "paged_draft", "paged_self",
             "bf16_draft")


@pytest.fixture(scope="module")
def runs(models):
    """scenario -> {"jax": result, "port": result}, each engine run once."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        paged = name.startswith("paged")
        out = {}
        for pkg, cls, read, cast in (
                ("jax", JaxEngine, lambda: jax_monitor.registry().report(),
                 lambda: paddle.amp.auto_cast(dtype="bfloat16")),
                ("port", ServingEngine, lambda: monitor.registry().report(),
                 lambda: auto_cast(dtype="bfloat16"))):
            target, draft = models[pkg]
            if name.endswith("_self"):
                draft = target
            passes = _paged_work() if paged else [_mixed_work()]
            if name == "contiguous_self":
                passes[0] = passes[0] + [_eos_request(models["port"][0])]
            if name.startswith("bf16"):
                passes = [_bf16_work()]
                # the JAX engine traces its programs at their first call, so
                # it runs inside the block; the port's runs outside it, on
                # the autocast it captured
                with cast():
                    eng = _engine(cls, target, draft)
                    if pkg == "jax":
                        out[pkg] = _serve(eng, passes, read)
                if pkg == "port":
                    out[pkg] = _serve(eng, passes, read)
            else:
                out[pkg] = _serve(_engine(cls, target, draft, paged=paged), passes, read)
        cache[name] = out
        return out

    return get


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_spec_engine_follows_jax(runs, scenario):
    """Greedy tokens, finish reasons, per-request spec counts and the
    counters' deltas equal the JAX engine's."""
    r = runs(scenario)
    jax_r, port_r = r["jax"], r["port"]
    assert port_r["tokens"] == jax_r["tokens"]
    assert port_r["finish"] == jax_r["finish"]
    assert port_r["spec"] == jax_r["spec"]
    assert port_r["counters"] == jax_r["counters"]
    assert port_r["counters"]["serving.verify_dispatches"] > 0
    assert all(r.done for r in port_r["reqs"])


@pytest.mark.parametrize("scenario", ["contiguous_draft", "contiguous_self",
                                      "paged_draft", "paged_self"])
def test_spec_tokens_equal_plain_engine_and_generate(runs, models, scenario):
    """Acceptance moves only which dispatch scores a position: the port's
    greedy spec tokens equal its engine's without a draft, and generate's."""
    port_r = runs(scenario)["port"]
    target, _ = models["port"]
    paged = scenario.startswith("paged")
    passes = _paged_work() if paged else [_mixed_work()]
    if scenario == "contiguous_self":
        passes[0] = passes[0] + [_eos_request(target)]
    plain = _serve(_engine(ServingEngine, target, None, paged=paged),
                   [[{k: v for k, v in w.items() if k != "speculate_k"} for w in work]
                    for work in passes], lambda: monitor.registry().report())
    assert port_r["tokens"] == plain["tokens"]
    for w, r in zip([w for work in passes for w in work], port_r["reqs"]):
        want = _generate(target, w["prompt"], w["max_new_tokens"],
                         w.get("eos_token_id"))
        n = len(r.output_ids())
        np.testing.assert_array_equal(r.output_ids(), want[:n])


def test_self_draft_accepts_everything(runs):
    """draft == target: every proposal is accepted, so the speculating
    requests finish in fewer target forwards than tokens."""
    port_r = runs("contiguous_self")["port"]
    spec = [s for s, r in zip(port_r["spec"], port_r["reqs"])
            if r.speculate_k and r.eos_token_id is None]
    assert spec and all(p > 0 and a == p for p, a, _ in spec)
    assert port_r["counters"]["serving.steps"] < port_r["counters"]["serving.tokens"]


def test_eos_inside_the_window_cuts_there(runs, models):
    """The eos request stops at its eos, which its window emitted mid-way:
    the same tokens and finish reason as JAX, and as sequential greedy."""
    r = runs("contiguous_self")
    got, want = r["port"]["reqs"][-1], r["jax"]["reqs"][-1]
    assert got.finish_reason == want.finish_reason == "eos"
    assert got.tokens == [int(t) for t in want.tokens]
    assert got.tokens[-1] == got.eos_token_id and len(got.tokens) < 10
    gen = _generate(models["port"][0], got.prompt_ids, 10)[len(got.prompt_ids):]
    cut = int(np.where(gen == got.eos_token_id)[0][0]) + 1
    assert got.tokens == [int(t) for t in gen[:cut]]


@pytest.mark.parametrize("scenario", ["paged_draft", "paged_self"])
def test_paged_spec_leaves_no_page_in_use(runs, scenario):
    """After the run no page is held; the second pass's spec request was a
    full-hit replay seat; the seed-1 draft's rejections were rolled back
    through truncate_row."""
    r = runs(scenario)
    eng, jeng = r["port"]["engine"], r["jax"]["engine"]
    st = eng.stats()
    assert st["pages_in_use"] == 0 == jeng.stats()["pages_in_use"]
    assert st["pages_cached"] == jeng.stats()["pages_cached"]
    assert st["prefix"] == jeng.stats()["prefix"]
    assert st["prefix"]["full_hits"] >= 1
    assert r["port"]["reqs"][3].prefix_hit and r["port"]["reqs"][3].tail_bucket == 0
    if scenario == "paged_draft":
        assert eng.rollback_pages > 0
    assert not any(pool[0].any() for pool in eng._pool_state["k"])


def test_bf16_draft_cache_and_weights_follow_jax(runs):
    """Built under auto_cast(bfloat16): the draft's cache and weight
    matrices are bf16 as JAX's ``_dkcs`` and ``_dparams`` are; its norms and
    biases stay f32."""
    r = runs("bf16_draft")
    eng, jeng = r["port"]["engine"], r["jax"]["engine"]
    assert eng._dkcs[0].dtype == torch.bfloat16
    assert str(jeng._dkcs[0].dtype) == "bfloat16"
    qkv = eng._dnet.gpt.blocks[0].attn.qkv_proj
    assert qkv.weight.dtype == torch.bfloat16 and qkv.bias.dtype == torch.float32
    assert str(jeng._dparams["gpt.blocks.0.attn.qkv_proj.weight"].dtype) == "bfloat16"
    assert str(jeng._dparams["gpt.blocks.0.attn.qkv_proj.bias"].dtype) == "float32"
    assert len(eng._dkcs) == len(jeng._dkcs)
    assert tuple(eng._dkcs[0].shape) == tuple(jeng._dkcs[0].shape)


def test_stats_carries_the_spec_ladder(models):
    jt, jd = models["jax"]
    pt, pd = models["port"]
    jeng = _engine(JaxEngine, jt, jd, spec_ladder=(4, 2))
    peng = _engine(ServingEngine, pt, pd, spec_ladder=(4, 2))
    assert peng.stats()["spec_ladder"] == jeng.stats()["spec_ladder"] == (2, 4)
    assert "spec_ladder" not in _engine(ServingEngine, pt, None).stats()
    jkeys = {k for k in jeng.stats() if not k.endswith("_executables")}
    assert set(peng.stats()) == jkeys


def _bad_vocab(pkg):
    if pkg == "jax":
        paddle.seed(2)
        m = JaxGPT(JaxGPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                                num_heads=4, max_seq_len=128))
        m.eval()
        return m
    return GPTForPretraining(GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                                       num_heads=4, max_seq_len=128), device="cpu")


ERRORS = {   # case -> how it is made to fail, given (engine class, target, draft, pkg)
    "draft_vocab": lambda cls, t, d, pkg: _engine(cls, t, _bad_vocab(pkg)),
    "empty_ladder": lambda cls, t, d, pkg: _engine(cls, t, d, spec_ladder=()),
    "rung_below_one": lambda cls, t, d, pkg: _engine(cls, t, d, spec_ladder=(0, 4)),
    "speculate_without_draft": lambda cls, t, d, pkg: _engine(cls, t, None).submit(
        np.arange(5, dtype=np.int64), speculate_k=4),
    "negative_speculate_k": lambda cls, t, d, pkg: _engine(cls, t, d).submit(
        np.arange(5, dtype=np.int64), speculate_k=-1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_spec_errors_raise_as_jax(models, case):
    """Each bad argument raises the JAX engine's exception type (ValueError)
    in both packages."""
    raised = []
    for pkg, cls in (("jax", JaxEngine), ("port", ServingEngine)):
        target, draft = models[pkg]
        with pytest.raises(Exception) as info:
            ERRORS[case](cls, target, draft, pkg)
        raised.append(type(info.value))
    assert raised[0] is raised[1] is ValueError


def test_draft_on_another_device_raises(models):
    """The engine never moves a draft: one on another device than the
    target's is refused."""
    target, _ = models["port"]
    elsewhere = GPTForPretraining(gpt_tiny(), device="cpu").to("meta")
    with pytest.raises(ValueError, match="device"):
        _engine(ServingEngine, target, elsewhere)
