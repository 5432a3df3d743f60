"""``GPTForPretraining.generate`` and ``generate_beam``: paddle_tpu_torch
against the JAX model's decode on the same weights.

gpt_tiny at f32, weights from ``paddle.seed(0)`` carried over by
models/convert.py, prompts from numpy. Greedy and beam tokens must equal
JAX's exactly (the first maximum wins a tie in both; the beams' top K is a
stable sort, as jax.lax.top_k breaks ties toward the lower index). Sampled
tokens come from the port's seeded Gumbel streams (serving/sampling.py), so
they are held to determinism, to the serving engine's tokens for the same
stream, and to the top-k / top-p support, not to JAX's draws.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import set_hybrid_communicate_group
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving.sampling import filter_topk_topp


@pytest.fixture(scope="module")
def models():
    set_hybrid_communicate_group(None)
    paddle.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    state = {n: np.asarray(v._data) for n, v in jm.state_dict().items()}
    return jm, load_jax_state(GPTForPretraining(gpt_tiny(), device="cpu"), state)


def _prompts(b=3, n=11, seed=0):
    return np.random.RandomState(seed).randint(0, 1024, (b, n)).astype(np.int64)


def _jax(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw)._data)


def _port(pm, ids, **kw):
    return pm.generate(torch.from_numpy(ids), **kw).numpy()


def _an_emitted_token(jm, ids, new):
    """A token the greedy decode emits mid-way in row 0: as eos it ends that
    row early and others later or never."""
    return int(_jax(jm, ids, max_new_tokens=new, temperature=0)[0, ids.shape[1] + 2])


@pytest.mark.parametrize("case", ["plain", "eos", "bucket", "one_token"])
def test_greedy_tokens_equal_jax(models, case):
    jm, pm = models
    ids = _prompts(seed=1)
    kw = dict(max_new_tokens=1 if case == "one_token" else 12, temperature=0)
    if case == "eos":
        kw["eos_token_id"] = _an_emitted_token(jm, ids, 12)
    if case == "bucket":
        kw["prompt_bucket"] = (16, 32)
    want = _jax(jm, ids, **kw)
    got = _port(pm, ids, **kw)
    assert got.shape == want.shape == (3, 11 + kw["max_new_tokens"])
    np.testing.assert_array_equal(got, want)
    if case == "eos":
        row = got[0, 11:]
        hit = int(np.argmax(row == kw["eos_token_id"]))
        assert hit < len(row) - 1 and (row[hit:] == kw["eos_token_id"]).all()
    if case == "bucket":
        np.testing.assert_array_equal(got, _port(pm, ids, max_new_tokens=12,
                                                 temperature=0))
    assert pm.training


@pytest.mark.parametrize("num_beams,length_penalty,eos", [
    (2, 1.0, False), (4, 1.0, True), (4, 0.6, True), (2, 0.6, False)])
def test_beam_tokens_equal_jax(models, num_beams, length_penalty, eos):
    jm, pm = models
    ids = _prompts(b=2, n=9, seed=2)
    kw = dict(max_new_tokens=10, num_beams=num_beams, length_penalty=length_penalty)
    if eos:
        kw["eos_token_id"] = _an_emitted_token(jm, ids, 10)
    want = _jax(jm, ids, **kw)
    got = _port(pm, ids, decode_strategy="beam_search", **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port(pm, ids, **kw), got)


def test_sampling_is_seeded_and_stays_in_the_top_k_top_p_support(models):
    _, pm = models
    ids = _prompts(b=4, seed=3)
    kw = dict(max_new_tokens=10, temperature=0.9, top_k=40, top_p=0.8)
    a = _port(pm, ids, seed=5, **kw)
    np.testing.assert_array_equal(a, _port(pm, ids, seed=5, **kw))
    assert not np.array_equal(a, _port(pm, ids, seed=6, **kw))
    # the support at each position, from the full forward of the sequence
    with torch.no_grad():
        pm.eval()
        logits = pm(torch.from_numpy(a)).float()
        pm.train()
    for t in range(11, a.shape[1]):
        lg = logits[:, t - 1] / kw["temperature"]
        support = torch.isfinite(filter_topk_topp(lg, [kw["top_k"]] * 4,
                                                  [kw["top_p"]] * 4))
        assert support[torch.arange(4), torch.from_numpy(a[:, t])].all(), t
        assert (support.sum(-1) <= kw["top_k"]).all()


def test_sampled_rows_draw_the_serving_engine_streams(models):
    """Row i of generate(seed=s) draws the stream of a ServingEngine request
    of seed s + i: the same tokens for the same prompts."""
    _, pm = models
    ids = _prompts(b=3, seed=4)
    got = _port(pm, ids, max_new_tokens=8, temperature=0.7, top_k=50, seed=10)
    eng = ServingEngine(pm, slot_count=2, ladder=(16, 32), max_new_cap=16)
    reqs = [eng.submit(ids[i], max_new_tokens=8, temperature=0.7, top_k=50, seed=10 + i)
            for i in range(3)]
    eng.run()
    assert [r.tokens for r in reqs] == got[:, 11:].tolist()


def test_bf16_decode_casts_weights_once_and_keeps_a_bf16_cache(models, monkeypatch):
    _, pm = models
    ids = _prompts(b=2, seed=5)
    seen = {}
    body = GPTForPretraining._decode_body

    def spy(self, params, x, caches):
        seen.setdefault("dtypes", {n: p.dtype for n, p in params.items()})
        seen.setdefault("cache", caches[0][0].dtype)
        return body(self, params, x, caches)

    monkeypatch.setattr(GPTForPretraining, "_decode_body", spy)
    with auto_cast(dtype="bfloat16"):
        out = _port(pm, ids, max_new_tokens=4, temperature=0)
    assert out.shape == (2, 15)
    assert seen["cache"] == torch.bfloat16
    assert seen["dtypes"]["wte.weight"] == torch.bfloat16
    assert seen["dtypes"]["blocks.0.attn.qkv_proj.weight"] == torch.bfloat16
    assert seen["dtypes"]["blocks.0.attn.qkv_proj.bias"] == torch.float32
    assert seen["dtypes"]["ln_f.weight"] == torch.float32
    assert pm.gpt.wte.weight.dtype == torch.float32        # the model keeps its own


def test_the_reference_errors(models):
    _, pm = models
    ids = torch.from_numpy(_prompts(b=1, n=100))
    with pytest.raises(ValueError, match="decode_strategy must be"):
        pm.generate(ids, decode_strategy="nucleus")
    with pytest.raises(ValueError, match="needs num_beams >= 2"):
        pm.generate(ids, decode_strategy="beam_search", num_beams=1)
    with pytest.raises(ValueError, match="prompt_bucket is not supported"):
        pm.generate(ids, num_beams=2, prompt_bucket=128)
    with pytest.raises(ValueError, match="conflicts with"):
        pm.generate(ids, decode_strategy="sampling", num_beams=3)
    with pytest.raises(ValueError, match="exceeds max_seq_len 128"):
        pm.generate(ids, max_new_tokens=29)
    with pytest.raises(ValueError, match=r"\(bucketed\) \+ max_new_tokens 8 exceeds"):
        pm.generate(ids, max_new_tokens=8, prompt_bucket=128)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        pm.generate_beam(ids, max_new_tokens=29, num_beams=2)
    assert pm.training
