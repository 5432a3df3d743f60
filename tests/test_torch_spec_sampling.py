"""The arithmetic of speculative decoding in paddle_tpu_torch against the
JAX package's, and its sampling held to its distribution.

- ``engine.spec_commit`` (greedy) against the JAX engine's
  ``ServingEngine._spec_commit``, called unbound with only ``max_seq_len``
  on ``self``, on seeded random logits: every output equal exactly.
- ``sampling.filtered_probs`` within 1e-6 (f32) of JAX's.
- ``kv_pages.truncate_row`` against JAX's on one scripted table.
- The sampled rule is exact in distribution: with the draft's proposals and
  the acceptance uniforms and residual draws of ``sampling.spec_draws``, the
  first emitted token of 4000 seeds follows p_t (chi-square, p > 1e-3; the
  draws are fixed by their seeds, so the test is deterministic).
- A spec engine's sampled rows: the non-spec ones give the engine's tokens
  without a draft exactly; the spec ones repeat bit for bit and do not
  depend on the slot. (Sampled tokens differ from JAX's by design.)
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_pages as jax_kvp
from paddle_tpu.serving.sampling import filtered_probs as jax_filtered_probs
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny
from paddle_tpu_torch.serving import ServingEngine, kv_pages, sampling
from paddle_tpu_torch.serving.engine import spec_commit

NO_EOS = -1
PROB_TOL = 1e-6      # f32 softmax of the same masked logits
P_VALUE = 1e-3       # chi-square test of the sampled rule


def _commit_case(seed, k=4, V=16, T=32):
    """One batch of windows that covers each branch of the commit: full,
    partial and zero acceptance, a row that drafts nothing, an inactive row,
    an EOS at each column, a budget cut and a row that reaches T."""
    rng = np.random.RandomState(seed)
    rows = []

    def row(accept_n, n_draft, active=True, eos_col=None, remaining=20, off=None):
        rows.append(dict(accept_n=accept_n, n_draft=n_draft, active=active,
                         eos_col=eos_col, remaining=remaining,
                         off=rng.randint(0, T - k - 2) if off is None else off))

    row(k, k)                        # the whole window accepted
    row(2, k)                        # partial
    row(0, k)                        # the first proposal rejected
    row(0, 0)                        # a non-spec row
    row(k, k, active=False)          # an idle slot
    for j in range(k + 1):           # an EOS at each column
        row(k, k, eos_col=j)
    row(k, k, remaining=2)           # the budget cuts the window
    row(k, k, off=T - 3)             # the frontier reaches T
    S = len(rows)
    logits = rng.randn(S, k + 1, V).astype(np.float32)
    greedy = logits.argmax(-1)
    props = np.empty((S, k), np.int64)
    for i, r in enumerate(rows):
        for j in range(k):
            agree = j < r["accept_n"]
            props[i, j] = greedy[i, j] if agree else (greedy[i, j] + 1 + rng.randint(V - 1)) % V
    eos = np.array([greedy[i, r["eos_col"]] if r["eos_col"] is not None else NO_EOS
                    for i, r in enumerate(rows)])
    return {"logits": logits, "props": props,
            "off": np.array([r["off"] for r in rows]),
            "tok": rng.randint(0, V, S), "active": np.array([r["active"] for r in rows]),
            "n_draft": np.array([r["n_draft"] for r in rows]), "eos": eos,
            "remaining": np.array([r["remaining"] for r in rows]), "T": T, "k": k}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_spec_commit_equals_jax(seed):
    c = _commit_case(seed)
    S = len(c["off"])
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    want = JaxEngine._spec_commit(
        SimpleNamespace(max_seq_len=c["T"]), jax, jnp, jnp.asarray(c["logits"]), None,
        i32(c["props"]), i32(c["off"]), i32(c["tok"]), jnp.asarray(c["active"]),
        i32(c["n_draft"]), jnp.zeros(S, jnp.float32), i32(np.zeros(S)),
        jnp.ones(S, jnp.float32), i32(c["eos"]), i32(c["remaining"]),
        i32(np.zeros(S)), c["k"], True)
    t = torch.from_numpy
    got = spec_commit(t(c["logits"]), t(c["props"]), t(c["off"]), t(c["tok"]),
                      t(c["active"]), t(c["n_draft"]), t(c["eos"]),
                      t(c["remaining"]), c["T"])
    names = ("new_off", "new_tok", "new_active", "new_remaining", "emit", "m", "a",
             "hit_eos")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    m, a = got[5].numpy(), got[6].numpy()
    # the batch reaches every branch
    assert set(a[:3]) == {4, 2, 0} and m[4] == 0 and m[-2] == 2
    assert not got[2][-1] and got[7][5:10].all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.5, 3, 0.9), (1e-7, 0, 1.0)])
def test_filtered_probs_matches_jax(temperature, top_k, top_p):
    rng = np.random.RandomState(11)
    logits = (rng.randn(6, 40) * 3).astype(np.float32)
    n = logits.shape[0]
    want = np.asarray(jax_filtered_probs(jnp.asarray(logits), jnp.full(n, temperature),
                                         jnp.full(n, top_k), jnp.full(n, top_p)))
    got = sampling.filtered_probs(torch.from_numpy(logits), [temperature] * n,
                                  [top_k] * n, [top_p] * n).numpy()
    np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)


def test_truncate_row_follows_jax():
    """One scripted table: rows with shared, own and unallocated entries,
    truncated at several frontiers; the tables, slot page lists, release
    calls and counts of both packages."""
    table = np.zeros((3, 6), np.int32)
    table[0, :5] = [7, 8, 2, 9, 4]       # slot 0: five pages
    table[1, :2] = [3, 5]
    table[1, 4] = 6                      # a hole at index 2-3
    script = [(0, 3), (1, 1), (0, 5), (2, 0), (0, 0)]
    out = []
    for truncate in (jax_kvp.truncate_row, kv_pages.truncate_row):
        tables = table.copy()
        slot_pages = [[int(p) for p in row if p] for row in table]
        released, counts = [], []
        for slot, keep in script:
            counts.append(truncate(tables, slot_pages[slot], released.append, slot, keep))
        out.append((tables, slot_pages, released, counts))
    (jt, jp, jr, jc), (pt, pp, pr, pc) = out
    np.testing.assert_array_equal(pt, jt)
    assert (pp, pr, pc) == (jp, jr, jc)
    assert pc == [2, 2, 0, 0, 3] and not pt[0].any()


def test_sampled_rule_is_exact_in_distribution():
    """k = 1, V = 16, fixed p_t and p_d: the draft proposes from p_d, and
    acceptance, residual and bonus draws come from ``spec_draws``. The first
    emitted token must follow p_t."""
    V, k, n = 16, 1, 4000
    rng = np.random.RandomState(3)
    p_t = rng.dirichlet(np.ones(V)).astype(np.float32)
    p_d = rng.dirichlet(np.ones(V) * 0.5).astype(np.float32)
    seeds = np.arange(n)
    offsets = rng.randint(0, 500, n)
    n_draft = np.full(n, k)
    dnoise, uniforms, pnoise = sampling.spec_draws(seeds, offsets, n_draft,
                                                   np.ones(n, bool), k, V)
    temps, top_k, top_p = torch.ones(n), torch.zeros(n, dtype=torch.long), torch.ones(n)
    d_logits = torch.log(torch.from_numpy(p_d)).expand(n, V)
    props = sampling.sample_tokens(d_logits, dnoise[0], temps, top_k, top_p)[:, None]
    logits = torch.log(torch.from_numpy(p_t)).expand(n, k + 1, V)
    ones = torch.ones(n, dtype=torch.long)
    out = spec_commit(logits, props, torch.from_numpy(offsets), ones,
                      torch.ones(n, dtype=torch.bool), torch.from_numpy(n_draft),
                      torch.full((n,), NO_EOS), ones * 10, 1024,
                      dlogits=d_logits[:, None], temps=temps, top_k=top_k,
                      top_p=top_p, uniforms=uniforms, noise=pnoise)
    first, a = out[4][:, 0].numpy(), out[6].numpy()
    counts = np.bincount(first, minlength=V)
    assert stats.chisquare(counts, _expected(p_t, n)).pvalue > P_VALUE
    # both branches ran: proposals accepted, and rejections resampled
    assert 0.2 < a.mean() < 0.95
    # the proposals themselves follow p_d (the draft's stream)
    pc = np.bincount(props[:, 0].numpy(), minlength=V)
    assert stats.chisquare(pc, _expected(p_d, n)).pvalue > P_VALUE


def _expected(p, n):
    p = p.astype(np.float64)
    return n * p / p.sum()


@pytest.fixture(scope="module")
def port_models():
    return (GPTForPretraining(gpt_tiny(), device="cpu", seed=0),
            GPTForPretraining(gpt_tiny(), device="cpu", seed=1))


def _engine(target, draft, paged, slots=2):
    kw = dict(slot_count=slots, ladder=(8, 16), max_new_cap=16, steps_per_dispatch=4,
              draft_model=draft, spec_ladder=(4,))
    if paged:
        kw.update(kv_layout="paged", kv_page_tokens=8)
    return ServingEngine(target, **kw)


SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_nonspec_sampled_rows_unchanged_by_spec_neighbours(port_models, paged):
    """A sampled request without speculation, seated beside a speculating
    one, gives exactly its tokens in an engine without a draft: its verify
    column 0 draws from the decode step's stream."""
    target, draft = port_models
    rng = np.random.RandomState(7)
    p, other = (rng.randint(0, 1024, (n,)).astype(np.int64) for n in (6, 9))
    plain = _engine(target, None, paged)
    solo = plain.submit(p, max_new_tokens=10, seed=7, **SAMPLED)
    plain.run()
    eng = _engine(target, draft, paged)
    spec = eng.submit(other, max_new_tokens=10, temperature=0.0, speculate_k=4)
    crowd = eng.submit(p, max_new_tokens=10, seed=7, **SAMPLED)
    eng.run()
    assert crowd.tokens == solo.tokens
    assert spec.spec_proposed > 0 and crowd.spec_proposed == 0


def test_sampled_spec_repeats_and_ignores_the_slot(port_models):
    """A sampled speculating request gives the same tokens in a fresh engine,
    and in another slot beside other traffic."""
    target, draft = port_models
    rng = np.random.RandomState(8)
    p, a, b = (rng.randint(0, 1024, (n,)).astype(np.int64) for n in (7, 5, 12))

    def serve(first):
        eng = _engine(target, draft, paged=False, slots=3)
        reqs = [eng.submit(q, max_new_tokens=12, seed=3, speculate_k=4, **SAMPLED)
                for q in first]
        mine = eng.submit(p, max_new_tokens=12, seed=11, speculate_k=4, **SAMPLED)
        eng.run()
        assert all(r.done for r in reqs)
        return mine

    alone, again, crowded = serve([]), serve([]), serve([a, b])
    assert alone.slot == 0 and crowded.slot == 2
    assert alone.tokens == again.tokens == crowded.tokens
    assert alone.spec_proposed > 0
    assert (alone.spec_accepted, alone.spec_bonus) == (again.spec_accepted, again.spec_bonus)
