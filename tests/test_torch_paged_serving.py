"""The paged KV cache, the radix prefix cache and bf16 serving of
paddle_tpu_torch against the JAX package's.

Both packages serve ``gpt_tiny`` with the same weights (JAX from
``paddle.seed(0)``, carried into the port by ``models.load_jax_state``) at
tests/test_paged_serving.py's sizes: 3 slots, ladder (8, 16, 32),
max_seq_len 48, 8-token pages. Tokens are compared exactly: greedy tokens
against JAX's; sampled tokens, which differ from JAX's by design (ROADMAP,
"Sampling decision"), between the port's own paged and contiguous engines.
The page allocator and the trie must return the same pages, refcounts and
stats as JAX's on one scripted sequence; ``update_and_read`` must give the
same pools and gathered K/V (bit for bit at f32 and bf16; equal int8 values
and scales within rtol 1e-6 for int8 pages).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import monitor as jax_monitor
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
from paddle_tpu.serving import PagePool as JaxPagePool
from paddle_tpu.serving import PoolExhausted as JaxPoolExhausted
from paddle_tpu.serving import RadixPrefixCache as JaxTrie
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import kv_pages as jax_kvp
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import monitor
from paddle_tpu_torch.models import GPTForPretraining, gpt_tiny, load_jax_state
from paddle_tpu_torch.serving import (PagePool, PoolExhausted, RadixPrefixCache,
                                      ServingEngine, kv_pages)

RESERVED = kv_pages.RESERVED_PAGES
SCALE_RTOL = 1e-6       # int8 page scales: absmax / 127 in f32 on both sides


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


def _engine(model, cls, paged=True, pool_pages=None, dtype=None, **kw):
    args = dict(slot_count=3, ladder=(8, 16, 32), max_new_cap=8, max_seq_len=48,
                steps_per_dispatch=4)
    args.update(kw)
    if paged:
        args.update(kv_layout="paged", kv_page_tokens=8, kv_num_pages=pool_pages,
                    kv_cache_dtype=dtype)
    return cls(model, **args)


def _pair(models, **kw):
    """(JAX engine, port engine) with the same arguments."""
    jm, pm = models
    return _engine(jm, JaxEngine, **kw), _engine(pm, ServingEngine, **kw)


def _mixed_work(rng, n=6):
    """Half greedy, half sampled (tests/test_paged_serving.py's mix)."""
    work = []
    for i in range(n):
        plen = int(rng.choice([5, 8, 11, 14, 17, 23]))
        work.append({
            "prompt": rng.randint(0, 1024, (plen,)).astype(np.int64),
            "temperature": 0.0 if i % 2 == 0 else 0.8,
            "top_k": 0 if i % 2 == 0 else 50,
            "seed": 1000 + i,
        })
    return work


def _run(eng, work, max_new=5):
    reqs = [eng.submit(w["prompt"], max_new_tokens=max_new,
                       temperature=w["temperature"], top_k=w["top_k"],
                       seed=w["seed"]) for w in work]
    eng.run()
    return [[int(t) for t in r.output_ids()] for r in reqs]


def _greedy(work, outs):
    return [o for w, o in zip(work, outs) if w["temperature"] == 0.0]


def _counter(name):
    return monitor.registry().report().get(name, {}).get("value", 0)


def _jax_counter(name):
    return jax_monitor.registry().report().get(name, {}).get("value", 0)


COUNTERS = ("serving.prefill_dispatches", "serving.prefix_lookups",
            "serving.prefix_hits", "serving.prefill_skips", "serving.steps",
            "serving.tokens", "serving.requests")


def _counts(read):
    return {n: read(n) for n in COUNTERS}


def _stats(eng):
    """stats() without the JAX engine's executable counts (the port
    compiles nothing)."""
    return {k: v for k, v in eng.stats().items() if not k.endswith("_executables")}


# ------------------------------------------------------ allocator and trie
def _pool_and_trie_script(Pool, Trie, Exhausted):
    """One scripted sequence of alloc, incref, decref, park (release of a
    published page), insert, match, evict and flush; a log of every page
    returned, every refcount and every stats() on the way."""
    log = []
    pool = Pool(10)
    trie = Trie(pool, page_tokens=4)

    def snap(what):
        log.append((what, pool.free_count, pool.available, pool.in_use,
                    pool.cached, list(pool.ref), dict(trie.stats())))

    a, b = pool.alloc(), pool.alloc()
    log.append(("alloc", a, b))
    log.append(("incref", pool.incref(a), "decref", pool.decref(a)))
    snap("refs")
    toks = list(range(12))
    pages = [a, b, pool.alloc()]
    trie.insert(toks, pages)
    for p in pages:
        trie.release(p)                  # published: parks, stays cached
    snap("parked")
    log.append(("peek", trie.peek(toks), trie.peek(toks[:7] + [99])))
    got = trie.match(toks[:8] + [99, 98])
    log.append(("match", got))
    snap("matched")
    log.append(("evict", trie.evict(3)))          # only the free leaf goes
    snap("evicted")
    full = trie.match(toks[:8])
    log.append(("match_full", full))
    for p in full:
        trie.release(p)
    other = [pool.alloc() for _ in range(2)]
    trie.insert([7] * 8, other)
    trie.release(other[0])                        # parked, but not a leaf
    log.append(("ensure_free", trie.ensure_free(4), trie.ensure_free(5)))
    trie.release(other[1])
    log.append(("ensure_free", trie.ensure_free(6)))
    snap("ensured")
    for p in got:
        trie.release(p)
    log.append(("flush", trie.flush()))
    snap("flushed")
    while pool.free_count:
        pool.alloc()
    try:
        pool.alloc()
        log.append("no raise")
    except Exhausted:
        log.append("exhausted")
    for bad in (lambda: pool.release(pool.num_pages - 1),
                lambda: Pool(RESERVED)):
        try:
            bad()
            log.append("no raise")
        except (RuntimeError, ValueError) as e:
            log.append(type(e).__name__)
    return log


def test_page_pool_and_trie_follow_jax():
    want = _pool_and_trie_script(JaxPagePool, JaxTrie, JaxPoolExhausted)
    got = _pool_and_trie_script(PagePool, RadixPrefixCache, PoolExhausted)
    assert got == want
    assert ("evict", 1) in got and ("flush", 2) in got and "exhausted" in got
    assert ("ensure_free", True, False) in got and ("ensure_free", True) in got


# ------------------------------------------------------------ int8 pages
def test_quantize_kv_int8_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 8, 4, 16).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                                     # an all-zero head
    jq, js = (np.asarray(a) for a in jax_kvp.quantize_kv_int8(x))
    q, scale = kv_pages.quantize_kv_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and tuple(scale.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_allclose(scale.numpy(), js, rtol=SCALE_RTOL, atol=0)
    # the reference test's bound: half a step of absmax/127 per (…, head)
    err = np.abs(q.numpy().astype(np.float32) * scale.numpy()[..., None] - x)
    bound = np.abs(x).max(-1) / 127 * 0.5 + 1e-6
    assert (err <= bound[..., None] + 1e-6).all()
    assert kv_pages.resolve_store_dtype("auto", torch.float32) == (torch.float32, False)
    assert kv_pages.resolve_store_dtype("bf16", torch.float32) == (torch.bfloat16, False)
    assert kv_pages.resolve_store_dtype("int8", torch.float32) == (torch.int8, True)
    with pytest.raises(ValueError):
        kv_pages.resolve_store_dtype("fp8", torch.float32)


# ------------------------------------------------------- update_and_read
_P, _PT, _NH, _HD = 10, 4, 2, 8


def _pools(rng, store):
    """Random pools (zero page all zero) in the storage dtype, as numpy."""
    if store == "int8":
        k = rng.randint(-127, 128, (_P, _PT, _NH, _HD)).astype(np.int8)
        v = rng.randint(-127, 128, (_P, _PT, _NH, _HD)).astype(np.int8)
        ks = rng.rand(_P, _PT, _NH).astype(np.float32)
        vs = rng.rand(_P, _PT, _NH).astype(np.float32)
        for a in (k, v, ks, vs):
            a[kv_pages.ZERO_PAGE] = 0
        return k, v, ks, vs
    k = rng.randn(_P, _PT, _NH, _HD).astype(np.float32)
    v = rng.randn(_P, _PT, _NH, _HD).astype(np.float32)
    k[kv_pages.ZERO_PAGE] = v[kv_pages.ZERO_PAGE] = 0
    return k, v, None, None


# prefill-like: [b, s] write masks, a row with positions past the table;
# decode-like: one token a row, an idle row
_WRITES = {
    "prefill": ([[2, 3, 0], [4, 5, 0], [6, 7, 8]], [0, 5, 10],
                [[True, True, False], [True, True, True], [True, True, True]], 3),
    "decode": ([[2, 3, 0], [4, 5, 9], [6, 7, 8]], [4, 11, 3],
               [True, False, True], 1),
}


@pytest.mark.parametrize("write", sorted(_WRITES))
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_update_and_read_matches_jax(dtype, write):
    import jax.numpy as jnp

    table, offset, wmask, s = _WRITES[write]
    table = np.asarray(table, np.int32)
    offset = np.asarray(offset, np.int32)
    wmask = np.asarray(wmask, bool)
    rng = np.random.RandomState(1)
    k_pool, v_pool, k_scale, v_scale = _pools(rng, dtype)
    b = table.shape[0]
    k = rng.randn(b, s, _NH, _HD).astype(np.float32) * 2
    v = rng.randn(b, s, _NH, _HD).astype(np.float32) * 2
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))

    def jarr(a, dt=None):
        return None if a is None else jnp.asarray(a if dt is None else a.astype(np.float32), dt)

    jcache = jax_kvp.PagedLayerCache(
        jarr(k_pool, jdt if dtype != "int8" else None),
        jarr(v_pool, jdt if dtype != "int8" else None), jnp.asarray(table),
        jnp.asarray(offset), jnp.asarray(wmask), _PT, jdt,
        jarr(k_scale), jarr(v_scale))
    jkc, jvc, jnew = jax_kvp.update_and_read(jcache, jnp.asarray(k, jdt),
                                             jnp.asarray(v, jdt))

    def tarr(a):
        if a is None:
            return None
        t = torch.from_numpy(a.copy())
        return t.to(tdt) if a.dtype == np.float32 and dtype != "int8" else t

    cache = kv_pages.PagedLayerCache(
        tarr(k_pool), tarr(v_pool), torch.from_numpy(table).long(),
        torch.from_numpy(offset).long(), torch.from_numpy(wmask), _PT, tdt,
        tarr(k_scale), tarr(v_scale))
    kc, vc, new = kv_pages.update_and_read(cache, torch.from_numpy(k).to(tdt),
                                           torch.from_numpy(v).to(tdt))

    def np32(a):
        return np.asarray(jnp.asarray(a, jnp.float32) if a.dtype == jnp.bfloat16 else a)

    def t32(t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    live = np.ones(_P, bool)
    live[kv_pages.SCRATCH_PAGE] = False   # rows race there; it is never read
    pairs = [(new.k_pool, jnew.k_pool), (new.v_pool, jnew.v_pool)]
    if dtype == "int8":
        pairs_scale = [(new.k_scale, jnew.k_scale), (new.v_scale, jnew.v_scale)]
        for got, want in pairs_scale:
            np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                       rtol=SCALE_RTOL, atol=0)
            assert not got[kv_pages.ZERO_PAGE].any()
    for got, want in pairs:
        np.testing.assert_array_equal(t32(got)[live], np32(want)[live])
        assert not got[kv_pages.ZERO_PAGE].any()       # the zero page stays zero
    assert kc.dtype == vc.dtype == tdt
    if dtype == "int8":
        for got, want in ((kc, jkc), (vc, jvc)):
            np.testing.assert_allclose(t32(got), np32(want), rtol=SCALE_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(t32(kc), np32(jkc))
        np.testing.assert_array_equal(t32(vc), np32(jvc))
    assert new.offset.tolist() == (offset + s).tolist()
    assert new.k_pool is cache.k_pool                  # updated in place


# ---------------------------------------------------------------- engine
def test_paged_greedy_tokens_equal_jax_paged_engine(models):
    work = _mixed_work(np.random.RandomState(2))
    jeng, peng = _pair(models)
    assert _greedy(work, _run(peng, work)) == _greedy(work, _run(jeng, work))


def test_paged_sampled_tokens_equal_contiguous(models):
    """Sampling keys on (seed, position), not on the layout: the port's
    paged engine gives its contiguous engine's tokens, greedy and sampled."""
    _, pm = models
    work = _mixed_work(np.random.RandomState(2))
    assert (_run(_engine(pm, ServingEngine), work)
            == _run(_engine(pm, ServingEngine, paged=False), work))


def test_full_hit_skips_prefill(models):
    """A page-aligned repeat prompt replays from cached pages: no prefill
    dispatch, one skip, the contiguous engine's and JAX's tokens."""
    _, pm = models
    prompt = np.random.RandomState(3).randint(0, 1024, (16,)).astype(np.int64)
    jeng, peng = _pair(models)

    def once(eng):
        r = eng.submit(prompt, max_new_tokens=5, temperature=0.0, seed=7)
        eng.run()
        return r

    first = once(peng)
    d0, s0 = _counter("serving.prefill_dispatches"), _counter("serving.prefill_skips")
    second = once(peng)
    assert _counter("serving.prefill_dispatches") == d0
    assert _counter("serving.prefill_skips") == s0 + 1
    assert second.prefix_hit and second.shared_tokens == 16 and second.tail_bucket == 0
    assert first.tokens == second.tokens == once(_engine(pm, ServingEngine, paged=False)).tokens
    once(jeng)
    assert second.tokens == once(jeng).tokens
    assert peng.stats()["prefix"]["full_hits"] == 1


def test_partial_hit_prefills_only_the_tail(models):
    """Shared 16-token prefix + a fresh 4-token tail: exactly one prefill
    dispatch, at the tail's rung (8); tokens as contiguous and JAX's."""
    _, pm = models
    rng = np.random.RandomState(4)
    prefix = rng.randint(0, 1024, (16,)).astype(np.int64)
    sfx_a, sfx_b = (rng.randint(0, 1024, (4,)).astype(np.int64) for _ in range(2))
    jeng, peng = _pair(models)

    def once(eng, sfx):
        r = eng.submit(np.concatenate([prefix, sfx]), max_new_tokens=4,
                       temperature=0.0)
        eng.run()
        return r

    once(peng, sfx_a)
    d0 = _counter("serving.prefill_dispatches")
    got = once(peng, sfx_b)
    assert _counter("serving.prefill_dispatches") == d0 + 1
    assert got.prefix_hit and got.shared_tokens == 16 and got.tail_bucket == 8
    assert peng.stats()["prefix"]["partial_hits"] == 1
    assert peng.prefix_match_len(np.concatenate([prefix, sfx_b])) == 16
    assert got.tokens == once(_engine(pm, ServingEngine, paged=False), sfx_b).tokens
    once(jeng, sfx_a)
    assert got.tokens == once(jeng, sfx_b).tokens


def test_eviction_keeps_tokens_and_stats_follow_jax(models):
    """A pool of RESERVED + 9 pages forces LRU eviction of cached prefixes
    and still gives the unconstrained engine's tokens, and JAX's; stats(),
    occupancy(), queue_depth() and the counters move as JAX's do."""
    _, pm = models
    work = _mixed_work(np.random.RandomState(5), n=8)
    ref = _run(_engine(pm, ServingEngine), work)
    jeng, peng = _pair(models, pool_pages=RESERVED + 9)
    j0, p0 = _counts(_jax_counter), _counts(_counter)
    got = _run(peng, work)
    jgot = _run(jeng, work)
    assert got == ref
    assert _greedy(work, got) == _greedy(work, jgot)
    assert peng.stats()["prefix"]["evicted_pages"] > 0
    assert _stats(peng) == _stats(jeng)
    assert {n: v - p0[n] for n, v in _counts(_counter).items()} == \
        {n: v - j0[n] for n, v in _counts(_jax_counter).items()}
    for eng in (peng, jeng):
        eng.submit(work[0]["prompt"], max_new_tokens=8)
        eng.submit(work[1]["prompt"], max_new_tokens=8)
    assert peng.queue_depth() == jeng.queue_depth() == 2
    peng.step()
    jeng.step()
    assert peng.occupancy() == jeng.occupancy() == 2 / 3
    assert peng.queue_depth() == jeng.queue_depth() == 0
    assert _stats(peng) == _stats(jeng)
    assert peng.flush_prefix_cache() == jeng.flush_prefix_cache()


def test_pool_exhaustion_is_loud(models):
    """A pool that can never fit one request raises, in both packages."""
    for eng, exc in zip(_pair(models, pool_pages=RESERVED + 1),
                        (JaxPoolExhausted, PoolExhausted)):
        eng.submit(np.arange(16, dtype=np.int64), max_new_tokens=4)
        with pytest.raises(exc):
            eng.run()


def test_int8_pages_give_jax_tokens_and_bytes(models):
    rng = np.random.RandomState(6)
    work = [{"prompt": rng.randint(0, 1024, (n,)).astype(np.int64),
             "temperature": 0.0, "top_k": 0, "seed": 0} for n in (5, 9, 14, 20)]
    jq8, q8 = _pair(models, dtype="int8")
    assert _run(q8, work) == _run(jq8, work)
    for kw in ({"dtype": "auto"}, {"dtype": "bf16"}, {"dtype": "int8"}, {"paged": False}):
        jeng, peng = _pair(models, **kw)
        assert peng.kv_cache_bytes() == jeng.kv_cache_bytes(), kw
    assert q8.kv_cache_bytes() < _pair(models)[1].kv_cache_bytes() / 2


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_engine_serves_bf16_under_the_autocast_it_was_built_in(models, paged):
    """Built under auto_cast(bfloat16) O1, the engine holds bf16 weight
    matrices and a bf16 KV cache, the JAX engine's bytes, and gives JAX's
    greedy tokens, though run() is called outside the ``with`` block."""
    jm, pm = models
    work = [{"prompt": p, "temperature": 0.0, "top_k": 0, "seed": 0}
            for p in (np.random.RandomState(7).randint(0, 1024, (n,)).astype(np.int64)
                      for n in (5, 11, 16, 23))]
    with paddle.amp.auto_cast(dtype="bfloat16"):
        jeng = _engine(jm, JaxEngine, paged=paged)
        want = _run(jeng, work)
    with auto_cast(dtype="bfloat16"):
        peng = _engine(pm, ServingEngine, paged=paged)
    got = _run(peng, work)
    assert peng._cache_dtype == torch.bfloat16
    pools = peng._pool_state["k"] if paged else peng._kcs
    assert pools[0].dtype == torch.bfloat16
    attn = peng._net.gpt.blocks[0].attn.qkv_proj
    assert attn.weight.dtype == torch.bfloat16 and attn.bias.dtype == torch.float32
    assert pm.gpt.blocks[0].attn.qkv_proj.weight.dtype == torch.float32
    assert peng.kv_cache_bytes() == jeng.kv_cache_bytes()
    assert got == want
