"""Serving engine: bucketed prefill + slot or paged KV cache +
continuous-batching decode (counterpart of paddle_tpu/serving/engine.py).

- **Bucketed prefill.** A request's prompt is right-padded to its ladder
  rung and run through the model; the hidden state at the last real
  position gives the first token. Contiguous layout: the cache is a view of
  the request's slot row in the engine's ``[slots, max_seq_len, nh, hd]``
  buffers at offset 0, so the prompt's K/V land in place (the JAX engine
  builds a fresh rung cache and scatters it into the row).
- **Paged layout** (``kv_layout="paged"``, kv_pages.py): per-layer page
  pools and one ``[slots, max_pages]`` page table; the radix prefix cache
  (prefix_cache.py) shares whole prompt pages between requests. Admission
  has three shapes: a miss prefills the whole prompt at base 0; a partial
  hit prefills only the unshared tail, at its own rung, at base = shared
  tokens; a full hit (page-aligned prompt, every page cached) dispatches no
  prefill and seats the slot at offset ``plen - 1`` in replay mode, so its
  first decode step re-derives the last prompt position (its K/V write goes
  to the scratch page) and samples the first token from the stream of
  position ``plen``. Pages are reserved at admission for the request's
  worst case; a request that does not fit waits in the queue, and one that
  can never fit raises ``PoolExhausted``. A paged prefill gathers only the
  pages under ``base + rung`` positions, so a miss runs at the contiguous
  prefill's shapes.
- **Decode chunks.** One dispatch runs ``steps_per_dispatch`` single-token
  steps for every slot, with per-slot offsets, sampling parameters, EOS and
  budget masks held on the device; the host reads tokens back once per
  chunk (and stages the page table once per chunk). Idle slots keep
  writing their (masked) tip row, clamped to the buffer, or the scratch
  page.
- **Continuous batching.** A finished request retires its slot (and, paged,
  releases its pages) at the end of the chunk, and queued requests are
  prefilled into free slots between chunks.
- **Speculative decoding** (``draft_model=``, ``spec_ladder=``,
  ``submit(speculate_k=)``; reference engine.py:944-1980). A request that
  opts in snaps its k up to a ladder rung, and the draft prefills its whole
  prompt into the slot's row of the draft's own contiguous cache (in either
  layout). While any active slot speculates, a dispatch is one verify: the
  draft runs k + 1 single-token steps (the last only writes position
  off + k, so a window accepted whole leaves no hole in the draft cache),
  then the target scores ``[slots, k + 1]`` in one forward through its
  cache, and ``spec_commit`` accepts the longest agreeing prefix (greedy)
  or runs the leftover-distribution rule (sampled). Non-spec rows ride
  along with an empty window and emit the token a decode step would.
  Rejected rows are rewound by offset; on the paged layout the window
  writes through a ``[slots, k + 1]`` mask and ``kv_pages.truncate_row``
  frees the pages past the accepted frontier. The host reads a dispatch's
  results back once.

Weights are snapshotted at construction (a private copy of the model, in
eval mode; the caller's model keeps its mode, so a model can be served and
then trained with its dropout), cast as ``generate`` casts them under the
``auto_cast`` active at construction (matrices in the matmul autocast dtype,
the KV cache in the attention autocast dtype); every prefill and decode
chunk runs under that captured context, wherever ``run()`` is called, and
under the trace flag of jit.py (the JAX engine traces them). Call
``refresh_params()`` after updating the model (and the draft); the
snapshot takes parameters and buffers, so a model re-quantized with
incubate/quantization.py serves its new int8 weights.

Fleet and telemetry (reference engine.py:156-240, :388-527, :2061-2202):
- **Drain.** ``begin_drain()`` closes admission (``submit`` raises, queued
  requests stay queued for the router to re-place); ``drain(timeout_s)``
  runs the active slots to completion, or on timeout finishes each as
  ``outcome="drained"`` and releases its pages, then ``retire()``s the
  ``register_replica`` lease. ``install_sigterm_handler()`` makes SIGTERM
  close admission: the handler only flips the flag (no CUDA work, no lock);
  the preemption is counted on the serving thread at its next call.
- **Telemetry**, each dark until enabled: a ``sink`` (``serve_request`` and
  ``serve_step`` records, and an ``exec_registry`` rollup), the metrics
  registry (``serve.*`` histograms and gauges, ``serve.replica.<name>.*``
  once a router names the replica, ``spec.accept_rate``), the tracer's
  spans (``serve.enqueue``, ``serve.queue_wait``, ``serve.prefill``,
  ``serve.decode``, ``serve.request``, ``serve.retire``,
  ``serve.prefix_replay``, ``serve.decode_step``, ``serve.verify_step``;
  tagged with the router's ``TraceContext``) and flight-recorder dumps on a
  failed dispatch. ``core.monitor`` counts ``serving.outcome.<outcome>``
  for every finished request.
Not ported: the executable registry with ``precompile`` (PyTorch runs
eagerly; there is nothing to compile). The rollup record keeps the
reference's executable labels (``serve.prefill_b<rung>``,
``serve.decode_<family>``, ...) with the port's dispatch counts.
"""
from __future__ import annotations

import copy
import itertools
import signal
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..amp import amp_ctx, amp_scope
from ..core import flags, monitor
from ..jit import _tracing
from ..observability import exporter as _obs_exporter
from ..observability import flight_recorder as _obs_flight
from ..observability import metrics as _obs_metrics
from ..observability import tracer as _obs_tracer
from . import kv_pages
from .bucketing import DEFAULT_LADDER, bucket_for, clip_ladder
from .prefix_cache import RadixPrefixCache
from .sampling import (filtered_probs, gumbel_noise, residual_sample,
                       sample_tokens, spec_draws)

_NO_EOS = -1

# slot-occupancy fractions live in (0, 1]: linear buckets, not the default
# log-spaced latency boundaries
_OCCUPANCY_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))


def spec_commit(logits, props, off, tok, active, n_draft, eos, remaining,
                max_seq_len: int, dlogits=None, temps=None, top_k=None,
                top_p=None, uniforms=None, noise=None):
    """Acceptance and commit of one verify window (reference
    ``_spec_commit``, engine.py:1467-1561), on tensors of one device.

    logits [S, k+1, V]: the target's window scores; column j predicts the
    token at position off + j + 1. props [S, k]: the draft's proposals.
    off, tok, active, n_draft, eos, remaining [S]: the slots' state
    (n_draft = 0 on a non-spec row). Greedy when ``dlogits`` is None: accept
    the longest prefix that agrees with the target's argmax and emit the
    argmax row. Otherwise dlogits [S, k, V] are the draft's scores of its
    proposals, temps / top_k / top_p [S] the rows' sampling, uniforms [S, k]
    the ACCEPT_SALT draws and noise [S, k+1, V] the plain stream's Gumbel
    noise of positions off + 1 .. off + k + 1 (sampling.spec_draws): accept
    proposal j when u_j < p_t(d_j) / p_d(d_j) (exact agreement on rows at
    temperature 0); the column after the accepted prefix takes the bonus
    draw (``sample_tokens`` on the plain stream, the token a decode step
    would draw) when the whole window was accepted or the row drafted
    nothing, and the residual draw after a rejection. The commit cuts at the
    first EOS, then at the budget; a row at max_seq_len stops.

    Returns new_off, new_tok, new_active, new_remaining, emit [S, k+1],
    m (tokens committed), a (proposals accepted), hit_eos."""
    S, k = props.shape
    dev = logits.device
    cols = torch.arange(k + 1, device=dev)[None, :]
    in_window = torch.arange(k, device=dev)[None, :] < n_draft[:, None]
    tgt_greedy = torch.argmax(logits, dim=-1)                  # [S, k+1]
    exact = tgt_greedy[:, :k] == props
    if dlogits is None:
        accept = exact & in_window
        a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
        emit = tgt_greedy
    else:
        V = logits.shape[-1]
        rep = (lambda x: torch.as_tensor(x, device=dev).repeat_interleave(k))
        t_rep, k_rep, p_rep = rep(temps), rep(top_k), rep(top_p)
        p_t = filtered_probs(logits[:, :k].reshape(S * k, V), t_rep, k_rep,
                             p_rep).reshape(S, k, V)
        p_d = filtered_probs(dlogits.reshape(S * k, V), t_rep, k_rep,
                             p_rep).reshape(S, k, V)
        pt_d = p_t.gather(-1, props[..., None])[..., 0]          # [S, k]
        pd_d = p_d.gather(-1, props[..., None])[..., 0]
        ratio = pt_d / pd_d.clamp_min(1e-38)
        greedy_row = (temps == 0.0)[:, None]
        accept = torch.where(greedy_row, exact, uniforms < ratio) & in_window
        a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
        rows = torch.arange(S, device=dev)
        greedy_fix = tgt_greedy[rows, a]
        noise_a = noise[rows, a]                                 # [S, V]
        bonus_tok = sample_tokens(logits[rows, a], noise_a, temps, top_k, top_p)
        a_k = a.clamp(0, k - 1)
        resampled = residual_sample(p_t[rows, a_k], p_d[rows, a_k], noise_a)
        final_tok = torch.where(
            temps == 0.0, greedy_fix,
            torch.where(a >= n_draft, bonus_tok, resampled))
        props_pad = torch.cat([props, props[:, -1:]], dim=1)
        emit = torch.where(cols < a[:, None], props_pad, final_tok[:, None])
    # cut at the first emitted EOS, then at the budget: where a sequential
    # decode would stop
    m_raw = a + 1
    is_eos = ((eos[:, None] != _NO_EOS) & (emit == eos[:, None])
              & (cols < m_raw[:, None]))
    m = torch.where(is_eos.any(dim=1), torch.argmax(is_eos.long(), dim=1) + 1,
                    m_raw)
    m = torch.minimum(m, remaining) * active.long()
    new_off = off + m
    last_emit = emit.gather(1, (m - 1).clamp(0, k)[:, None])[:, 0]
    new_tok = torch.where(active, last_emit, tok)
    new_remaining = remaining - m
    hit_eos = active & (eos != _NO_EOS) & (new_tok == eos)
    new_active = (active & ~hit_eos & (new_remaining > 0)
                  & (new_off < max_seq_len))
    return new_off, new_tok, new_active, new_remaining, emit, m, a, hit_eos


class Request:
    """One generation request and its lifecycle record."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_new_tokens, temperature, top_k, top_p,
                 eos_token_id, seed, trace_ctx=None, tenant=None,
                 speculate_k=0):
        self.id = next(Request._ids)
        # tenant attribution (loadgen.py scenarios), carried into the
        # serve_request record; None = untagged
        self.tenant = tenant if tenant is None else str(tenant)
        # fleet trace identity (fleet.TraceContext, set by the router):
        # engine-side spans carry its request id and placement span
        self.trace_ctx = trace_ctx
        self.prompt_ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = (int(eos_token_id) if eos_token_id is not None
                             else None)
        self.seed = int(seed)
        # speculative decoding (reference :82-89): > 0 drafts this many
        # tokens a verify window (snapped up to a spec_ladder rung); the
        # counts add up over the request's verify dispatches
        self.speculate_k = int(speculate_k)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_bonus = 0
        self.tokens: List[int] = []      # generated tokens (incl. eos if hit)
        self.prefix_hit = False          # paged: >= 1 page matched the trie
        self.shared_tokens = 0           # paged: prompt tokens served from
                                         # shared pages (no prefill)
        self.tail_bucket: Optional[int] = None  # paged: the prefill's rung
                                                # (0 on a full hit)
        self.bucket: Optional[int] = None
        self.slot: Optional[int] = None
        self.queue_depth_at_submit = 0
        self.submit_ts: Optional[float] = None
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.done_ts: Optional[float] = None
        self.finish_reason: Optional[str] = None  # "eos" | "length"
        # terminal disposition: "eos" | "length" | "ok", "drained" (a drain
        # timeout cut it short) or "error" (a prefill or decode dispatch
        # raised)
        self.outcome: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.done_ts is not None

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_ts is None or self.submit_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admit_ts is None or self.submit_ts is None:
            return None
        return self.admit_ts - self.submit_ts

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time-per-output-token after the first (None until done or
        when only one token was generated)."""
        if (self.done_ts is None or self.first_token_ts is None
                or len(self.tokens) < 2):
            return None
        return (self.done_ts - self.first_token_ts) / (len(self.tokens) - 1)

    def trace_args(self, **kw) -> dict:
        """Span args of this request's trace events: the local id plus the
        fleet request id and parent placement span, if any."""
        out = {"request": self.id}
        if self.trace_ctx is not None:
            out.update(self.trace_ctx.span_args())
        out.update(kw)
        return out

    def output_ids(self):
        """[prompt + generated] (no post-EOS padding)."""
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.tokens, np.int64)])

    def __repr__(self):
        return (f"Request(id={self.id}, prompt={len(self.prompt_ids)}, "
                f"new={len(self.tokens)}/{self.max_new_tokens}, "
                f"done={self.done})")


class ServingEngine:
    """Continuous-batching GPT serving over a slot-based or paged KV cache.

    model: a GPTForPretraining of this package; the engine runs on the
    model's device. slot_count fixes the decode batch; ladder the prefill
    rungs (clipped to what fits max_seq_len with max_new_cap headroom).
    kv_layout "contiguous" (a [slots, max_seq_len] row a slot) or "paged";
    the paged layout takes kv_page_tokens (FLAGS_kv_page_tokens),
    kv_num_pages (default slots x max_pages + 2 reserved pages: the
    contiguous worst case, so the pool never runs out) and kv_cache_dtype
    "auto" | "bf16" | "int8" (FLAGS_kv_cache_dtype). draft_model (a
    GPTForPretraining of the target's vocabulary, on its device) enables
    speculative decoding, with windows of the spec_ladder rungs. sink: an
    object with write(dict)/close() receiving one "serve_request" record a
    finished request and one "serve_step" record a dispatch (None = no
    telemetry).

    One thread drives it: submit() is thread-safe, step()/run() must be called
    from one thread.
    """

    def __init__(self, model, slot_count: int = 4,
                 ladder: Sequence[int] = DEFAULT_LADDER,
                 max_seq_len: Optional[int] = None,
                 max_new_cap: int = 64, steps_per_dispatch: int = 8,
                 sink=None, kv_layout: str = "contiguous",
                 kv_page_tokens: Optional[int] = None,
                 kv_num_pages: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 draft_model=None, spec_ladder: Sequence[int] = (4,)):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(
                f"kv_layout must be 'contiguous' or 'paged', got {kv_layout!r}")
        cfg = model.config
        self.model = model      # its mode stays the caller's; the copy serves in eval
        # speculative decoding (reference :189-208): acceptance compares
        # token ids, so the vocabularies must agree
        self.draft_model = draft_model
        if draft_model is not None:
            if draft_model.config.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_model.config.vocab_size} != target "
                    f"vocab {cfg.vocab_size}: speculative acceptance "
                    "compares token ids, the vocabularies must agree")
            if draft_model.device != model.device:
                raise ValueError(
                    f"draft model on {draft_model.device}, target on "
                    f"{model.device}: put both on one device")
            self.spec_ladder = tuple(sorted(int(k) for k in spec_ladder))
            if not self.spec_ladder or min(self.spec_ladder) < 1:
                raise ValueError(
                    f"spec_ladder must be non-empty positive rungs, got "
                    f"{spec_ladder!r}")
        else:
            self.spec_ladder = ()
        self.kv_layout = kv_layout
        self.slot_count = int(slot_count)
        if self.slot_count < 1:
            raise ValueError(f"slot_count must be >= 1, got {slot_count}")
        self.max_seq_len = int(min(max_seq_len or cfg.max_seq_len,
                                   cfg.max_seq_len))
        self.max_new_cap = int(max_new_cap)
        if self.max_new_cap < 1 or self.max_new_cap >= self.max_seq_len:
            raise ValueError(
                f"max_new_cap {max_new_cap} must be in [1, max_seq_len)")
        self.ladder = clip_ladder(ladder, self.max_seq_len,
                                  reserve=self.max_new_cap)
        # decode steps per dispatch: the host reads tokens back once per
        # chunk, at the cost of retired slots idling masked until it ends
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.device = model.device
        self.sink = sink
        # PADDLE_TPU_METRICS_PORT / PADDLE_TPU_FLIGHT_DIR opt-ins: one getenv
        # each when unset
        _obs_exporter.ensure_started_from_env()
        _obs_flight.ensure_from_env()

        self._lock = threading.Lock()
        self._queue: deque[Request] = deque()
        self._completed: List[Request] = []
        self._steps = 0
        # drain state (distributed/membership.py protocol): once draining,
        # submit() refuses and admission stops; active slots run to the end
        self._draining = False
        self._sigterm_pending = False    # set by the SIGTERM handler
        self._replica_agent = None
        self._prev_sigterm = None
        # set by the ReplicaRouter (or the owner): _finish then also
        # publishes serve.replica.<name>.* metrics
        self.replica_name: Optional[str] = None
        # dispatches by the reference's executable label (the rollup record)
        self._dispatches: Dict[str, int] = {}
        # host-clock time spent in decode chunks and the tokens they emitted
        # (decode tokens/s = decode_tokens / decode_seconds)
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # pages kv_pages.truncate_row freed after verify windows (paged)
        self.rollback_pages = 0
        # private hook (chip_smoke.py): called as hook(request, logits [1, V])
        # after every prefill dispatch
        self._prefill_hook = None
        # the reference's executables are traced under the context active
        # when they are built; here every prefill and decode runs under it
        self._amp = amp_ctx()
        self._dnet = None
        self.refresh_params()

        nh = cfg.num_heads
        hd = cfg.hidden_size // cfg.num_heads
        S, T = self.slot_count, self.max_seq_len
        if kv_layout == "paged":
            pt = int(kv_page_tokens if kv_page_tokens is not None
                     else flags.flag("kv_page_tokens"))
            if pt < 1:
                raise ValueError(f"kv_page_tokens must be >= 1, got {pt}")
            self.page_tokens = pt
            self.max_pages = -(-T // pt)                  # ceil(T / pt)
            mode = (kv_cache_dtype if kv_cache_dtype is not None
                    else flags.flag("kv_cache_dtype"))
            self._store_dtype, self._kv_quantized = kv_pages.resolve_store_dtype(
                mode, self._cache_dtype)
            self.num_pages = int(kv_num_pages if kv_num_pages is not None
                                 else S * self.max_pages + kv_pages.RESERVED_PAGES)
            self._pool = kv_pages.PagePool(self.num_pages)
            self._prefix = RadixPrefixCache(self._pool, pt)
            self._pool_state = kv_pages.make_pool_state(
                cfg.num_layers, self.num_pages, pt, nh, hd, S, self.max_pages,
                self._store_dtype, self._kv_quantized, device=self.device)
            self._tables = np.zeros((S, self.max_pages), np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in range(S)]
            self._replay = np.zeros(S, bool)
            self._kcs = self._vcs = None
        else:
            self._kcs = [torch.zeros((S, T, nh, hd), dtype=self._cache_dtype,
                                     device=self.device)
                         for _ in range(cfg.num_layers)]
            self._vcs = [torch.zeros_like(kc) for kc in self._kcs]
        # the draft's cache is contiguous in both layouts (reference
        # :296-309): a rejected row rewinds by offset alone, stale rows past
        # it are masked and rewritten before any query reads them
        if draft_model is not None:
            dcfg = draft_model.config
            dnh, dhd = dcfg.num_heads, dcfg.hidden_size // dcfg.num_heads
            self._dkcs = [torch.zeros((S, T, dnh, dhd), dtype=self._cache_dtype,
                                      device=self.device)
                          for _ in range(dcfg.num_layers)]
            self._dvcs = [torch.zeros_like(kc) for kc in self._dkcs]
        else:
            self._dkcs = self._dvcs = None

        # host-side per-slot state (tiny arrays, staged once per chunk)
        self._offsets = np.zeros(S, np.int64)
        self._last_tok = np.zeros(S, np.int64)
        self._active = np.zeros(S, bool)
        self._temps = np.zeros(S, np.float32)
        self._topk = np.zeros(S, np.int64)
        self._topp = np.ones(S, np.float32)
        self._eos = np.full(S, _NO_EOS, np.int64)
        self._remaining = np.zeros(S, np.int64)
        self._seeds = np.zeros(S, np.int64)
        # per-slot window rung, 0 = plain decode (reference :321-324)
        self._spec_k = np.zeros(S, np.int64)
        self._slot_req: List[Optional[Request]] = [None] * S

    # ------------------------------------------------------------- params
    def refresh_params(self) -> None:
        """Re-snapshot the model's (and the draft's) weights into the
        engine's private copies, cast by ``GPTForPretraining._decode_weights``
        under the ``auto_cast`` captured at construction (reference
        engine.py:345-374)."""
        with amp_scope(self._amp):
            weights, self._cache_dtype = self.model._decode_weights()
        self._net = self._load(self.model, weights)
        if self.draft_model is not None:
            with amp_scope(self._amp):
                dweights, _ = self.draft_model._decode_weights()
            self._dnet = self._load(self.draft_model, dweights)

    @staticmethod
    @torch.no_grad()
    def _load(model, weights):
        """A copy of ``model`` (made at every refresh: a quantization swap may
        have changed its layers) in eval mode, its parameters and buffers
        set to ``weights``."""
        net = copy.deepcopy(model).eval()
        for name, t in (*net.named_parameters(), *net.named_buffers()):
            t.data = weights[name].clone()
        return net

    # ------------------------------------------------------------- public
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token_id=None, seed: int = 0, trace_ctx=None,
               tenant=None, speculate_k: int = 0) -> Request:
        """Enqueue a request; returns the live Request handle (tokens fill
        in as the engine runs). max_new_tokens is clamped to the engine cap
        and to the cache room left after the prompt's bucket. trace_ctx
        (fleet.TraceContext) threads a fleet request id and parent span
        through every span of the request; tenant tags its serve_request
        record. speculate_k > 0 opts the request into speculative decoding
        (snapped up to a spec_ladder rung; needs a draft model). Raises
        while the engine drains."""
        self._settle_sigterm()
        if self._draining:
            raise RuntimeError(
                "ServingEngine is draining (SIGTERM/begin_drain): admission "
                "is closed; submit to a live replica")
        if speculate_k:
            if speculate_k < 0:
                raise ValueError(
                    f"speculate_k must be >= 0, got {speculate_k}")
            if self.draft_model is None:
                raise ValueError(
                    "speculate_k > 0 needs a draft model: construct the "
                    "engine with draft_model=")
        req = Request(prompt_ids, max_new_tokens, temperature, top_k, top_p,
                      eos_token_id, seed, trace_ctx=trace_ctx, tenant=tenant,
                      speculate_k=speculate_k)
        plen = len(req.prompt_ids)
        req.bucket = bucket_for(plen, self.ladder)  # raises if oversize
        room = self.max_seq_len - req.bucket
        req.max_new_tokens = max(1, min(req.max_new_tokens,
                                        self.max_new_cap, room))
        req.submit_ts = time.perf_counter()
        with self._lock:
            req.queue_depth_at_submit = len(self._queue)
            self._queue.append(req)
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.instant("serve.enqueue", **req.trace_args(
                queue_depth=req.queue_depth_at_submit))
        return req

    def step(self) -> int:
        """Admit queued requests into free slots (bucketed prefill; none
        while draining), then run ONE dispatch for all slots: a verify
        window while an active slot speculates, else a decode chunk.
        Returns the number of live slots after the step (0 = fully
        drained)."""
        self._settle_sigterm()
        with amp_scope(self._amp), _tracing():
            self._admit()
            if self._active.any():
                self._advance_step()
        return int(self._active.sum())

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive until queue and slots drain (or max_steps dispatches);
        returns the requests completed during this call."""
        done0 = len(self._completed)
        steps = 0
        while (self._queue and not self._draining) or self._active.any():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        if steps:
            self._emit_registry_rollup()
        return self._completed[done0:]

    # ---------------------------------------------------- elastic replica
    def register_replica(self, store, replica_id: str,
                         lease_s: Optional[float] = None):
        """Join the serving fleet: heartbeat a ``replica/<rid>`` lease under
        the current membership generation (distributed/membership.py).
        Returns the WorkerAgent; ``retire()`` (and so ``drain()``) releases
        the lease."""
        from ..distributed.membership import WorkerAgent

        agent = WorkerAgent(store, replica_id, lease_s=lease_s,
                            kind="replica")
        agent.register()
        agent.start_heartbeat()
        self._replica_agent = agent
        return agent

    def begin_drain(self, reason: str = "drain") -> None:
        """Stop admission now (submit() refuses, queued requests stay
        queued for a live replica); active slots keep decoding. Idempotent.
        reason "sigterm" counts ``elastic.preemptions``."""
        if self._draining:
            return
        self._draining = True
        if reason == "sigterm":
            self._count_preemption()

    @staticmethod
    def _count_preemption() -> None:
        from ..distributed import membership as _membership

        _membership.PREEMPTIONS.increase()
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.counter("elastic.preemptions").inc()

    def _settle_sigterm(self) -> None:
        """Count a SIGTERM the handler noted (on the serving thread: the
        counters take locks the handler must not)."""
        if self._sigterm_pending:
            self._sigterm_pending = False
            self._count_preemption()

    def drain(self, timeout_s: Optional[float] = None) -> List[Request]:
        """Run active slots to completion (admission closed), deregister the
        replica lease, and return the requests completed during the drain.
        Bounded by ``timeout_s`` (FLAGS_elastic_drain_timeout_s): past it,
        every request still decoding finishes as ``outcome="drained"`` (not
        a completion) and its slot and pages are released. Records
        ``elastic.drain_ms`` in the metrics registry."""
        self._settle_sigterm()
        self.begin_drain()
        tmo = float(timeout_s if timeout_s is not None
                    else flags.flag("elastic_drain_timeout_s"))
        t0 = time.perf_counter()
        done0 = len(self._completed)
        while self._active.any():
            if time.perf_counter() - t0 > tmo:
                for slot in np.nonzero(self._active)[0]:
                    req = self._slot_req[slot]
                    self._active[slot] = False
                    self._slot_req[slot] = None
                    if self.kv_layout == "paged":
                        self._release_slot(slot)
                    if req is not None and req.done_ts is None:
                        self._finish(req, outcome="drained")
                break
            with amp_scope(self._amp), _tracing():
                self._advance_step()
        drain_ms = (time.perf_counter() - t0) * 1000.0
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.histogram("elastic.drain_ms").observe(drain_ms)
        self._emit_registry_rollup()
        self.retire()
        return self._completed[done0:]

    def retire(self) -> None:
        """Deregister the replica lease (graceful leave; reason "sigterm"
        while draining). Idempotent; a no-op without register_replica."""
        self._settle_sigterm()
        if self._replica_agent is not None:
            self._replica_agent.announce_leave(
                "sigterm" if self._draining else "leave")
            self._replica_agent = None

    def install_sigterm_handler(self) -> None:
        """SIGTERM -> close admission, then chain the previous handler. The
        handler only sets two flags: no CUDA work, no lock the serving
        thread may hold. The drain itself runs on the serving thread:
        run() returns once the active slots empty, or the owner calls
        drain()."""
        def _on_sigterm(signum, frame):
            if not self._draining:
                self._sigterm_pending = True
                self._draining = True
            prev = self._prev_sigterm
            if callable(prev):
                prev(signum, frame)

        self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)

    @torch.no_grad()
    def score_prompt(self, prompt_ids) -> torch.Tensor:
        """Next-token logits [vocab] of a prompt, computed exactly as a
        contiguous admission's bucketed prefill does, on a scratch cache (no
        slot or page is touched)."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        with amp_scope(self._amp), _tracing():
            return self._prefill(prompt, bucket_for(len(prompt), self.ladder),
                                 slot=None)[0]

    def stats(self) -> Dict[str, Any]:
        """The reference's ``stats()`` keys but its executable counts (the
        port runs eagerly and compiles nothing)."""
        out = {
            "steps": self._steps,
            "completed": len(self._completed),
            "queued": len(self._queue),
            "active_slots": int(self._active.sum()),
            "draining": self._draining,
            "slot_count": self.slot_count,
            "ladder": self.ladder,
            "kv_layout": self.kv_layout,
            "kv_cache_bytes": self.kv_cache_bytes(),
        }
        if self.draft_model is not None:
            out["spec_ladder"] = self.spec_ladder
        if self.kv_layout == "paged":
            out.update({
                "page_tokens": self.page_tokens,
                "num_pages": self.num_pages,
                "pages_in_use": self._pool.in_use,
                "pages_cached": self._pool.cached,
                "prefix": self._prefix.stats(),
            })
        return out

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the KV cache: per-slot rows (contiguous) or
        pools + scales + page table (paged)."""
        if self.kv_layout == "paged":
            return kv_pages.pool_state_bytes(self._pool_state)
        return sum(t.numel() * t.element_size() for t in (*self._kcs, *self._vcs))

    def prefix_match_len(self, prompt_ids) -> int:
        """Tokens of this prompt already cached as shared pages (0 on the
        contiguous layout); no refcount side effects."""
        if self.kv_layout != "paged":
            return 0
        return self._prefix.peek([int(t) for t in prompt_ids])

    def flush_prefix_cache(self) -> int:
        """Evict every refcount-zero cached prefix page; returns the count
        freed (a cold trie with a warm engine)."""
        if self.kv_layout != "paged":
            return 0
        return self._prefix.flush()

    def occupancy(self) -> float:
        return float(self._active.sum()) / self.slot_count

    def queue_depth(self) -> int:
        return len(self._queue)

    # ---- prefill -------------------------------------------------------
    def _prefill_logits(self, ids: np.ndarray, bucket: int, caches) -> torch.Tensor:
        """Run ``ids`` right-padded to ``bucket`` through the model on
        ``caches``; the last real position's logits [1, V]. Causal masking
        makes the right-pad inert."""
        n = len(ids)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :n] = torch.from_numpy(ids)
        h, _ = self._net.gpt(padded.to(self.device), caches=caches)
        return self._net._head_logits(h[:, n - 1])

    def _prefill(self, prompt: np.ndarray, bucket: int,
                 slot: Optional[int]) -> torch.Tensor:
        """Contiguous prefill: a rung-sized cache at offset 0, the slot row's
        first ``bucket`` positions, or a scratch cache when slot is None."""
        cfg = self._net.config
        if slot is None:
            nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
            caches = [(torch.zeros((1, bucket, nh, hd), dtype=self._cache_dtype,
                                   device=self.device),
                       torch.zeros((1, bucket, nh, hd), dtype=self._cache_dtype,
                                   device=self.device), 0)
                      for _ in range(cfg.num_layers)]
        else:
            caches = [(kc[slot:slot + 1, :bucket], vc[slot:slot + 1, :bucket], 0)
                      for kc, vc in zip(self._kcs, self._vcs)]
        return self._prefill_logits(prompt, bucket, caches)

    def _prefill_paged(self, tail: np.ndarray, bucket: int, base: int,
                       slot: int) -> torch.Tensor:
        """Paged prefill of the unshared tail at ``base``, writing through the
        slot's page-table row. Only the pages under ``base + bucket``
        positions are gathered; pad positions write the scratch page (their
        table entries may be the zero page, which is never written)."""
        pt, dev = self.page_tokens, self.device
        n_pages = min(-(-(base + bucket) // pt), self.max_pages)
        table = torch.from_numpy(self._tables[slot:slot + 1, :n_pages]).to(
            device=dev, dtype=torch.long)
        wmask = (torch.arange(bucket) < len(tail))[None].to(dev)
        caches = kv_pages.layer_views(
            self._pool_state, table, torch.tensor([base], device=dev), wmask,
            pt, self._cache_dtype)
        return self._prefill_logits(tail, bucket, caches)

    def _first_token(self, req: Request, logits: torch.Tensor) -> int:
        """Sample the first token (at position plen) from prefill logits;
        the int() is the device sync."""
        if self._prefill_hook is not None:
            self._prefill_hook(req, logits)
        plen = len(req.prompt_ids)
        noise = (None if req.temperature == 0.0 else gumbel_noise(
            [req.seed], [plen], logits.shape[-1], self.device))
        return int(sample_tokens(logits, noise, [req.temperature],
                                 [req.top_k], [req.top_p])[0])

    def _seat(self, req: Request, slot: int, offset: int, last_tok: int,
              remaining: int) -> None:
        self._offsets[slot] = offset
        self._last_tok[slot] = last_tok
        self._active[slot] = True
        self._temps[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._topp[slot] = req.top_p
        self._eos[slot] = (req.eos_token_id if req.eos_token_id is not None
                           else _NO_EOS)
        self._remaining[slot] = remaining
        self._seeds[slot] = req.seed
        self._slot_req[slot] = req
        self._seat_spec(req, slot)

    def _seat_spec(self, req: Request, slot: int) -> None:
        """Speculative set-up at every seating (reference :983-1022): a
        reused slot drops its predecessor's rung; a speculating request
        snaps its k up to a ladder rung and the draft prefills the whole
        prompt into the slot's draft row (also for a paged full-hit replay
        seat: the draft cache shares no prefix, and the verify's rewrite of
        position plen - 1 writes the same values)."""
        if req.speculate_k <= 0 or self.draft_model is None:
            self._spec_k[slot] = 0
            return
        self._spec_k[slot] = next(
            (r for r in self.spec_ladder if r >= req.speculate_k),
            self.spec_ladder[-1])
        monitor.stat("serving.draft_prefill_dispatches").increase()
        self._note_dispatch(f"serve.dprefill_b{req.bucket}")
        bucket, plen = req.bucket, len(req.prompt_ids)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :plen] = torch.from_numpy(req.prompt_ids)
        caches = [(kc[slot:slot + 1, :bucket], vc[slot:slot + 1, :bucket], 0)
                  for kc, vc in zip(self._dkcs, self._dvcs)]
        self._dnet.gpt(padded.to(self.device), caches=caches)

    @staticmethod
    def _note_queue_wait(req: Request) -> None:
        """The ``serve.queue_wait`` span and histogram, submit to admission."""
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.record_complete("serve.queue_wait", req.submit_ts,
                               req.admit_ts, req.trace_args())
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.histogram("serve.queue_wait_ms").observe(
                req.queue_wait_s * 1e3)

    @staticmethod
    def _note_prefill(req: Request, **span_args) -> None:
        """The ``serve.prefill`` span and histogram, admission to the first
        token (reference :1071-1082, :1253-1261)."""
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.record_complete("serve.prefill", req.admit_ts,
                               req.first_token_ts, req.trace_args(**span_args))
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.histogram("serve.prefill_ms").observe(
                (req.first_token_ts - req.admit_ts) * 1e3)

    def _prefill_failed(self, req: Request, e: Exception, **where) -> None:
        """A prefill dispatch raised: dump the flight ring, finish the
        request as an error (the caller re-raises)."""
        fr = _obs_flight.get()
        if fr is not None:
            fr.dump("serve_prefill_exception",
                    {"request": req.id, **where, "error": repr(e)})
        self._finish(req, outcome="error")

    def _after_first_token(self, req: Request, slot: int, first: int) -> None:
        """Record the prefill's token; retire the request at once when it is
        eos or the budget is one token, else seat it for decode."""
        req.slot = slot
        req.tokens.append(first)
        self._count_tokens(1)
        eos = req.eos_token_id if req.eos_token_id is not None else _NO_EOS
        if (eos != _NO_EOS and first == eos) or req.max_new_tokens <= 1:
            req.finish_reason = ("eos" if eos != _NO_EOS and first == eos
                                 else "length")
            if self.kv_layout == "paged":
                self._release_slot(slot)
            self._finish(req)
            return
        self._seat(req, slot, len(req.prompt_ids), first, req.max_new_tokens - 1)

    @torch.no_grad()
    def _admit(self) -> None:
        if self._draining:
            return
        while True:
            with self._lock:
                if not self._queue:
                    return
                free = [i for i in range(self.slot_count)
                        if not self._active[i] and self._slot_req[i] is None]
                if not free:
                    return
                req = self._queue.popleft()
            slot = free[0]
            if self.kv_layout == "paged":
                if not self._admit_paged(req, slot):
                    return
                continue
            req.admit_ts = time.perf_counter()    # queue wait ends here
            monitor.stat("serving.prefill_dispatches").increase()
            self._note_dispatch(f"serve.prefill_b{req.bucket}")
            try:
                first = self._first_token(
                    req, self._prefill(req.prompt_ids, req.bucket, slot))
            except Exception as e:
                self._prefill_failed(req, e, bucket=req.bucket)
                raise
            req.first_token_ts = time.perf_counter()
            self._note_queue_wait(req)
            self._note_prefill(req, bucket=req.bucket, slot=slot)
            self._after_first_token(req, slot, first)

    # ---- paged admission -----------------------------------------------
    def _pages_reserved_inflight(self) -> int:
        """Worst-case pages still to be allocated by active slots (each
        slot's final offset is offsets + remaining; shared and own pages
        already in its table row don't count)."""
        pt = self.page_tokens
        total = 0
        for i in np.nonzero(self._active)[0]:
            end = min(int(self._offsets[i]) + int(self._remaining[i]),
                      self.max_seq_len)
            need = -(-end // pt) - int((self._tables[i] != 0).sum())
            total += max(0, need)
        return total

    def _release_slot(self, slot: int) -> None:
        """Drop the slot's page references (shared pages decref; own pages
        free or park for prefix reuse) and reset its table row to the zero
        page."""
        for p in self._slot_pages[slot]:
            self._prefix.release(int(p))
        self._slot_pages[slot] = []
        self._tables[slot, :] = 0
        self._replay[slot] = False

    def _admit_paged(self, req: Request, slot: int) -> bool:
        """Seat a request on the paged cache (a miss, a partial hit or a full
        hit; module docstring). Returns False (request requeued at the
        front) when the pool cannot cover this request's worst case on top
        of the in-flight reservations; admission retries once decode retires
        a slot and frees pages."""
        pt = self.page_tokens
        plen = len(req.prompt_ids)
        req.admit_ts = time.perf_counter()    # queue wait ends here
        shared = self._prefix.match(req.prompt_ids)
        k_shared = len(shared)
        monitor.stat("serving.prefix_lookups").increase()
        need_new = -(-(plen + req.max_new_tokens) // pt) - k_shared
        avail = self._pool.available
        if avail < self._pages_reserved_inflight() + need_new:
            for p in shared:
                self._prefix.release(int(p))
            if not self._active.any():
                raise kv_pages.PoolExhausted(
                    f"pool of {self.num_pages} pages cannot fit one request "
                    f"needing {need_new} fresh pages ({avail} available); "
                    "raise kv_num_pages or lower max_new_cap")
            req.admit_ts = None
            with self._lock:
                self._queue.appendleft(req)
            return False
        if shared:
            monitor.stat("serving.prefix_hits").increase()
            req.prefix_hit = True
            req.shared_tokens = k_shared * pt
        self._tables[slot, :] = 0
        self._tables[slot, :k_shared] = shared
        self._slot_pages[slot] = [int(p) for p in shared]
        self._note_queue_wait(req)

        if k_shared * pt >= plen:
            # full hit: a replay seat, no prefill; the first token comes out
            # of the decode chunk at position plen
            monitor.stat("serving.prefill_skips").increase()
            req.tail_bucket = 0
            req.slot = slot
            tr = _obs_tracer.get_tracer()
            if tr.enabled:
                tr.instant("serve.prefix_replay", **req.trace_args(
                    slot=slot, shared_tokens=req.shared_tokens))
            self._replay[slot] = True
            self._seat(req, slot, plen - 1, int(req.prompt_ids[-1]),
                       req.max_new_tokens)
            return True

        base = k_shared * pt
        tbucket = bucket_for(plen - base, self.ladder)
        req.tail_bucket = tbucket
        npages_prompt = -(-plen // pt)
        if not self._prefix.ensure_free(npages_prompt - k_shared):
            raise kv_pages.PoolExhausted(   # the reservation check above makes
                "page reservation accounting violated")  # this unreachable
        for pi in range(k_shared, npages_prompt):
            page = self._pool.alloc()
            self._tables[slot, pi] = page
            self._slot_pages[slot].append(page)
        monitor.stat("serving.prefill_dispatches").increase()
        self._note_dispatch(f"serve.prefill_b{tbucket}")
        try:
            first = self._first_token(req, self._prefill_paged(
                req.prompt_ids[base:], tbucket, base, slot))
        except Exception as e:
            self._prefill_failed(req, e, bucket=tbucket, base=base)
            raise
        req.first_token_ts = time.perf_counter()
        self._note_prefill(req, bucket=tbucket, base=base, slot=slot)
        # publish this prompt's fully written pages for later sharers
        full_pages = plen // pt
        if full_pages > k_shared:
            self._prefix.insert(
                req.prompt_ids[:full_pages * pt],
                [int(p) for p in self._tables[slot, :full_pages]])
        self._after_first_token(req, slot, first)
        return True

    def _prealloc_pages(self, ahead) -> None:
        """Between dispatches: make sure every active slot's table row
        covers the positions the next dispatch may write, off .. off +
        ahead[i] (a replay slot's position off goes to the scratch page; the
        table is fixed within a dispatch). A decode chunk writes
        steps_per_dispatch positions; a verify n_draft + 1, n_draft <=
        remaining - 1 (reference :1785-1798). Evicts LRU cached prefixes
        under pressure; admission reservations guarantee success."""
        pt = self.page_tokens
        ahead = np.broadcast_to(ahead, self._active.shape)
        for i in np.nonzero(self._active)[0]:
            first = int(self._offsets[i]) + (1 if self._replay[i] else 0)
            last = min(int(self._offsets[i]) + int(ahead[i]), self.max_seq_len - 1)
            for pi in range(first // pt, last // pt + 1):
                if self._tables[i, pi] == 0:
                    if not self._prefix.ensure_free(1):
                        raise kv_pages.PoolExhausted(
                            f"the next dispatch needs a page for slot {i} and "
                            "none is free or evictable (reservation "
                            "accounting violated)")
                    page = self._pool.alloc()
                    self._tables[i, pi] = page
                    self._slot_pages[i].append(page)

    # ---- decode --------------------------------------------------------
    @torch.no_grad()
    def _decode_chunk(self, greedy_only: bool):
        """``steps_per_dispatch`` decode steps for every slot, state on the
        device. Returns the per-step tokens, was-active and eos-hit masks
        [n_inner, S] and the final per-slot state (paged: with the replay
        flags), all as numpy."""
        dev = self.device
        T = self.max_seq_len
        vocab = self._net.config.vocab_size
        paged = self.kv_layout == "paged"

        def put(a):
            return torch.as_tensor(a).to(dev)

        off, tok, active = put(self._offsets), put(self._last_tok), put(self._active)
        remaining, eos = put(self._remaining), put(self._eos)
        temps, topk, topp = put(self._temps), put(self._topk), put(self._topp)
        if paged:
            tables = self._pool_state["tables"]
            tables.copy_(torch.from_numpy(self._tables))   # once per chunk
            tables = tables.long()
            replay = put(self._replay)
        toks, was_active, hits = [], [], []
        for _ in range(self.steps_per_dispatch):
            # an idle slot at the tip would index past the buffer (and past
            # the position embedding): clamp; its row is masked and, paged,
            # its write goes to the scratch page
            off_m = off.clamp_max(T - 1)
            if paged:
                # idle rows and replaying rows write to the scratch page
                caches = kv_pages.layer_views(
                    self._pool_state, tables, off_m, active & ~replay,
                    self.page_tokens, self._cache_dtype)
            else:
                caches = [(kc, vc, off_m) for kc, vc in zip(self._kcs, self._vcs)]
            h, _ = self._net.gpt(tok[:, None], caches=caches)
            logits = self._net._head_logits(h[:, 0])                # [S, V]
            act = active.long()
            new_off = off + act         # the sampled token's position
            if greedy_only:
                nxt = torch.argmax(logits, dim=-1)
            else:
                # the streams are keyed by position, read on the host
                noise = gumbel_noise(self._seeds.tolist(), new_off.tolist(),
                                     vocab, dev)
                nxt = sample_tokens(logits, noise, temps, topk, topp)
            nxt = torch.where(active, nxt, tok)
            new_remaining = remaining - act
            hit_eos = active & (eos != _NO_EOS) & (nxt == eos)
            toks.append(nxt)
            was_active.append(active)
            hits.append(hit_eos)
            if paged:
                replay = replay & ~active
            active = active & ~hit_eos & (new_remaining > 0) & (new_off < T)
            off, tok, remaining = new_off, nxt, new_remaining
        out = [torch.stack(toks), torch.stack(was_active), torch.stack(hits),
               off, tok, active, remaining] + ([replay] if paged else [])
        return [t.cpu().numpy() for t in out]

    def _decode_step(self) -> None:
        # an all-greedy slot set skips the sampling work entirely
        greedy_only = not self._temps[self._active].any()
        family = "greedy" if greedy_only else "sample"
        paged = self.kv_layout == "paged"
        self._note_dispatch(f"serve.decode_{family}")
        t0 = time.perf_counter()
        try:
            if paged:
                self._prealloc_pages(self.steps_per_dispatch - 1)
            (toks, was_active, hits, off, tok, active, remaining,
             *replay) = self._decode_chunk(greedy_only)
        except Exception as e:
            self._dispatch_failed("serve_decode_exception", e, family=family)
            raise
        self._offsets = off.copy()
        self._last_tok = tok.copy()
        self._active = active.copy()
        self._remaining = remaining.copy()
        if paged:
            self._replay = replay[0].copy()
        n_inner = toks.shape[0]
        now = time.perf_counter()
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.record_complete("serve.decode_step", t0, now,
                               {"step": self._steps, "family": family})
        self._steps += n_inner
        self.decode_seconds += now - t0    # the chunk ends in a device read
        emitted = int(was_active.sum())
        self.decode_tokens += emitted
        for j in range(n_inner):
            alive_after = (was_active[j + 1] if j + 1 < n_inner
                           else self._active)
            for slot in np.nonzero(was_active[j])[0]:
                req = self._slot_req[slot]
                req.tokens.append(int(toks[j, slot]))
                if req.first_token_ts is None:   # a replay seat's first token
                    req.first_token_ts = now
                if not alive_after[slot]:     # retired at this inner step
                    req.finish_reason = "eos" if hits[j, slot] else "length"
                    self._slot_req[slot] = None
                    if paged:
                        self._release_slot(slot)
                    self._finish(req, now)
        self._count_tokens(emitted)
        monitor.stat("serving.steps").increase(n_inner)
        occupancy = float(was_active.mean())
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.histogram("serve.decode_step_ms").observe((now - t0) * 1e3)
            self._note_step_gauges(mreg, occupancy)
        self._emit_step_record(n_inner, int(was_active[0].sum()), occupancy,
                               emitted)

    # ---- speculative decoding: dispatch choice and verify ----------------
    def _spec_dispatch_rung(self) -> int:
        """The window of the next dispatch (reference :1742-1772): the
        largest rung among active speculating slots, or 0 for a decode
        chunk. The contiguous layout falls back while an active slot sits on
        row T - 1: the window's writes would collapse onto that row."""
        if self.draft_model is None or not self._active.any():
            return 0
        rungs = self._spec_k[self._active]
        if not rungs.any():
            return 0
        if (self.kv_layout != "paged"
                and int(self._offsets[self._active].max()) >= self.max_seq_len - 1):
            return 0
        return int(rungs.max())

    def _advance_step(self) -> None:
        """One dispatch: a verify window while an active slot speculates
        (non-spec slots ride along with an empty window), else a decode
        chunk (reference :1774-1783)."""
        k = self._spec_dispatch_rung()
        if k:
            self._verify_step(k)
        else:
            self._decode_step()

    @torch.no_grad()
    def _verify(self, k: int, n_draft: np.ndarray, greedy_only: bool) -> np.ndarray:
        """One verify dispatch (reference ``_build_verify`` and
        ``_build_verify_paged``, :1563-1740): k + 1 draft steps, one [S,
        k+1] target window, ``spec_commit``. Returns, from one device read,
        int64 [S, k+1 + 8]: emit, then m, a, hit_eos, new_off, new_tok,
        new_active, new_remaining, new_replay."""
        dev = self.device
        S = self.slot_count
        vocab = self._net.config.vocab_size
        paged = self.kv_layout == "paged"

        def put(a):
            return torch.as_tensor(a).to(dev)

        off, tok, active = put(self._offsets), put(self._last_tok), put(self._active)
        remaining, eos, nd = put(self._remaining), put(self._eos), put(n_draft)
        temps, topk, topp = put(self._temps), put(self._topk), put(self._topp)
        if not greedy_only:
            dnoise, uniforms, pnoise = (t.to(dev) for t in spec_draws(
                self._seeds, self._offsets, n_draft,
                self._active & (self._temps != 0.0), k, vocab))
        # the draft: k + 1 steps over its contiguous cache; the last only
        # writes position off + k (its proposal is never used), so a window
        # accepted whole leaves the draft cache dense up to the new frontier
        cur, props, dlogits = tok, [], []
        for i in range(k + 1):
            caches = [(kc, vc, off + i) for kc, vc in zip(self._dkcs, self._dvcs)]
            h, _ = self._dnet.gpt(cur[:, None], caches=caches)
            if i == k:
                break
            dl = self._dnet._head_logits(h[:, 0])                 # [S, V]
            if greedy_only:
                cur = torch.argmax(dl, dim=-1)
            else:
                cur = sample_tokens(dl, dnoise[i], temps, topk, topp)
                dlogits.append(dl)
            props.append(cur)
        props = torch.stack(props, dim=1)                          # [S, k]

        # the target: one [S, k + 1] window through its cache
        win = torch.cat([tok[:, None], props], dim=1)
        if paged:
            tables = self._pool_state["tables"]
            tables.copy_(torch.from_numpy(self._tables))
            replay = put(self._replay)
            cols = torch.arange(k + 1, device=dev)[None, :]
            # columns past a row's window have no pages: the scratch page; a
            # replay row's column 0 re-derives a shared prompt position
            wmask = (active[:, None] & (cols <= nd[:, None])
                     & ~(replay[:, None] & (cols == 0)))
            caches = kv_pages.layer_views(
                self._pool_state, tables.long(), off, wmask, self.page_tokens,
                self._cache_dtype)
        else:
            caches = [(kc, vc, off) for kc, vc in zip(self._kcs, self._vcs)]
        h, _ = self._net.gpt(win, caches=caches)
        logits = self._net._head_logits(
            h.reshape(S * (k + 1), -1)).reshape(S, k + 1, -1)
        if greedy_only:
            out = spec_commit(logits, props, off, tok, active, nd, eos,
                              remaining, self.max_seq_len)
        else:
            out = spec_commit(logits, props, off, tok, active, nd, eos,
                              remaining, self.max_seq_len,
                              dlogits=torch.stack(dlogits, dim=1), temps=temps,
                              top_k=topk, top_p=topp, uniforms=uniforms,
                              noise=pnoise)
        new_off, new_tok, new_active, new_remaining, emit, m, a, hits = out
        new_replay = (replay & ~active) if paged else torch.zeros_like(active)
        state = torch.stack([m, a, hits.long(), new_off, new_tok,
                             new_active.long(), new_remaining,
                             new_replay.long()], dim=1)
        return torch.cat([emit, state], dim=1).cpu().numpy()

    def _verify_step(self, k: int) -> None:
        """The host half of a verify dispatch (reference :1800-1945): the
        windows, then each slot's tokens, its spec counts, the paged
        rollback past the accepted frontier, and the retirements."""
        greedy_only = not self._temps[self._active].any()
        family = "greedy" if greedy_only else "sample"
        paged = self.kv_layout == "paged"
        self._note_dispatch(f"serve.verify_{family}_k{k}")
        # the window, clamped so it never outruns the budget (paged writes
        # stay inside the admission reservation) or the cache end; 0 on
        # non-spec rows, which then emit one decode token (reference
        # :1821-1826)
        n_draft = np.minimum(self._spec_k, np.maximum(self._remaining - 1, 0))
        n_draft = np.minimum(
            n_draft, np.maximum(self.max_seq_len - 2 - self._offsets, 0))
        n_draft = np.where(self._active, n_draft, 0)
        active_before = self._active.copy()
        t0 = time.perf_counter()
        try:
            if paged:
                self._prealloc_pages(n_draft)
            res = self._verify(k, n_draft, greedy_only)
        except Exception as e:
            self._dispatch_failed("serve_verify_exception", e, family=family,
                                  k=k)
            raise
        emit = res[:, :k + 1]
        m, a, hits, off, tok, active, remaining, replay = res[:, k + 1:].T
        self._offsets = off.copy()
        self._last_tok = tok.copy()
        self._active = active.astype(bool)
        self._remaining = remaining.copy()
        if paged:
            self._replay = replay.astype(bool)
        now = time.perf_counter()
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            tr.record_complete("serve.verify_step", t0, now,
                               {"step": self._steps, "family": family, "k": k})
        self._steps += 1
        self.decode_seconds += now - t0    # the dispatch ends in a device read
        mreg = _obs_metrics.active_registry()
        emitted = proposed = accepted = bonus = 0
        for slot in np.nonzero(active_before)[0]:
            req = self._slot_req[slot]
            ms, acc_all = int(m[slot]), int(a[slot])
            req.tokens.extend(int(t) for t in emit[slot, :ms])
            if req.first_token_ts is None:   # a replay seat's first token
                req.first_token_ts = now
            nd, acc, bn = int(n_draft[slot]), min(ms, acc_all), int(ms > acc_all)
            req.spec_proposed += nd
            req.spec_accepted += acc
            req.spec_bonus += bn
            emitted += ms
            proposed += nd
            accepted += acc
            bonus += bn
            if nd and mreg is not None:
                mreg.histogram("spec.accept_rate",
                               boundaries=_OCCUPANCY_BUCKETS).observe(acc / nd)
            if paged:
                # the pages wholly past the accepted frontier hold only
                # rejected rows: always the slot's own
                self.rollback_pages += kv_pages.truncate_row(
                    self._tables, self._slot_pages[slot], self._prefix.release,
                    slot, int(self._offsets[slot]) // self.page_tokens + 1)
            if not self._active[slot]:
                req.finish_reason = "eos" if hits[slot] else "length"
                self._slot_req[slot] = None
                if paged:
                    self._release_slot(slot)
                self._finish(req, now)
        self.decode_tokens += emitted
        self._count_tokens(emitted)
        monitor.stat("serving.steps").increase()
        monitor.stat("serving.verify_dispatches").increase()
        monitor.stat("serving.spec.proposed").increase(proposed)
        monitor.stat("serving.spec.accepted").increase(accepted)
        monitor.stat("serving.spec.bonus").increase(bonus)
        occupancy = float(active_before.mean())
        if mreg is not None:
            mreg.counter("serve.spec.proposed").inc(proposed)
            mreg.counter("serve.spec.accepted").inc(accepted)
            mreg.counter("serve.spec.bonus").inc(bonus)
            mreg.histogram("serve.decode_step_ms").observe((now - t0) * 1e3)
            self._note_step_gauges(mreg, occupancy)
        # one target forward a verify dispatch: steps_per_dispatch 1
        self._emit_step_record(1, int(active_before.sum()), occupancy, emitted,
                               spec=True, spec_window=k, spec_proposed=proposed,
                               spec_accepted=accepted, spec_bonus=bonus)

    # ---- bookkeeping ---------------------------------------------------
    def _dispatch_failed(self, reason: str, e: Exception, **where) -> None:
        """A failed decode or verify dispatch dumps the flight ring and
        takes every in-flight request with it, each finished as an error
        (the caller re-raises)."""
        fr = _obs_flight.get()
        if fr is not None:
            fr.dump(reason, {"step": self._steps, **where, "error": repr(e)})
        for slot in np.nonzero(self._active)[0]:
            req = self._slot_req[slot]
            if req is not None and req.done_ts is None:
                self._finish(req, outcome="error")

    def _note_dispatch(self, label: str) -> None:
        self._dispatches[label] = self._dispatches.get(label, 0) + 1

    def _note_step_gauges(self, mreg, occupancy: float) -> None:
        mreg.histogram("serve.occupancy",
                       boundaries=_OCCUPANCY_BUCKETS).observe(occupancy)
        mreg.gauge("serve.queue_depth").set(len(self._queue))
        mreg.gauge("serve.active_slots").set(int(self._active.sum()))
        if self.kv_layout == "paged":
            mreg.gauge("serve.pages_in_use").set(self._pool.in_use)
            mreg.gauge("serve.pages_cached").set(self._pool.cached)
            mreg.gauge("serve.prefix_hit_rate").set(self._prefix.hit_rate)

    def _emit_step_record(self, n_steps: int, active_slots: int,
                          occupancy: float, tokens: int, **spec) -> None:
        """One ``serve_step`` record a dispatch to the sink and the flight
        ring (reference :1956-1980, :2098-2119); occupancy is the mean over
        the dispatch's steps (retired slots idle masked until it ends)."""
        fr = _obs_flight.get()
        if self.sink is None and fr is None:
            return
        rec = {"event": "serve_step", "step": self._steps, "ts": time.time(),
               "steps_per_dispatch": n_steps, "active_slots": active_slots,
               "slot_count": self.slot_count, "occupancy": round(occupancy, 4),
               "queue_depth": len(self._queue), "tokens": tokens, **spec}
        if self.kv_layout == "paged":
            rec["pages_in_use"] = self._pool.in_use
            rec["pages_cached"] = self._pool.cached
            rec["prefix_hit_rate"] = round(self._prefix.hit_rate, 4)
        if self.sink is not None:
            self.sink.write(rec)
        if fr is not None:
            fr.record(rec)

    def _emit_registry_rollup(self) -> None:
        """Cumulative ``exec_registry`` record for the sink and the flight
        ring (reference :816-830). The port compiles nothing: the record
        keeps the reference's executable labels, each with its dispatch
        count, and no hit, miss or compile fields."""
        fr = _obs_flight.get()
        if self.sink is None and fr is None:
            return
        rec = {"event": "exec_registry", "ts": time.time(), "registry": "serve",
               "entries": len(self._dispatches),
               "dispatches": sum(self._dispatches.values()),
               "labels": {lbl: {"dispatches": n}
                          for lbl, n in sorted(self._dispatches.items())}}
        if self.sink is not None:
            self.sink.write(rec)
        if fr is not None:
            fr.record(rec)

    @staticmethod
    def _count_tokens(n: int) -> None:
        if n:
            monitor.stat("serving.tokens").increase(n)

    def _finish(self, req: Request, now: Optional[float] = None,
                outcome: Optional[str] = None) -> None:
        """The request leaves the engine (reference :2127-2202): normal
        completions inherit finish_reason ("ok" as the fallback) and join
        ``_completed``; "error" and "drained" are passed explicitly and stay
        out of it. Counts ``serving.outcome.<outcome>``, closes the
        request's spans and writes its ``serve_request`` record."""
        req.done_ts = now if now is not None else time.perf_counter()
        req.outcome = outcome or req.outcome or req.finish_reason or "ok"
        if req.outcome not in ("error", "drained"):
            self._completed.append(req)
        monitor.stat("serving.requests").increase()
        monitor.stat("serving.outcome." + req.outcome).increase()
        tr = _obs_tracer.get_tracer()
        if tr.enabled:
            # enqueue (instant at submit) -> queue_wait -> prefill (at
            # admission) -> decode -> request envelope -> retire marker
            if req.first_token_ts is not None:
                tr.record_complete("serve.decode", req.first_token_ts,
                                   req.done_ts,
                                   req.trace_args(tokens=len(req.tokens)))
            tr.record_complete("serve.request", req.submit_ts, req.done_ts,
                               req.trace_args(finish=req.finish_reason))
            tr.instant("serve.retire", **req.trace_args(slot=req.slot))
        mreg = _obs_metrics.active_registry()
        if mreg is not None:
            mreg.counter("serve.requests").inc()
            if req.outcome == "error":
                mreg.counter("serve.errors").inc()
            if req.ttft_s is not None:
                mreg.histogram("serve.ttft_ms").observe(req.ttft_s * 1e3)
            if req.tpot_s is not None:
                mreg.histogram("serve.tpot_ms").observe(req.tpot_s * 1e3)
            if self.replica_name:
                pfx = f"serve.replica.{self.replica_name}."
                mreg.counter(pfx + "requests").inc()
                if req.outcome == "error":
                    mreg.counter(pfx + "errors").inc()
                if req.ttft_s is not None:
                    mreg.histogram(pfx + "ttft_ms").observe(req.ttft_s * 1e3)
        fr = _obs_flight.get()
        if self.sink is None and fr is None:
            return
        wall = max(req.done_ts - req.submit_ts, 1e-9)

        def r6(v):
            return round(v, 6) if v is not None else None

        rec = {
            "event": "serve_request", "request_id": req.id, "ts": time.time(),
            "prompt_len": int(len(req.prompt_ids)),
            "bucket": req.bucket, "slot": req.slot,
            "new_tokens": len(req.tokens),
            "finish_reason": req.finish_reason, "outcome": req.outcome,
            "ttft_s": r6(req.ttft_s), "queue_wait_s": r6(req.queue_wait_s),
            "tpot_s": r6(req.tpot_s), "wall_s": round(wall, 6),
            "tokens_per_sec": round(len(req.tokens) / wall, 2),
            "queue_depth_at_submit": req.queue_depth_at_submit,
            "layout": self.kv_layout, "prefix_hit": req.prefix_hit,
            "shared_tokens": req.shared_tokens,
        }
        if req.speculate_k:
            rec["spec_k"] = req.speculate_k
            rec["spec_proposed"] = req.spec_proposed
            rec["spec_accepted"] = req.spec_accepted
            rec["spec_bonus"] = req.spec_bonus
        if req.tenant is not None:
            rec["tenant"] = req.tenant
        if req.trace_ctx is not None:
            rec["fleet_request_id"] = req.trace_ctx.request_id
        if self.sink is not None:
            self.sink.write(rec)
        if fr is not None:
            fr.record(rec)
