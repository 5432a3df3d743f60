"""Serving engine: bucketed prefill + slot KV cache + continuous-batching decode
(counterpart of paddle_tpu/serving/engine.py, contiguous KV layout).

- **Bucketed prefill.** A request's prompt is right-padded to its ladder
  rung and run through the model with a rung-sized cache at offset 0; the
  hidden state at the last real position gives the first token. The cache is
  a view of the request's slot row in the engine's
  ``[slots, max_seq_len, nh, hd]`` buffers, so the prompt's K/V land in place
  (the JAX engine builds a fresh rung cache and scatters it into the row).
- **Decode chunks.** One dispatch runs ``steps_per_dispatch`` single-token
  steps for every slot, with per-slot offsets, sampling parameters, EOS and
  budget masks held on the device; the host reads tokens back once per
  chunk. Idle slots keep writing their (masked) tip row, clamped to the
  buffer.
- **Continuous batching.** A finished request retires its slot at the end
  of the chunk, and queued requests are prefilled into free slots between
  chunks.

Weights are snapshotted at construction (a private copy of the model, in
eval mode; the caller's model keeps its mode, so a model can be served and
then trained with its dropout); call ``refresh_params()`` after updating
the model. Not ported yet: the
paged KV layout and prefix cache, speculative decoding, drain/SIGTERM, the
telemetry sinks and the executable registry (PyTorch runs eagerly; there is
nothing to compile).
"""
from __future__ import annotations

import copy
import itertools
import threading
import time
from collections import deque
from typing import List, Optional, Sequence

import numpy as np
import torch

from .bucketing import DEFAULT_LADDER, bucket_for, clip_ladder
from .sampling import gumbel_noise, sample_tokens

_NO_EOS = -1


class Request:
    """One generation request and its lifecycle record."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_new_tokens, temperature, top_k, top_p,
                 eos_token_id, seed):
        self.id = next(Request._ids)
        self.prompt_ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_token_id = (int(eos_token_id) if eos_token_id is not None
                             else None)
        self.seed = int(seed)
        self.tokens: List[int] = []      # generated tokens (incl. eos if hit)
        self.bucket: Optional[int] = None
        self.slot: Optional[int] = None
        self.submit_ts: Optional[float] = None
        self.admit_ts: Optional[float] = None
        self.first_token_ts: Optional[float] = None
        self.done_ts: Optional[float] = None
        self.finish_reason: Optional[str] = None  # "eos" | "length"
        # terminal disposition: "eos" | "length" | "ok", or "error" when the
        # prefill or decode dispatch raised
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

    def output_ids(self):
        """[prompt + generated] (no post-EOS padding)."""
        return np.concatenate(
            [self.prompt_ids, np.asarray(self.tokens, np.int64)])

    def __repr__(self):
        return (f"Request(id={self.id}, prompt={len(self.prompt_ids)}, "
                f"new={len(self.tokens)}/{self.max_new_tokens}, "
                f"done={self.done})")


class ServingEngine:
    """Continuous-batching GPT serving over a slot-based KV cache.

    model: a GPTForPretraining of this package; the engine runs on the
    model's device. slot_count fixes the decode batch; ladder the prefill
    rungs (clipped to what fits max_seq_len with max_new_cap headroom).

    One thread drives it: submit() is thread-safe, step()/run() must be called
    from one thread.
    """

    def __init__(self, model, slot_count: int = 4,
                 ladder: Sequence[int] = DEFAULT_LADDER,
                 max_seq_len: Optional[int] = None,
                 max_new_cap: int = 64, steps_per_dispatch: int = 8,
                 kv_layout: str = "contiguous"):
        if kv_layout != "contiguous":
            raise NotImplementedError(
                f"kv_layout {kv_layout!r} is not ported yet; the port serves "
                "from the contiguous slot cache")
        cfg = model.config
        self.model = model      # its mode stays the caller's; the copy serves in eval
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

        self._lock = threading.Lock()
        self._queue: deque[Request] = deque()
        self._completed: List[Request] = []
        # host-clock time spent in decode chunks and the tokens they emitted
        # (decode tokens/s = decode_tokens / decode_seconds)
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self._net = None
        self.refresh_params()

        nh = cfg.num_heads
        hd = cfg.hidden_size // cfg.num_heads
        S, T = self.slot_count, self.max_seq_len
        self._kcs = [torch.zeros((S, T, nh, hd), dtype=self._cache_dtype,
                                 device=self.device)
                     for _ in range(cfg.num_layers)]
        self._vcs = [torch.zeros_like(kc) for kc in self._kcs]

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
        self._slot_req: List[Optional[Request]] = [None] * S

    # ------------------------------------------------------------- params
    def refresh_params(self) -> None:
        """Re-snapshot the model's weights into the engine's private copy."""
        if self._net is None:
            self._net = copy.deepcopy(self.model)
        else:
            self._net.load_state_dict(self.model.state_dict())
        self._net.eval()
        self._cache_dtype = self._net.gpt.wte.weight.dtype

    # ------------------------------------------------------------- public
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token_id=None, seed: int = 0) -> Request:
        """Enqueue a request; returns the live Request handle (tokens fill
        in as the engine runs). max_new_tokens is clamped to the engine cap
        and to the cache room left after the prompt's bucket."""
        req = Request(prompt_ids, max_new_tokens, temperature, top_k, top_p,
                      eos_token_id, seed)
        plen = len(req.prompt_ids)
        req.bucket = bucket_for(plen, self.ladder)  # raises if oversize
        room = self.max_seq_len - req.bucket
        req.max_new_tokens = max(1, min(req.max_new_tokens,
                                        self.max_new_cap, room))
        req.submit_ts = time.perf_counter()
        with self._lock:
            self._queue.append(req)
        return req

    def step(self) -> int:
        """Admit queued requests into free slots (bucketed prefill), then
        run ONE decode chunk for all slots. Returns the number of live
        slots after the step (0 = fully drained)."""
        self._admit()
        if self._active.any():
            self._decode_step()
        return int(self._active.sum())

    def run(self, max_steps: Optional[int] = None) -> List[Request]:
        """Drive until queue and slots drain (or max_steps dispatches);
        returns the requests completed during this call."""
        done0 = len(self._completed)
        steps = 0
        while self._queue or self._active.any():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self._completed[done0:]

    @torch.no_grad()
    def score_prompt(self, prompt_ids) -> torch.Tensor:
        """Next-token logits [vocab] of a prompt, computed exactly as
        admission's bucketed prefill does, on a scratch cache (no slot is
        touched)."""
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        return self._prefill(prompt, bucket_for(len(prompt), self.ladder),
                             slot=None)[0]

    # ---- prefill -------------------------------------------------------
    def _prefill(self, prompt: np.ndarray, bucket: int,
                 slot: Optional[int]) -> torch.Tensor:
        """Run the padded prompt through the model with a rung-sized cache at
        offset 0 (the slot row's first ``bucket`` positions, or a scratch
        cache when slot is None); returns the last real position's logits
        [1, V]. Causal masking makes the right-pad inert."""
        cfg = self._net.config
        plen = len(prompt)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :plen] = torch.from_numpy(prompt)
        padded = padded.to(self.device)
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
        h, _ = self._net.gpt(padded, caches=caches)
        return self._net._head_logits(h[:, plen - 1])

    @torch.no_grad()
    def _admit(self) -> None:
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
            plen = len(req.prompt_ids)
            req.admit_ts = time.perf_counter()    # queue wait ends here
            try:
                logits = self._prefill(req.prompt_ids, req.bucket, slot)
                noise = (None if req.temperature == 0.0 else gumbel_noise(
                    [req.seed], [plen], logits.shape[-1], self.device))
                # the first token sits at position plen
                tok = sample_tokens(logits, noise, [req.temperature],
                                    [req.top_k], [req.top_p])
                first = int(tok[0])                 # device sync = first token
            except Exception:
                self._finish(req, outcome="error")
                raise
            req.first_token_ts = time.perf_counter()
            req.slot = slot
            req.tokens.append(first)
            eos = req.eos_token_id if req.eos_token_id is not None else _NO_EOS
            if (eos != _NO_EOS and first == eos) or req.max_new_tokens <= 1:
                req.finish_reason = ("eos" if eos != _NO_EOS and first == eos
                                     else "length")
                self._finish(req)
                continue
            self._offsets[slot] = plen
            self._last_tok[slot] = first
            self._active[slot] = True
            self._temps[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._eos[slot] = eos
            self._remaining[slot] = req.max_new_tokens - 1
            self._seeds[slot] = req.seed
            self._slot_req[slot] = req

    # ---- decode --------------------------------------------------------
    @torch.no_grad()
    def _decode_chunk(self, greedy_only: bool):
        """``steps_per_dispatch`` decode steps for every slot, state on the
        device. Returns the per-step tokens, was-active and eos-hit masks
        [n_inner, S] and the final per-slot state, all as numpy."""
        dev = self.device
        T = self.max_seq_len
        vocab = self._net.config.vocab_size

        def put(a):
            return torch.as_tensor(a).to(dev)

        off, tok, active = put(self._offsets), put(self._last_tok), put(self._active)
        remaining, eos = put(self._remaining), put(self._eos)
        temps, topk, topp = put(self._temps), put(self._topk), put(self._topp)
        toks, was_active, hits = [], [], []
        for _ in range(self.steps_per_dispatch):
            off_m = off.clamp_max(T - 1)
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
            active = active & ~hit_eos & (new_remaining > 0) & (new_off < T)
            off, tok, remaining = new_off, nxt, new_remaining
        out = [torch.stack(toks), torch.stack(was_active), torch.stack(hits),
               off, tok, active, remaining]
        return [t.cpu().numpy() for t in out]

    def _decode_step(self) -> None:
        # an all-greedy slot set skips the sampling work entirely
        greedy_only = not self._temps[self._active].any()
        t0 = time.perf_counter()
        try:
            (toks, was_active, hits, off, tok, active,
             remaining) = self._decode_chunk(greedy_only)
        except Exception:
            # a failed dispatch takes every in-flight request with it
            for slot in np.nonzero(self._active)[0]:
                req = self._slot_req[slot]
                if req is not None and req.done_ts is None:
                    self._finish(req, outcome="error")
            raise
        self._offsets = off.copy()
        self._last_tok = tok.copy()
        self._active = active.copy()
        self._remaining = remaining.copy()
        n_inner = toks.shape[0]
        now = time.perf_counter()
        self.decode_seconds += now - t0    # the chunk ends in a device read
        self.decode_tokens += int(was_active.sum())
        for j in range(n_inner):
            alive_after = (was_active[j + 1] if j + 1 < n_inner
                           else self._active)
            for slot in np.nonzero(was_active[j])[0]:
                req = self._slot_req[slot]
                req.tokens.append(int(toks[j, slot]))
                if not alive_after[slot]:     # retired at this inner step
                    req.finish_reason = "eos" if hits[j, slot] else "length"
                    self._slot_req[slot] = None
                    self._finish(req, now)

    # ---- bookkeeping ---------------------------------------------------
    def _finish(self, req: Request, now: Optional[float] = None,
                outcome: Optional[str] = None) -> None:
        req.done_ts = now if now is not None else time.perf_counter()
        req.outcome = outcome or req.outcome or req.finish_reason or "ok"
        if req.outcome != "error":
            self._completed.append(req)
