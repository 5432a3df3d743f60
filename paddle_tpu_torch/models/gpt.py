"""GPT family (counterpart of paddle_tpu/models/gpt.py).

Same modules, parameter names and arithmetic as the JAX model, so a state
dict carries over by name (models/convert.py). What is ported: the
no-cache forward (scoring and training; causal attention goes to the flash
kernels on the card, forward and backward), the training loss
``forward(ids, labels)`` through the chunked fused LM-head cross entropy,
dropout, recompute ("full" and "selective", distributed/fleet/utils.py),
the contiguous KV-cache path with a scalar or a per-row offset (serving),
the paged KV cache (serving/kv_pages.py), and ``generate`` (greedy, top-k /
top-p sampling, beam search). Parameters are trainable; the serving engine
and ``generate`` run under ``no_grad``.

Tensor parallelism: the model is built from the mp layers
(distributed/meta_parallel/mp_layers.py), as the JAX model is, over the mp
group of the topology that ``fleet.init`` set when the model is built.
Each rank holds its shards (qkv and fc1 by output, with qkv split per head
into its heads of q, of k and of v; out_proj and fc2 by input; wte and an
untied lm_head by vocab rows) and runs ``num_heads / mp`` heads. At mp = 1
the layers are the dense ones, bit for bit, and the loss is the fused
chunked one; at mp > 1 the loss is vocab-sharded logits ->
``ParallelCrossEntropy`` -> mean, as the JAX model's is (its
``_can_fuse_loss``). Random weights are drawn as the logical tensors and
sliced, so every mp degree starts from the mp = 1 weights. Decode and
serving are single-replica, as in the reference: ``generate`` and the
serving engine raise on an mp > 1 model. Under sequence parallelism
(distributed/meta_parallel/sequence_parallel.py) each rank holds ``s / sp``
positions, and its position embedding starts at its block's offset.

Dropout draws from the model's own ``torch.Generator`` (on the model's
device, seeded from the constructor's ``seed``), where the JAX model folds
the step's PRNG key: the masks differ by design.

KV caches are updated in place, where the JAX model returns new arrays: the
same tensors come back in the returned cache tuple.

``generate`` runs eagerly, one step a token, where the JAX model compiles the
whole decode into one program; sampled tokens come from the seeded Gumbel
streams of serving/sampling.py, so they differ from JAX's by design while
greedy and beam tokens agree exactly.
"""
from __future__ import annotations

import re
from concurrent.futures import ThreadPoolExecutor

import torch
from torch import nn

from ..amp import autocast_dtype_for, cast_inputs
from ..device import resolve_device
from ..distributed.fleet.utils import recompute
from ..distributed.meta_parallel import sequence_parallel as _sp
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   ParallelCrossEntropy,
                                                   RowParallelLinear,
                                                   VocabParallelEmbedding, copy_to_mp,
                                                   gather_from_mp, logical_shape, mp_info,
                                                   mp_slice, reduce_from_mp,
                                                   sharded_parameters)
from ..jit import _tracing
from ..ops import nn_functional as F
from ..ops.fused import fused_linear_cross_entropy
from ..serving import kv_pages
from .convert import PIPE_MP_SPLITS, PIPE_STACKED
from ..serving.bucketing import resolve_bucket
from ..serving.sampling import gumbel_noise, sample_tokens

IGNORE_INDEX = -100  # ParallelCrossEntropy's default in the JAX model

DRAW_BLOCK = 1 << 22    # entries a generator of draw_normals draws, at most a whole row more


def draw_normals(shapes, seed, out=None):
    """N(0, 0.02) host f32 tensors of ``shapes``, the GPT models' initial
    matrices. Each is cut into blocks of whole rows (dim 0) of about
    DRAW_BLOCK entries, and block j of tensor i is drawn by its own
    generator, seeded from (seed, i, j), on torch.get_num_threads() threads:
    the values depend on the shapes and the seed alone. ``out``: for each
    shape, a contiguous host tensor to draw into, or None for a new one."""
    tensors = [o if o is not None else torch.empty(sh)
               for sh, o in zip(shapes, out or [None] * len(shapes))]
    jobs = []
    for i, t in enumerate(tensors):
        rows = max(1, DRAW_BLOCK // max(1, t[0].numel()))
        for j, block in enumerate(t.split(rows)):
            jobs.append((block, ((int(seed) * 1_000_003 + i) * 65_537 + j) % (1 << 63)))

    @torch.no_grad()    # grad mode is per thread
    def draw(job):
        block, key = job
        block.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(key))

    threads = min(torch.get_num_threads(), len(jobs))
    if threads > 1:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(draw, jobs))
    else:
        for job in jobs:
            draw(job)
    return tensors

class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=1024, dropout=0.0,
                 attention_dropout=0.0, use_recompute=False,
                 recompute_granularity="full", dtype="float32",
                 tie_word_embeddings=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.use_recompute = use_recompute
        # "full" | "selective" (distributed/fleet/utils.py): selective saves
        # the linear layers' outputs and recomputes the rest
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype
        self.tie_word_embeddings = tie_word_embeddings


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
                     max_seq_len=128, **kw)


def gpt_345m(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
                     max_seq_len=1024, **kw)


def gpt_1p3b(**kw):
    """GPT-3 1.3B (BASELINE config 4)."""
    return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24, num_heads=16,
                     max_seq_len=2048, **kw)


class Linear(nn.Linear):
    """``nn.Linear`` whose product goes through ``F.linear`` (the autocast
    lookup of the JAX op ``"linear"``)."""

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, hidden_size, epsilon=1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))
        self.epsilon = epsilon

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1], self.weight, self.bias, self.epsilon)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        _, _, mp = mp_info()
        if config.num_heads % mp:
            raise ValueError(f"num_heads {config.num_heads} is not divisible by the "
                             f"model-parallel degree {mp}")
        # this rank's heads (all of them at mp = 1)
        self.num_heads = config.num_heads // mp
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size // mp
        self.qkv_proj = ColumnParallelLinear(config.hidden_size, 3 * config.hidden_size,
                                             gather_output=False, mp_blocks=3)
        self.out_proj = RowParallelLinear(config.hidden_size, config.hidden_size,
                                          input_is_parallel=True)
        self.attn_dropout = config.attention_dropout
        self.generator = None  # the model's dropout generator (set by the model)

    def forward(self, x, cache=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(dim=2)
        if cache is None:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.attn_dropout,
                training=self.training, generator=self.generator)
            return self.out_proj(out.reshape(b, s, self.hidden_size))

        dev = x.device
        if hasattr(cache, "page_table"):
            # paged serving cache (serving/kv_pages.py): scatter this chunk's
            # K/V through the rows' page tables, gather the logical cache back
            # (int8 pages dequantized) and mask exactly like the per-row
            # contiguous branch; unallocated entries alias the zero page, so
            # the gathered values match a zeroed contiguous cache
            kc, vc, new_cache = kv_pages.update_and_read(cache, k, v)
            qpos = cache.offset.to(torch.long)[:, None] + torch.arange(s, device=dev)[None, :]
            mask = (torch.arange(kc.shape[1], device=dev)[None, None, :]
                    <= qpos[:, :, None])[:, None]                      # [b, 1, s, T]
            out = F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)
            return self.out_proj(out.reshape(b, s, self.hidden_size)), new_cache

        # KV cache = (k_cache, v_cache, offset), [b, T, nh, hd] buffers; the
        # new chunk writes positions [offset, offset + s) and attends to
        # every cached position <= its own
        kc, vc, offset = cache
        total = kc.shape[1]
        if torch.is_tensor(offset) and offset.dim() == 1:
            # per-row offsets (serving slot cache): each row writes its chunk
            # at its own position; rows past a row's offset are masked, so
            # idle slots stay inert. Write positions clamp to the buffer.
            off = offset.to(device=dev, dtype=torch.long)
            qpos = off[:, None] + torch.arange(s, device=dev)[None, :]  # [b, s]
            rows = torch.arange(b, device=dev)[:, None]
            pos = qpos.clamp(0, total - 1)
            kc[rows, pos] = k.to(kc.dtype)
            vc[rows, pos] = v.to(vc.dtype)
            mask = (torch.arange(total, device=dev)[None, None, :]
                    <= qpos[:, :, None])[:, None]                      # [b, 1, s, T]
            new_offset = offset + s
        else:
            off = int(offset)
            start = min(max(off, 0), total - s)  # dynamic_update_slice's clamp
            kc[:, start:start + s] = k.to(kc.dtype)
            vc[:, start:start + s] = v.to(vc.dtype)
            qpos = off + torch.arange(s, device=dev)                    # [s]
            mask = torch.arange(total, device=dev)[None, :] <= qpos[:, None]  # [s, T]
            new_offset = off + s
        out = F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask)
        return (self.out_proj(out.reshape(b, s, self.hidden_size)),
                (kc, vc, new_offset))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.fc1 = ColumnParallelLinear(config.hidden_size, config.ffn_hidden_size,
                                        gather_output=False)
        self.fc2 = RowParallelLinear(config.ffn_hidden_size, config.hidden_size,
                                     input_is_parallel=True)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.ln1 = LayerNorm(config.hidden_size)
        self.attn = GPTAttention(config)
        self.ln2 = LayerNorm(config.hidden_size)
        self.mlp = GPTMLP(config)
        self.dropout = config.dropout
        self.use_recompute = config.use_recompute
        self.recompute_granularity = config.recompute_granularity
        self.generator = None  # the model's dropout generator (set by the model)

    def _drop(self, x):
        return F.dropout(x, self.dropout, training=self.training,
                         generator=self.generator)

    def _forward(self, x):
        h = x + self._drop(self.attn(self.ln1(x)))
        return h + self._drop(self.mlp(self.ln2(h)))

    def forward(self, x, cache=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache)
            h = x + a
            return h + self.mlp(self.ln2(h)), new_cache
        if self.use_recompute and self.training:
            gens = () if self.generator is None else (self.generator,)
            return recompute(self._forward, x, policy=self.recompute_granularity,
                             generators=gens)
        return self._forward(x)


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.wte = VocabParallelEmbedding(config.vocab_size, config.hidden_size)
        self.wpe = Embedding(config.max_seq_len, config.hidden_size)
        self.blocks = nn.ModuleList([GPTBlock(config) for _ in range(config.num_layers)])
        self.ln_f = LayerNorm(config.hidden_size)
        self.dropout = config.dropout
        self.generator = None  # the model's dropout generator (set by the model)

    def forward(self, input_ids, caches=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        if caches is not None:
            off = caches[0][2]
            if torch.is_tensor(off) and off.dim() == 1:  # per-row offsets -> [b, s]
                # clamped to the position table: a paged tail prefill's
                # right-pad may run past it (its rows are discarded; the JAX
                # gather clamps)
                pos = (off.to(device=dev, dtype=torch.long)[:, None]
                       + torch.arange(s, device=dev)[None, :]).clamp_max(
                           self.config.max_seq_len - 1)
            else:
                pos = int(off) + torch.arange(s, device=dev)
        else:   # under sp, this rank's block of positions
            pos = _sp.position_offset(s) + torch.arange(s, device=dev)
        x = self.wte(input_ids) + self.wpe(pos)
        x = F.dropout(x, self.dropout, training=self.training, generator=self.generator)
        if caches is not None:
            new_caches = []
            for blk, cache in zip(self.blocks, caches):
                x, c = blk(x, cache=cache)
                new_caches.append(c)
            return self.ln_f(x), new_caches
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)

    @staticmethod
    def fsdp_layer_key(name: str) -> str:
        """FSDP bucket of parameter ``name`` (reference gpt.py:231): one
        bucket a transformer block, the token and position embeddings
        together, everything else (the final norm) in a tail bucket. By
        name prefix, so it holds for GPTForPretraining's ``gpt.`` names."""
        m = re.match(r"(.*\bblocks\.\d+)\.", name)
        if m:
            return m.group(1)
        if ".wte." in name or ".wpe." in name or name.startswith(("wte.", "wpe.")):
            return "embeddings"
        return "final"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class GPTForPretraining(nn.Module):
    """GPT with its LM head. ``forward(ids)`` / ``logits(ids)`` -> [b, s, vocab];
    ``forward(ids, labels)`` -> the scalar LM loss (the engine's signature).

    Weights are random, drawn from ``seed`` with an explicit generator (GPT-2's
    scheme: N(0, 0.02) for matrices and embeddings, zero biases, unit norm
    scales), or loaded with models/convert.py. ``device`` defaults to
    ``cuda`` and raises when there is none; pass ``device="cpu"`` for the
    plain path. The model starts in training mode, as the JAX model does."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.mp_group, _, self.mp_size = mp_info()
        with torch.device("meta"):
            self.gpt = GPTModel(config)
            self.lm_head = (None if config.tie_word_embeddings else
                            ColumnParallelLinear(config.hidden_size, config.vocab_size,
                                                 has_bias=False, gather_output=False))
        self.loss_fn = ParallelCrossEntropy(ignore_index=IGNORE_INDEX)
        self.to_empty(device="cpu")
        self.init_weights(seed)
        self.to(device=dev, dtype=_DTYPES[config.dtype])
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        for m in self.modules():
            if hasattr(m, "generator") and m is not self:
                m.generator = self.generator

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Each matrix drawn as its logical tensor (draw_normals) and sliced
        to the rank's shard: the same weights at every mp degree."""
        _, mp_rank, _ = mp_info(self.mp_group)
        splits = sharded_parameters(self)
        mats = []
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                mats.append((p, *splits.get(name, (None, 1))))
        shapes = [tuple(logical_shape(p.shape, split, size)) for p, split, size in mats]
        fulls = draw_normals(shapes, seed, out=[p if shape == tuple(p.shape) else None
                                                for (p, _, _), shape in zip(mats, shapes)])
        for (p, split, size), full in zip(mats, fulls):
            if full is not p:
                p.copy_(mp_slice(full, split, mp_rank, size))

    # names here are 'gpt.blocks.N.*', 'gpt.wte.*', 'lm_head.*' (reference gpt.py:518)
    fsdp_layer_key = staticmethod(GPTModel.fsdp_layer_key)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def _head_weight(self):
        """The LM head's [vocab, hidden] weight (the tied embedding or lm_head)."""
        return self.gpt.wte.weight if self.lm_head is None else self.lm_head.weight

    def _sharded_logits(self, h):
        """Hidden states -> this rank's vocab slice of the logits (all of
        them at mp = 1): the tied head through ``copy_to_mp`` (its input's
        gradient is summed over the mp ranks), an untied one as its
        column-parallel module."""
        if self.lm_head is None:
            return F.matmul(copy_to_mp(h, self.mp_group), self.gpt.wte.weight,
                            transpose_y=True)
        return self.lm_head(h)

    def _head_logits(self, h, params=None):
        """Hidden states -> vocab logits (shared by forward, serving and
        generate). ``params`` (``_decode_weights``' names) replaces the head's
        weights, as generate's cast copy does. An untied head runs as its
        module, as the reference's ``self.lm_head(h)``: a Linear, or the
        quantized or QAT layer that incubate/quantization.py swapped in. At
        mp > 1 the ranks' vocab slices are gathered: the logical logits."""
        if params is None:
            return gather_from_mp(self._sharded_logits(h), self.mp_group)
        if self.lm_head is None:
            return F.matmul(h, params["gpt.wte.weight"], transpose_y=True)
        head = {n[len("lm_head."):]: p for n, p in params.items()
                if n.startswith("lm_head.")}
        return torch.func.functional_call(self.lm_head, head, (h,))

    def logits(self, input_ids):
        return self._head_logits(self.gpt(input_ids))

    def forward(self, input_ids, labels=None):
        if labels is None:
            return self.logits(input_ids)
        h = self.gpt(input_ids)
        if self.mp_size > 1:
            # vocab-sharded logits -> ParallelCrossEntropy -> mean (the
            # reference's path when _can_fuse_loss is false)
            return F.mean(self.loss_fn(self._sharded_logits(h), labels))
        if self.lm_head is not None and not isinstance(self.lm_head, ColumnParallelLinear):
            # a quantized or QAT head: its logits, then the reference's
            # softmax_with_cross_entropy (f32, ignored positions 0)
            logits = self._head_logits(h).float()
            lb = labels.to(device=logits.device, dtype=torch.long)
            ignored = lb == IGNORE_INDEX
            picked = logits.gather(-1, lb.masked_fill(ignored, 0)[..., None])[..., 0]
            return F.mean(torch.where(ignored, 0.0, torch.logsumexp(logits, -1) - picked))
        # chunked LM head + cross entropy: the [b, s, vocab] logits are never
        # materialized; the mean runs over every position, ignored ones as 0
        loss = fused_linear_cross_entropy(h, self._head_weight(), labels,
                                          transpose_y=True, ignore_index=IGNORE_INDEX)
        return F.mean(loss)

    # ------------------------------------------------------------- decode
    def _decode_setup(self, b, total):
        """What a decode call runs on: ``_decode_weights``' weights (all of
        them, for the head, and the body's under their ``gpt.``-less names)
        and per layer a zeroed contiguous [b, total, nh, hd] K and V cache in
        its cache dtype."""
        cfg = self.config
        params, cache_dtype = self._decode_weights()
        gpt_params = {n[len("gpt."):]: p for n, p in params.items() if n.startswith("gpt.")}
        nh, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        caches = [tuple(torch.zeros((b, total, nh, hd), dtype=cache_dtype,
                                    device=self.device) for _ in range(2)) + (0,)
                  for _ in range(cfg.num_layers)]
        return gpt_params, params, caches

    def _decode_weights(self):
        """(name -> tensor, KV cache dtype) as decode runs under the active
        ``auto_cast`` (reference gpt.py:618-639, serving/engine.py:345-374):
        the parameters and buffers (a quantized layer's int8 weight and
        scales are buffers), floating ones with 2 or more dims cast to the
        matmul op's autocast dtype, the rest detached as they are; the cache
        in the attention op's autocast dtype, or the embedding's dtype
        without autocast. Shared by ``generate`` and the serving engine,
        which are single-replica: an mp > 1 model raises."""
        if self.mp_size > 1:
            raise NotImplementedError(
                f"decode on a model sharded over {self.mp_size} model-parallel ranks: "
                "generate and serving are single-replica inference paths, as in the "
                "reference (gpt.py:566-567; mp decode would shard the head and sum "
                "the logits). Gather the weights into an mp = 1 model "
                "(TrainStepEngine.state_dict) to decode (ROADMAP.md Queue 1 item 9)")
        w_dtype = autocast_dtype_for("matmul")
        state = dict(self.named_parameters())
        state.update(self.named_buffers())
        params = {n: (p.detach().to(w_dtype) if w_dtype is not None and p.dim() >= 2
                      and p.is_floating_point() else p.detach())
                  for n, p in state.items()}
        return params, autocast_dtype_for("attention") or self.gpt.wte.weight.dtype

    def _decode_body(self, gpt_params, ids, caches):
        """The model body on ``gpt_params`` through the KV caches."""
        return torch.func.functional_call(self.gpt, gpt_params, (ids,),
                                          {"caches": caches})

    @torch.no_grad()
    @_tracing()      # the JAX model traces its decode (jit.py)
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0,
                 decode_strategy=None, num_beams=1, length_penalty=1.0,
                 prompt_bucket=None):
        """Autoregressive decode with a KV cache (reference gpt.py:543): the
        prefill fills fixed [b, total, nh, hd] caches, then each step emits
        one token for every row. Greedy when temperature == 0 (first maximum
        on ties, as argmax is in JAX); otherwise the logits are scaled by the
        temperature, filtered to top-k then top-p, and drawn with the Gumbel
        noise of serving/sampling.py: the token at position p of row i comes
        from the stream (seed + i, p), as a ServingEngine request of seed
        seed + i draws it. After eos_token_id every later position repeats
        eos.

        decode_strategy follows the reference's generate(): None picks greedy
        or sampling from temperature; "beam_search" (or num_beams > 1) goes
        to generate_beam. prompt_bucket (an int rung or a ladder) right-pads
        the prompt to its rung; causal attention leaves the tokens as the
        unpadded call's. Returns int64 [b, prompt + max_new_tokens] on the
        model's device; the model's training mode is restored on exit."""
        if decode_strategy not in (None, "greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(
                f"decode_strategy must be 'greedy_search', 'sampling' or "
                f"'beam_search', got {decode_strategy!r}")
        if decode_strategy == "beam_search" or (decode_strategy is None
                                                and num_beams > 1):
            if num_beams < 2:
                raise ValueError(
                    "beam_search needs num_beams >= 2 (reference generate() "
                    f"semantics), got {num_beams}")
            if prompt_bucket is not None:
                raise ValueError(
                    "prompt_bucket is not supported with beam_search")
            return self.generate_beam(
                input_ids, max_new_tokens=max_new_tokens,
                num_beams=int(num_beams),
                length_penalty=length_penalty, eos_token_id=eos_token_id)
        if num_beams > 1:
            raise ValueError(
                f"num_beams={num_beams} conflicts with "
                f"decode_strategy={decode_strategy!r}; use 'beam_search'")
        if decode_strategy == "greedy_search":
            temperature = 0.0
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.long)
        b, prompt = ids.shape
        bucketed = prompt_bucket is not None
        padded_len = resolve_bucket(prompt, prompt_bucket) if bucketed else prompt
        total = padded_len + max_new_tokens
        if total > self.config.max_seq_len:
            raise ValueError(f"prompt {padded_len}"
                             f"{' (bucketed)' if bucketed else ''} + "
                             f"max_new_tokens {max_new_tokens} exceeds "
                             f"max_seq_len {self.config.max_seq_len}")
        if bucketed:
            ids_in = torch.nn.functional.pad(ids, (0, padded_len - prompt))
        else:
            ids_in = ids
        vocab = self.config.vocab_size
        row_seeds = [int(seed) + i for i in range(b)]

        def sample(logits, pos):
            if temperature == 0:
                return torch.argmax(logits.float(), dim=-1)
            noise = gumbel_noise(row_seeds, [pos] * b, vocab, self.device)
            return sample_tokens(logits, noise, [float(temperature)] * b,
                                 [int(top_k)] * b, [float(top_p)] * b)

        was_training = self.training
        self.eval()
        try:
            gpt_params, params, caches = self._decode_setup(b, total)
            h, caches = self._decode_body(gpt_params, ids_in, caches)
            # logits from the last real position; decode resumes at the
            # prompt's length, overwriting one pad row per token before any
            # query attends to it
            tok = sample(self._head_logits(h[:, prompt - 1], params), prompt)
            caches = [(kc, vc, prompt) for kc, vc, _ in caches]
            done = (torch.zeros(b, dtype=torch.bool, device=self.device)
                    if eos_token_id is None else tok == eos_token_id)
            out = [tok]
            for t in range(1, max_new_tokens):
                h, caches = self._decode_body(gpt_params, tok[:, None], caches)
                nxt = sample(self._head_logits(h[:, 0], params), prompt + t)
                if eos_token_id is not None:
                    nxt = torch.where(done, eos_token_id, nxt)
                    done = done | (nxt == eos_token_id)
                out.append(nxt)
                tok = nxt
        finally:
            if was_training:
                self.train()
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)

    @torch.no_grad()
    @_tracing()      # the JAX model traces its decode (jit.py)
    def generate_beam(self, input_ids, max_new_tokens=32, num_beams=4,
                      length_penalty=1.0, eos_token_id=None):
        """Beam-search decode (reference gpt.py:770). The KV cache carries a
        beam dim, [b*K, total, nh, hd]; each step log-softmaxes every beam's
        logits in f32, takes the top K of the [K*V] continuations and
        reorders the cache by gathering the parent beams' rows. A finished
        beam emits a forced eos at log-prob 0, so its score freezes. Returns
        the best beam per row, [b, prompt + max_new_tokens], ranked by
        score / length**length_penalty (GNMT); positions after its eos
        repeat eos. The top K breaks ties toward the lower index, as
        jax.lax.top_k does (a stable descending sort)."""
        cfg = self.config
        K = int(num_beams)
        ids = torch.as_tensor(input_ids).to(device=self.device, dtype=torch.long)
        b, prompt = ids.shape
        total = prompt + max_new_tokens
        if total > cfg.max_seq_len:
            raise ValueError(f"prompt {prompt} + max_new_tokens "
                             f"{max_new_tokens} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        dev = self.device
        NEG = -1e30

        def top(x, k):
            vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
            return vals[..., :k], idx[..., :k]

        was_training = self.training
        self.eval()
        try:
            gpt_params, params, caches = self._decode_setup(b, total)
            h, caches = self._decode_body(gpt_params, ids, caches)
            logp0 = torch.log_softmax(self._head_logits(h[:, -1], params).float(), dim=-1)
            vocab = logp0.shape[-1]
            scores, tok0 = top(logp0, K)                      # [b, K]
            toks = torch.zeros((b, K, max_new_tokens), dtype=torch.long, device=dev)
            toks[:, :, 0] = tok0
            finished = (torch.zeros((b, K), dtype=torch.bool, device=dev)
                        if eos_token_id is None else tok0 == eos_token_id)
            lengths = torch.ones((b, K), dtype=torch.float32, device=dev)
            # row i -> beams i*K .. i*K+K-1
            caches = [(kc.repeat_interleave(K, dim=0), vc.repeat_interleave(K, dim=0),
                       prompt) for kc, vc, _ in caches]
            if eos_token_id is not None:
                eos_row = torch.full((vocab,), NEG, dtype=torch.float32, device=dev)
                eos_row[eos_token_id] = 0.0
            for t in range(1, max_new_tokens):
                prev = toks[:, :, t - 1].reshape(b * K)
                h, caches = self._decode_body(gpt_params, prev[:, None], caches)
                logp = torch.log_softmax(self._head_logits(h[:, 0], params).float(),
                                         dim=-1).reshape(b, K, vocab)
                if eos_token_id is not None:
                    # finished beams: only "emit eos again, score unchanged"
                    logp = torch.where(finished[..., None], eos_row, logp)
                cand = (scores[..., None] + logp).reshape(b, K * vocab)
                scores, idx = top(cand, K)
                beam_idx = idx // vocab
                token = idx % vocab
                toks = torch.gather(toks, 1, beam_idx[..., None].expand(-1, -1, max_new_tokens))
                toks[:, :, t] = token
                fin_g = torch.gather(finished, 1, beam_idx)
                len_g = torch.gather(lengths, 1, beam_idx)
                lengths = torch.where(fin_g, len_g, len_g + 1.0)
                finished = fin_g if eos_token_id is None else fin_g | (token == eos_token_id)
                # this step's K/V went in for the old beam order: each child
                # takes its parent's rows, the new one included
                rows = (torch.arange(b, device=dev)[:, None] * K + beam_idx).reshape(-1)
                caches = [(kc[rows], vc[rows], off) for kc, vc, off in caches]
        finally:
            if was_training:
                self.train()
        norm = scores / torch.pow(lengths, float(length_penalty))
        best = torch.argmax(norm, dim=1)
        best_toks = toks[torch.arange(b, device=dev), best]     # [b, max_new]
        if eos_token_id is not None:
            is_eos = best_toks == eos_token_id
            seen = (torch.cumsum(is_eos.long(), dim=1) - is_eos.long()) > 0
            best_toks = torch.where(seen, eos_token_id, best_toks)
        return torch.cat([ids, best_toks], dim=1)


class GPTForPretrainingPipe(nn.Module):
    """Pipeline-parallel GPT (reference gpt.py:249; the reference's
    GPTForPretrainingPipe / PipelineLayer, fleet/meta_parallel/pp_layers.py:159
    and pipeline_parallel.py:31).

    The transformer body is stacked per-stage parameters under the JAX
    model's names and layout (``qkv_w [S, Lp, H, 3H]``, ``proj_w [S, Lp, H,
    H]``, ..., ``[in, out]`` matrices; ``[V, S, Lp, ...]`` with
    ``num_virtual_stages`` V > 1, leaf [v, r] logical stage v S + r), S =
    ``num_stages`` (default the topology's pp degree) and Lp = layers / (S V).
    When the topology's pp degree is S, each pp rank holds only its stage
    (a stage dim of 1, ``pp_splits``) and under mp its mp shards
    (``mp_splits``: qkv per head, its heads of q, of k and of v; fc1 by
    output; proj and fc2 by input, followed by ``reduce_from_mp``), and the
    body runs as distributed/pipeline_schedule.py's ``spmd_pipeline`` (or
    ``spmd_pipeline_interleaved``) over the pp group on
    ``num_microbatches`` micro-batches. Otherwise it holds every stage and
    the body is one pass over the layers in logical order, on the whole
    batch; setting ``pipeline_ring`` to a ``VirtualRing(S)`` runs the S
    stages through the schedule in this process instead.

    The embeddings, ``ln_f`` and the loss are replicated over pp (every pp
    rank computes them from the replicated last-stage output). The loss is
    the chunked fused LM loss when the embeddings are tied and mp <= 1, as
    in the reference; otherwise mp-sharded logits and
    ``ParallelCrossEntropy``. Attention is ``ops.nn_functional``'s
    ``scaled_dot_product_attention`` (the flash kernels on the card; the
    reference's dense masked einsum computes the same function).
    ``use_recompute`` checkpoints each block. Weights are drawn from
    ``seed`` as the logical tensors and sliced (N(0, 0.02) matrices and
    embeddings, zero biases, unit norm scales), so every pp and mp degree
    starts from the same weights; models/convert.py loads the JAX model's
    or GPTForPretraining's. ``device`` defaults to ``cuda``.
    ``forward(ids, labels)`` -> the scalar loss; ``forward(ids)`` -> logits."""

    _STACKED = PIPE_STACKED
    _pipeline_stacked = True  # fleet.distributed_model's pp marker

    def __init__(self, config: GPTConfig, num_stages=None, num_microbatches=None,
                 num_virtual_stages=1, device=None, seed: int = 0):
        super().__init__()
        from ..distributed.mesh import get_hybrid_communicate_group

        dev = resolve_device(device)
        hcg = get_hybrid_communicate_group()
        self.config = config
        if config.dropout or config.attention_dropout:
            raise ValueError(
                "GPTForPretrainingPipe does not support dropout yet (needs per-stage "
                "RNG plumbing through the SPMD schedule); set dropout=0")
        pp = hcg.degrees["pp"] if hcg is not None else 1
        self.num_stages = int(num_stages or pp)
        self.num_virtual_stages = V = int(num_virtual_stages)
        S = self.num_stages
        if config.num_layers % (S * V):
            raise ValueError(f"num_layers {config.num_layers} not divisible by pp x virtual "
                             f"= {S} x {V}")
        if pp > 1 and pp != S:
            raise ValueError(f"num_stages {S} differs from the topology's pp_degree {pp}")
        self.layers_per_stage = Lp = config.num_layers // (S * V)
        self.num_microbatches = int(num_microbatches or max(1, S))
        self.mp_group, self.mp_rank, self.mp_size = mp_info()
        mp = self.mp_size
        if config.num_heads % mp:
            raise ValueError(f"num_heads {config.num_heads} is not divisible by the "
                             f"model-parallel degree {mp}")
        self.pp_group = hcg.get_pipe_parallel_group() if pp > 1 else None
        self.pp_size, self.pp_rank = (pp, hcg.get_stage_id()) if pp > 1 else (1, 0)
        self.pipeline_ring = None
        H, FF = config.hidden_size, config.ffn_hidden_size
        lead = ((V,) if V > 1 else ()) + (S // self.pp_size, Lp)
        shapes = {"qkv_w": (H, 3 * H // mp), "qkv_b": (3 * H // mp,),
                  "proj_w": (H // mp, H), "proj_b": (H,), "ln1_s": (H,), "ln1_b": (H,),
                  "ln2_s": (H,), "ln2_b": (H,), "fc1_w": (H, FF // mp), "fc1_b": (FF // mp,),
                  "fc2_w": (FF // mp, H), "fc2_b": (H,)}
        self.mp_splits = {n: sp for n, sp in PIPE_MP_SPLITS.items()
                          if n in shapes or not config.tie_word_embeddings}
        self.pp_splits = {n: (len(lead) - 2, 1) for n in self._STACKED}
        with torch.device("meta"):
            self.wte = VocabParallelEmbedding(config.vocab_size, H)
            self.wpe = Embedding(config.max_seq_len, H)
            self.ln_f = LayerNorm(H)
            for n in self._STACKED:
                self.register_parameter(n, nn.Parameter(torch.empty(lead + shapes[n])))
            self.lm_head_w = (None if config.tie_word_embeddings else
                              nn.Parameter(torch.empty(H, config.vocab_size // mp)))
        self.loss_fn = ParallelCrossEntropy(ignore_index=IGNORE_INDEX)
        self.to_empty(device="cpu")
        self.init_weights(seed)
        self.to(device=dev, dtype=_DTYPES[config.dtype])

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """Each parameter drawn as its logical tensor (every stage, every mp
        shard) and sliced to the rank's stage and mp shard."""
        wte_split = self.wte.mp_splits["weight"]
        mats = []
        for name, p in self.named_parameters():
            if name.endswith(("_b", ".bias")):
                p.zero_()
            elif name.endswith(("_s", "ln_f.weight")):
                p.fill_(1.0)
            else:
                mp_split = wte_split if name == "wte.weight" else self.mp_splits.get(name)
                pp_split = self.pp_splits.get(name)
                shape = logical_shape(logical_shape(p.shape, mp_split, self.mp_size),
                                      pp_split, self.pp_size)
                mats.append((p, tuple(shape), mp_split, pp_split))
        fulls = draw_normals([shape for _, shape, _, _ in mats], seed,
                             out=[p if shape == tuple(p.shape) else None
                                  for p, shape, _, _ in mats])
        for (p, _, mp_split, pp_split), full in zip(mats, fulls):
            if full is not p:
                p.copy_(mp_slice(mp_slice(full, pp_split, self.pp_rank, self.pp_size),
                                 mp_split, self.mp_rank, self.mp_size))

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def stage_params(self):
        return {n: getattr(self, n) for n in self._STACKED}

    def _body(self, lp, h):
        """The layers of ``lp`` ({name: [n, ...]}) on h, in order."""
        cfg = self.config
        nh, hd = cfg.num_heads // self.mp_size, cfg.hidden_size // cfg.num_heads
        group = self.mp_group if self.mp_size > 1 else None
        for i in range(lp["qkv_w"].shape[0]):
            layer = {n: t[i] for n, t in lp.items()}
            if cfg.use_recompute and self.training:
                h = recompute(lambda x, layer=layer: _pipe_block_fwd(x, layer, nh, hd, group),
                              h, policy=cfg.recompute_granularity)
            else:
                h = _pipe_block_fwd(h, layer, nh, hd, group)
        return h

    def hidden(self, input_ids):
        """The final hidden states (after ln_f) of ``input_ids``."""
        from ..distributed.pipeline_schedule import (microbatch_merge, microbatch_split,
                                                     spmd_pipeline,
                                                     spmd_pipeline_interleaved)

        s = input_ids.shape[1]
        pos = _sp.position_offset(s) + torch.arange(s, device=input_ids.device)
        x = self.wte(input_ids) + self.wpe(pos)
        params = self.stage_params()
        ring = self.pipeline_ring if self.pipeline_ring is not None else self.pp_group
        V = self.num_virtual_stages
        if ring is None:
            # one pass over every stage in logical order (the leading [V, S]
            # or [S] dims flatten chunk-major, the order they execute in)
            n_lead = 3 if V > 1 else 2
            h = self._body({n: p.reshape((-1,) + p.shape[n_lead:]) for n, p in params.items()},
                           x)
        else:
            mb = microbatch_split(x, self.num_microbatches)
            if V > 1:
                out = spmd_pipeline_interleaved(self._body, params, mb, ring, V)
            else:
                out = spmd_pipeline(self._body, params, mb, ring)
            h = microbatch_merge(out)
        return self.ln_f(h)

    def forward(self, input_ids, labels=None):
        h = self.hidden(input_ids)
        cfg = self.config
        if labels is not None and cfg.tie_word_embeddings and self.mp_size <= 1:
            # chunked fused LM loss (ops/fused.py), as in GPTForPretraining
            return F.mean(fused_linear_cross_entropy(h, self.wte.weight, labels,
                                                     transpose_y=True,
                                                     ignore_index=IGNORE_INDEX))
        hp = copy_to_mp(h, self.mp_group)
        if cfg.tie_word_embeddings:
            logits = F.matmul(hp, self.wte.weight, transpose_y=True)
        else:
            logits = F.matmul(hp, self.lm_head_w)
        if labels is None:
            return gather_from_mp(logits, self.mp_group)
        return F.mean(self.loss_fn(logits, labels))


def _in_out_linear(x, w, b=None):
    """``x @ w + b`` with an ``[in, out]`` weight, under the autocast lookup
    of ``"linear"`` (GPTBlock's products)."""
    x, w, b = cast_inputs("linear", x, w, b)
    return torch.nn.functional.linear(x, w.t(), b)


def _row_linear(x, w, b, group):
    """The row-parallel product: the ranks' partial products summed by
    ``reduce_from_mp``, then the bias once (RowParallelLinear's order)."""
    if group is None:
        return _in_out_linear(x, w, b)
    out = reduce_from_mp(_in_out_linear(x, w), group)
    return out + cast_inputs("linear", out, b)[1]


def _pipe_block_fwd(x, p, nh, hd, group=None):
    """One transformer block on the stacked weights of one layer (reference
    gpt.py:413), GPTBlock's arithmetic: this rank's ``nh`` heads; under mp
    (``group``) the column products take ``copy_to_mp`` of their input and
    the row products are summed over the mp ranks."""
    b, s, H = x.shape
    h = copy_to_mp(F.layer_norm(x, H, p["ln1_s"], p["ln1_b"]), group)
    qkv = _in_out_linear(h, p["qkv_w"], p["qkv_b"]).view(b, s, 3, nh, hd)
    q, k, v = qkv.unbind(dim=2)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True).reshape(b, s, nh * hd)
    x = x + _row_linear(o, p["proj_w"], p["proj_b"], group)
    h2 = copy_to_mp(F.layer_norm(x, H, p["ln2_s"], p["ln2_b"]), group)
    m = F.gelu(_in_out_linear(h2, p["fc1_w"], p["fc1_b"]), approximate=True)
    return x + _row_linear(m, p["fc2_w"], p["fc2_b"], group)
