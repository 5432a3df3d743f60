"""GPT family (counterpart of paddle_tpu/models/gpt.py).

Same modules, parameter names and arithmetic as the JAX model, so a state
dict carries over by name (models/convert.py). What is ported: the
no-cache forward (scoring and training; causal attention goes to the flash
kernels on the card, forward and backward), the training loss
``forward(ids, labels)`` through the chunked fused LM-head cross entropy,
dropout, and the contiguous KV-cache path with a scalar or a per-row offset
(serving). Parameters are trainable; the serving engine runs under
``no_grad``. Not ported yet: recompute, tensor parallelism and
``generate()``.

Dropout draws from the model's own ``torch.Generator`` (on the model's
device, seeded from the constructor's ``seed``), where the JAX model folds
the step's PRNG key: the masks differ by design.

KV caches are updated in place, where the JAX model returns new arrays: the
same tensors come back in the returned cache tuple.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..ops import nn_functional as F
from ..ops.fused import fused_linear_cross_entropy

IGNORE_INDEX = -100  # ParallelCrossEntropy's default in the JAX model


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=1024, dropout=0.0,
                 attention_dropout=0.0, use_recompute=False, dtype="float32",
                 tie_word_embeddings=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.use_recompute = use_recompute  # not ported: the model refuses it
        self.dtype = dtype
        self.tie_word_embeddings = tie_word_embeddings


def gpt_tiny(**kw):
    return GPTConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
                     max_seq_len=128, **kw)


def gpt_345m(**kw):
    return GPTConfig(vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
                     max_seq_len=1024, **kw)


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
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = Linear(config.hidden_size, 3 * config.hidden_size)
        self.out_proj = Linear(config.hidden_size, config.hidden_size)
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

        # KV cache = (k_cache, v_cache, offset), [b, T, nh, hd] buffers; the
        # new chunk writes positions [offset, offset + s) and attends to
        # every cached position <= its own
        kc, vc, offset = cache
        total = kc.shape[1]
        dev = x.device
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
        self.fc1 = Linear(config.hidden_size, config.ffn_hidden_size)
        self.fc2 = Linear(config.ffn_hidden_size, config.hidden_size)

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
        self.generator = None  # the model's dropout generator (set by the model)

    def _drop(self, x):
        return F.dropout(x, self.dropout, training=self.training,
                         generator=self.generator)

    def forward(self, x, cache=None):
        if cache is not None:
            a, new_cache = self.attn(self.ln1(x), cache=cache)
            h = x + a
            return h + self.mlp(self.ln2(h)), new_cache
        h = x + self._drop(self.attn(self.ln1(x)))
        return h + self._drop(self.mlp(self.ln2(h)))


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        self.wte = Embedding(config.vocab_size, config.hidden_size)
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
                pos = (off.to(device=dev, dtype=torch.long)[:, None]
                       + torch.arange(s, device=dev)[None, :])
            else:
                pos = int(off) + torch.arange(s, device=dev)
        else:
            pos = torch.arange(s, device=dev)
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
        if config.use_recompute:
            raise NotImplementedError(
                "recompute (use_recompute=True) is not ported yet; see ROADMAP.md")
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.gpt = GPTModel(config)
            self.lm_head = (None if config.tie_word_embeddings else
                            Linear(config.hidden_size, config.vocab_size, bias=False))
        self.to_empty(device="cpu")
        self.init_weights(seed)
        self.to(device=dev, dtype=_DTYPES[config.dtype])
        self.generator = torch.Generator(device=dev).manual_seed(int(seed))
        for m in self.modules():
            if hasattr(m, "generator") and m is not self:
                m.generator = self.generator

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        g = torch.Generator().manual_seed(int(seed))
        for name, p in self.named_parameters():
            if name.endswith(".bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def _head_weight(self):
        """The LM head's [vocab, hidden] weight (the tied embedding or lm_head)."""
        return self.gpt.wte.weight if self.lm_head is None else self.lm_head.weight

    def _head_logits(self, h):
        """Hidden states -> vocab logits (shared by forward and serving)."""
        return F.matmul(h, self._head_weight(), transpose_y=True)

    def logits(self, input_ids):
        return self._head_logits(self.gpt(input_ids))

    def forward(self, input_ids, labels=None):
        if labels is None:
            return self.logits(input_ids)
        # chunked LM head + cross entropy: the [b, s, vocab] logits are never
        # materialized; the mean runs over every position, ignored ones as 0
        loss = fused_linear_cross_entropy(self.gpt(input_ids), self._head_weight(),
                                          labels, transpose_y=True,
                                          ignore_index=IGNORE_INDEX)
        return F.mean(loss)
