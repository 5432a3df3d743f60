"""ERNIE / BERT encoder family, the BASELINE config-3 model (counterpart of
paddle_tpu/models/ernie.py): the same modules, parameter names and
arithmetic as the JAX model, so a state dict carries over by name
(models/convert.py transposes the Linear weights).

Built on the mp layers (distributed/meta_parallel/mp_layers.py) as the
JAX model is; at mp = 1 they are the dense layers. A model built over more
than one model-parallel rank raises (ROADMAP.md Queue 1 item 11).
Post-LN blocks, bidirectional attention through
``nn_functional.scaled_dot_product_attention(is_causal=False)``: with no
mask and no attention dropout it reaches the flash kernels on the card,
non-causally; with a padding mask (additive, ``(1 - mask) * -1e4``) or
attention dropout in training it takes the dense path, as in the JAX
package. Dropout draws from the model's ``torch.Generator`` (seeded from
``seed``): the masks differ from the JAX model's by design.

``ErnieForPretraining.forward(input_ids, labels, token_type_ids=None,
attention_mask=None, next_sentence_label=None)`` is the MLM loss (the tied
embedding as the decoder, ``ParallelCrossEntropy(ignore_index=-100)``,
the mean over every position, ignored ones as 0) plus, with NSP labels,
the mean NSP loss. Weights are random, drawn from ``seed`` (Xavier normal
matrices and embeddings, zero biases, unit LayerNorm scales), on
``device`` (the card unless ``device="cpu"``), built on meta and moved, as
``GPTForPretraining``.
"""
from __future__ import annotations

import math
import re

import torch
from torch import nn

from ..device import resolve_device
from ..distributed.fleet.utils import recompute
from ..distributed.meta_parallel.mp_layers import (ColumnParallelLinear,
                                                   ParallelCrossEntropy, RowParallelLinear,
                                                   VocabParallelEmbedding, mp_info)
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..nn.layers.common import building_on_meta
from ..ops import nn_functional as F

IGNORE_INDEX = -100


class ErnieConfig:
    def __init__(self, vocab_size=40000, hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, max_seq_len=512, type_vocab_size=4, dropout=0.1,
                 attention_dropout=0.1, use_recompute=False, tie_word_embeddings=True):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.use_recompute = use_recompute
        self.tie_word_embeddings = tie_word_embeddings


def ernie_tiny(**kw):
    kw.setdefault("dropout", 0.0)
    kw.setdefault("attention_dropout", 0.0)
    return ErnieConfig(vocab_size=1024, hidden_size=128, num_layers=2, num_heads=4,
                       max_seq_len=128, **kw)


def ernie_base(**kw):
    """ERNIE-3.0-base's shape (BASELINE config 3)."""
    return ErnieConfig(vocab_size=40000, hidden_size=768, num_layers=12, num_heads=12,
                       max_seq_len=512, **kw)


def ernie_large(**kw):
    return ErnieConfig(vocab_size=40000, hidden_size=1024, num_layers=24, num_heads=16,
                       max_seq_len=512, **kw)


class ErnieSelfAttention(nn.Module):
    def __init__(self, config: ErnieConfig):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        self.hidden_size = config.hidden_size
        self.qkv_proj = ColumnParallelLinear(config.hidden_size, 3 * config.hidden_size,
                                             gather_output=False)
        self.out_proj = RowParallelLinear(config.hidden_size, config.hidden_size,
                                          input_is_parallel=True)
        self.attn_dropout = config.attention_dropout
        self.generator = None  # the model's dropout generator (set by the model)

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        q, k, v = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim).unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=False, dropout_p=self.attn_dropout,
            training=self.training, generator=self.generator)
        return self.out_proj(out.reshape(b, s, self.hidden_size))


class ErnieBlock(nn.Module):
    """Post-LN encoder block (BERT / ERNIE's order, unlike GPT's pre-LN)."""

    def __init__(self, config: ErnieConfig):
        super().__init__()
        self.attn = ErnieSelfAttention(config)
        self.ln1 = LayerNorm(config.hidden_size)
        self.fc1 = ColumnParallelLinear(config.hidden_size, config.ffn_hidden_size,
                                        gather_output=False)
        self.fc2 = RowParallelLinear(config.ffn_hidden_size, config.hidden_size,
                                     input_is_parallel=True)
        self.ln2 = LayerNorm(config.hidden_size)
        self.dropout = config.dropout
        self.use_recompute = config.use_recompute
        self.generator = None

    def _drop(self, x):
        return F.dropout(x, self.dropout, training=self.training, generator=self.generator)

    def _forward(self, x, attn_mask=None):
        h = self.ln1(x + self._drop(self.attn(x, attn_mask)))
        ffn = self.fc2(F.gelu(self.fc1(h), approximate=True))
        return self.ln2(h + self._drop(ffn))

    def forward(self, x, attn_mask=None):
        if self.use_recompute and self.training:
            gens = () if self.generator is None else (self.generator,)
            return recompute(self._forward, x, attn_mask, generators=gens)
        return self._forward(x, attn_mask)


def _check_mp():
    if mp_info()[2] > 1:
        raise NotImplementedError("ERNIE over more than one model-parallel rank is not "
                                  "ported (ROADMAP.md Queue 1 item 11): build it at "
                                  "mp_degree 1")


@torch.no_grad()
def _init_weights(model, seed):
    """Xavier normal matrices and embeddings, zero biases, unit LayerNorm
    scales, drawn in parameter order from one generator seeded with
    ``seed`` (on the CPU)."""
    g = torch.Generator().manual_seed(int(seed))
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            std = math.sqrt(2.0 / (p.shape[0] + p.shape[1]))
            p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=g))


def _finish(model, device, seed):
    """Storage on the CPU, weights from ``seed``, moved to ``device``; the
    model's dropout generator handed to every module that draws."""
    model.to_empty(device="cpu")
    _init_weights(model, seed)
    model.to(device)
    model.generator = torch.Generator(device=device).manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "generator") and m is not model:
            m.generator = model.generator


def _fsdp_layer_key(name: str) -> str:
    """FSDP bucket of parameter ``name``: one a block, the embeddings
    together, the rest (pooler, heads) in a tail bucket."""
    m = re.match(r"(.*\bblocks\.\d+)\.", name)
    if m:
        return m.group(1)
    if "_emb." in name or name.startswith(("word_emb.", "pos_emb.", "type_emb.", "emb_ln.")):
        return "embeddings"
    return "final"


class ErnieModel(nn.Module):
    """``forward(input_ids, token_type_ids=None, attention_mask=None)`` ->
    (hidden states [b, s, h], pooled [b, h])."""

    def __init__(self, config: ErnieConfig, device=None, seed: int = 0):
        super().__init__()
        _check_mp()
        alone = not building_on_meta()
        dev = resolve_device(device) if alone else None
        self.config = config
        with torch.device("meta"):
            self.word_emb = VocabParallelEmbedding(config.vocab_size, config.hidden_size)
            self.pos_emb = Embedding(config.max_seq_len, config.hidden_size)
            self.type_emb = Embedding(config.type_vocab_size, config.hidden_size)
            self.emb_ln = LayerNorm(config.hidden_size)
            self.drop = Dropout(config.dropout)
            self.blocks = nn.ModuleList([ErnieBlock(config)
                                         for _ in range(config.num_layers)])
            self.pooler = Linear(config.hidden_size, config.hidden_size)
        if alone:
            _finish(self, dev, seed)

    fsdp_layer_key = staticmethod(_fsdp_layer_key)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.word_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids)
        x = self.drop(self.emb_ln(x))
        mask = None
        if attention_mask is not None:
            # [b, s] of 1 / 0 -> additive [b, 1, 1, s]
            mask = (1.0 - attention_mask.float()) * -1e4
            mask = mask.reshape(mask.shape[0], 1, 1, mask.shape[1])
        for blk in self.blocks:
            x = blk(x, mask)
        pooled = F.tanh(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForPretraining(nn.Module):
    """MLM + next-sentence heads over the encoder; returns the combined loss.
    Starts in training mode, as the JAX model does."""

    def __init__(self, config: ErnieConfig, device=None, seed: int = 0):
        super().__init__()
        _check_mp()
        dev = resolve_device(device)
        self.config = config
        with torch.device("meta"):
            self.ernie = ErnieModel(config)
            self.mlm_transform = Linear(config.hidden_size, config.hidden_size)
            self.mlm_ln = LayerNorm(config.hidden_size)
            if not config.tie_word_embeddings:
                self.mlm_decoder = ColumnParallelLinear(config.hidden_size,
                                                        config.vocab_size)
            self.nsp_head = Linear(config.hidden_size, 2)
        self.loss_fn = ParallelCrossEntropy(ignore_index=IGNORE_INDEX)
        _finish(self, dev, seed)

    fsdp_layer_key = staticmethod(_fsdp_layer_key)

    @property
    def device(self) -> torch.device:
        return self.ernie.word_emb.weight.device

    def logits(self, hidden):
        h = self.mlm_ln(F.gelu(self.mlm_transform(hidden), approximate=True))
        h = h.reshape(-1, h.shape[-1])
        if self.config.tie_word_embeddings:
            return F.matmul(h, self.ernie.word_emb.weight, transpose_y=True)
        return self.mlm_decoder(h)

    def forward(self, input_ids, labels, token_type_ids=None, attention_mask=None,
                next_sentence_label=None):
        hidden, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        logits = self.logits(hidden)
        mlm_loss = F.mean(self.loss_fn(logits, labels.reshape(-1, 1)))
        if next_sentence_label is not None:
            nsp_logits = self.nsp_head(pooled)
            nsp_loss = F.mean(F.softmax_with_cross_entropy(nsp_logits,
                                                           next_sentence_label))
            return mlm_loss + nsp_loss
        return mlm_loss


# BERT aliases: the same architecture, WordPiece-era defaults
BertConfig = ErnieConfig
BertModel = ErnieModel
BertForPretraining = ErnieForPretraining


def bert_base(**kw):
    return ErnieConfig(vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
                       max_seq_len=512, type_vocab_size=2, **kw)


def bert_large(**kw):
    return ErnieConfig(vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
                       max_seq_len=512, type_vocab_size=2, **kw)
