"""Transformer layers (counterpart of paddle_tpu/nn/layers/transformer.py):
``MultiHeadAttention`` (with ``Cache`` / ``StaticCache`` and
``gen_cache``), ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` and ``Transformer``.

Attention is ``F.scaled_dot_product_attention`` on ``[batch, seq, heads,
head_dim]``: without a mask and without attention dropout (eval, or a
dropout of 0) it goes to the flash kernels on the card, else the dense
path (a bool mask keeps where True, -1e9 elsewhere; a float mask is
added). Caches hold ``[batch, seq, heads, head_dim]`` keys and values and
grow along the sequence axis. The stacks deep-copy their first layer, so
every layer starts from the same weights, as in the JAX package. Dropout
masks come from each Dropout's and attention's ``generator`` attribute
(torch's default generator when None). The Linear weights are ``[out,
in]``; models/convert.py's ``layer_state_from_jax`` carries a JAX
transformer's weights over.
"""
from __future__ import annotations

import copy

import torch

from ...device import resolve_device
from ...ops import activation as A
from ...ops import nn_functional as F
from ..layer import Layer
from .common import Dropout, Linear, place
from .container import LayerList
from .norm import LayerNorm


class MultiHeadAttention(Layer):
    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim, self.vdim = kdim or embed_dim, vdim or embed_dim
        self.num_heads, self.head_dim = num_heads, embed_dim // num_heads
        self.dropout, self.need_weights = dropout, need_weights
        self.generator = None
        dev = "cpu"     # built on the CPU, moved once below
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, device=dev)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr, device=dev)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr, device=dev)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr, device=dev)
        place(self, device)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], 1)
                v = torch.cat([cache.v.to(v.dtype), v], 1)
                cache = self.Cache(k, v)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout if self.training else 0.0,
            generator=self.generator)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1], self.embed_dim))
        if isinstance(cache, self.Cache):
            return out, cache
        return out

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value``'s projections, or an empty
        ``Cache`` ([b, 0, heads, head_dim], f32) to grow."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(torch.zeros(shape, device=key.device),
                          torch.zeros(shape, device=key.device))


def _ffn_parts(layer, d_model, dim_feedforward, dropout, act_dropout, activation,
               weight_attr, bias_attr, n_norms):
    layer.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr, device="cpu")
    layer.dropout = Dropout(act_dropout)
    layer.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr, device="cpu")
    for i in range(1, n_norms + 1):
        setattr(layer, f"norm{i}", LayerNorm(d_model, device="cpu"))
    for i in range(1, n_norms + 1):
        setattr(layer, f"dropout{i}", Dropout(dropout))
    layer.activation = getattr(A, activation)


class TransformerEncoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr,
                                            device="cpu")
        _ffn_parts(self, d_model, dim_feedforward, dropout, act_dropout, activation,
                   weight_attr, bias_attr, 2)
        place(self, device)

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(Layer):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([encoder_layer] + [copy.deepcopy(encoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers, self.norm = num_layers, norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False,
                 weight_attr=None, bias_attr=None, device=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr,
                                            device="cpu")
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr, bias_attr=bias_attr,
                                             device="cpu")
        _ffn_parts(self, d_model, dim_feedforward, dropout, act_dropout, activation,
                   weight_attr, bias_attr, 3)
        place(self, device)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, inc_cache = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (inc_cache,))


class TransformerDecoder(Layer):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList([decoder_layer] + [copy.deepcopy(decoder_layer)
                                                   for _ in range(num_layers - 1)])
        self.num_layers, self.norm = num_layers, norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None, cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)


class Transformer(Layer):
    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, activation="relu", attn_dropout=None,
                 act_dropout=None, normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr,
                                                device="cpu")
            enc_norm = LayerNorm(d_model, device="cpu") if normalize_before else None
            self.encoder = TransformerEncoder(enc_layer, num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(d_model, nhead, dim_feedforward, dropout,
                                                activation, attn_dropout, act_dropout,
                                                normalize_before, weight_attr, bias_attr,
                                                device="cpu")
            dec_norm = LayerNorm(d_model, device="cpu") if normalize_before else None
            self.decoder = TransformerDecoder(dec_layer, num_decoder_layers, dec_norm)
        self.d_model, self.nhead = d_model, nhead
        place(self, device)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None, memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """[length, length] f32: 0 on and below the diagonal, -1e9 above (an
        additive mask)."""
        keep = torch.ones((length, length), dtype=torch.bool,
                          device=resolve_device(device)).tril()
        return torch.where(keep, 0.0, -1e9).to(torch.float32)
