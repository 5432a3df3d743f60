"""Common layers (counterpart of paddle_tpu/nn/layers/common.py): ``Linear``,
``Embedding``, ``Dropout``, ``Flatten``, ``Identity``.

Layouts are PyTorch's: ``Linear`` stores ``[out, in]`` (the JAX package
stores ``[in, out]``; models/convert.py transposes). Default weights are the
JAX layers' distributions (Xavier normal for Linear and Embedding, zero
biases), drawn on the CPU from ``reset_parameters``' generator (torch's
global one when None) and copied into the parameter.

Placement: a layer built alone goes to ``resolve_device(device)`` (the
card unless ``device="cpu"`` is asked for); built inside a model's
``with torch.device("meta")`` block it stays there, and the model moves it
after drawing its weights (vision/models/resnet.py).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...device import resolve_device
from ...ops import nn_functional as F


def building_on_meta() -> bool:
    """True inside a ``with torch.device("meta")`` block (a model's build)."""
    return torch.get_default_device().type == "meta"


def place(layer, device):
    """``layer`` on ``resolve_device(device)``, or left where it is while a
    model builds it on meta."""
    if building_on_meta():
        return layer
    return layer.to(resolve_device(device))


@torch.no_grad()
def init_normal_(p, std, generator=None):
    """``p`` drawn from N(0, std) on the CPU (``generator``, or torch's global
    one) and copied in; a meta tensor is left alone."""
    if p is None or p.is_meta:
        return
    p.copy_(torch.empty(p.shape, dtype=torch.float32).normal_(0.0, std, generator=generator))


@torch.no_grad()
def init_const_(p, value):
    if p is not None and not p.is_meta:
        p.fill_(value)


def make_param(shape, attr=None):
    """A parameter of ``shape`` (uninitialized), or None when ``attr`` is
    False (Paddle's ``bias_attr=False``)."""
    if attr is False:
        return None
    return nn.Parameter(torch.empty(shape))


class Linear(nn.Module):
    """``y = x Wᵀ + b``, W ``[out, in]``, through ``F.linear`` (the amp
    lookup of the JAX op ``"linear"``)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = make_param((out_features,), bias_attr)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_normal_(self.weight, math.sqrt(2.0 / (self.in_features + self.out_features)),
                     generator)
        init_const_(self.bias, 0.0)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, out_features={self.out_features}"


class Embedding(nn.Module):
    """Row lookup; rows of ``padding_idx`` come out as zeros (and that row
    of the weight starts at zero)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        self.reset_parameters()
        place(self, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        init_normal_(self.weight, math.sqrt(2.0 / (self.num_embeddings + self.embedding_dim)),
                     generator)
        if self.padding_idx is not None and not self.weight.is_meta:
            self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Dropout(nn.Module):
    """Paddle's dropout (``F.dropout``); the mask comes from ``generator``
    (an attribute, torch's default generator when None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = None

    def forward(self, x):
        return F.dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode,
                         generator=self.generator)

    def extra_repr(self):
        return f"p={self.p}"


class Flatten(nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


@torch.no_grad()
def materialize(model, device, seed=0):
    """A model built on meta made real: storage on the CPU, every layer's
    ``reset_parameters`` (its parameters and buffers) drawn in module order
    from one generator seeded with ``seed``, then moved to ``device``."""
    model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return model.to(device)
