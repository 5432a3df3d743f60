"""Common layers (counterpart of paddle_tpu/nn/layers/common.py): ``Linear``,
``Embedding``, ``Bilinear``, the dropouts, ``Flatten``, ``Identity``, the
pads, the upsampling layers, ``Fold`` / ``Unfold``, ``PixelShuffle``,
``CosineSimilarity``, ``PairwiseDistance`` and ``SpectralNorm``.

Layouts are PyTorch's: ``Linear`` stores ``[out, in]`` (the JAX package
stores ``[in, out]``; models/convert.py transposes). ``Bilinear``'s weight
is ``[out, in1, in2]`` in both packages. Default weights are the JAX
layers' distributions (Xavier normal for Linear and Embedding, zero
biases), drawn on the CPU from ``reset_parameters``' generator (torch's
global one when None) and copied into the parameter.

Parameter attributes (``weight_attr`` / ``bias_attr``: a ``ParamAttr``, a
bare initializer, a name, or False for no parameter) hold as in the JAX
layers: ``make_param`` gives a ``Parameter`` with the attr's name,
``trainable`` and optimizer attributes, and keeps the attr's initializer
(for a bias without one, ``set_global_initializer``'s bias initializer),
which ``reset_parameters`` then draws in place of the default. The
initializer is called with the JAX layout's shape and its result turned
into the port's (a Linear weight is transposed), so fans, ``Assign`` and
``Orthogonal`` give the JAX layer's weight.

Placement: a layer built alone goes to ``resolve_device(device)`` (the
card unless ``device="cpu"`` is asked for); built inside a model's
``with torch.device("meta")`` block it stays there, and the model moves it
after drawing its weights (vision/models/resnet.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...device import resolve_device
from ...ops import nn_functional as F
from .. import initializer as I
from ..layer import Layer, ParamAttr, Parameter, parameter_of


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
def _attr_init_(p):
    """Draws ``p``'s attr initializer into it (the JAX layout's shape, turned
    into the port's); False when it has none."""
    init = getattr(p, "_initializer", None)
    if init is None:
        return False
    t = p.dim() == 2 and getattr(p, "_jax_transposed", False)
    v = init(tuple(p.shape)[::-1] if t else tuple(p.shape), p.dtype)
    p.copy_(v.T if t else v)
    return True


@torch.no_grad()
def init_normal_(p, std, generator=None):
    """``p`` drawn from N(0, std) on the CPU (``generator``, or torch's global
    one) and copied in, or from its attr's initializer; a meta tensor is
    left alone."""
    if p is None or p.is_meta or _attr_init_(p):
        return
    p.copy_(torch.empty(p.shape, dtype=torch.float32).normal_(0.0, std, generator=generator))


@torch.no_grad()
def init_uniform_(p, low, high, generator=None):
    if p is None or p.is_meta or _attr_init_(p):
        return
    p.copy_(torch.empty(p.shape, dtype=torch.float32).uniform_(low, high,
                                                                generator=generator))


@torch.no_grad()
def init_const_(p, value):
    if p is not None and not p.is_meta and not _attr_init_(p):
        p.fill_(value)


def make_param(shape, attr=None, is_bias=False, transposed=False):
    """A ``Parameter`` of ``shape`` (uninitialized; ``reset_parameters``
    draws it), or None when ``attr`` is False (Paddle's ``bias_attr=False``).
    ``transposed``: the JAX layer's parameter is this one's transpose (a
    Linear weight)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    p = parameter_of(torch.empty(shape), attr)
    p._initializer = attr.initializer or (I._global_default(True) if is_bias else None)
    p._jax_transposed = transposed
    return p


class Linear(Layer):
    """``y = x Wᵀ + b``, W ``[out, in]``, through ``F.linear`` (the amp
    lookup of the JAX op ``"linear"``)."""

    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = make_param((out_features, in_features), weight_attr, transposed=True)
        self.bias = make_param((out_features,), bias_attr, is_bias=True)
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


class Embedding(Layer):
    """Row lookup; rows of ``padding_idx`` come out as zeros (and that row
    of the weight starts at zero)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None, sparse=False,
                 weight_attr=None, name=None, device=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.padding_idx = padding_idx
        self.weight = make_param((num_embeddings, embedding_dim), weight_attr)
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


class Dropout(Layer):
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


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return F.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


@torch.no_grad()
def materialize(model, device, seed=0):
    """A model built on meta made real: storage on the CPU, every layer's
    ``reset_parameters`` (its parameters and buffers) drawn in module order
    from one generator seeded with ``seed``, then moved to ``device``."""
    attrs = [(m, n, p) for m in model.modules() for n, p in m._parameters.items()
             if isinstance(p, Parameter)]
    model.to_empty(device="cpu")
    for m, n, p in attrs:   # to_empty makes plain parameters: keep the attributes
        if not isinstance(m._parameters[n], Parameter):
            m._parameters[n] = p.rewrap(m._parameters[n].data)
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if m is not model and hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return model.to(device)


class Bilinear(Layer):
    """``out[n, o] = x1[n] W[o] x2[n] + b[o]``: weight ``[out, in1, in2]``
    (the JAX layer's layout too) drawn from U(-1/sqrt(in1), 1/sqrt(in1)),
    bias ``[1, out]``."""

    def __init__(self, in1_features, in2_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, device=None):
        super().__init__()
        self.in1_features, self.in2_features = in1_features, in2_features
        self.out_features = out_features
        self.weight = make_param((out_features, in1_features, in2_features), weight_attr)
        self.bias = make_param((1, out_features), bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.in1_features)
        init_uniform_(self.weight, -bound, bound, generator)
        init_const_(self.bias, 0.0)

    def forward(self, x1, x2):
        from ...ops import linalg as L

        out = L.einsum("bi,oij,bj->bo", x1, self.weight, x2)
        return out if self.bias is None else out + self.bias


class _DropoutNd(Layer):
    """A dropout layer whose mask comes from ``generator`` (an attribute,
    torch's default generator when None)."""
    _op = None

    def __init__(self, p=0.5, data_format=None, name=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self.generator = None

    def forward(self, x):
        kw = {} if self.data_format is None else {"data_format": self.data_format}
        return type(self)._op(x, self.p, training=self.training, generator=self.generator,
                              **kw)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(_DropoutNd):
    _op = staticmethod(F.dropout2d)

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__(p, data_format)


class Dropout3D(_DropoutNd):
    _op = staticmethod(F.dropout3d)

    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__(p, data_format)


class AlphaDropout(_DropoutNd):
    _op = staticmethod(F.alpha_dropout)

    def __init__(self, p=0.5, name=None):
        super().__init__(p)


class Upsample(Layer):
    """``F.interpolate`` with the arguments it was built with
    (``align_corners`` and ``align_mode`` are dropped there, as in the JAX
    package)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest", align_corners=False,
                 align_mode=0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode, self.align_corners,
                             self.align_mode, self.data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW", name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        from ...ops import manipulation as P

        return P.pad(x, self.padding, self.mode, self.value, self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    pass


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PixelShuffle(Layer):
    """NCHW only: ``data_format`` is not read, as in the JAX layer."""

    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (output_sizes, kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, *self.args)


class PairwiseDistance(Layer):
    """``||x - y + epsilon||_p`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        from ...ops import linalg as L

        return L.norm(x - y + self.epsilon, p=self.p, axis=-1, keepdim=self.keepdim)


class SpectralNorm(Layer):
    """A given weight divided by its largest singular value, estimated by
    ``power_iters`` power iterations from the vectors ``weight_u`` and
    ``weight_v`` (parameters without gradient, drawn N(0, 1), updated in
    place at every call); the gradient flows through the weight in
    sigma = u^T W v."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12, name=None,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype)
        self.dim, self.power_iters, self.eps = dim, power_iters, eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        self.weight_u = make_param((h,), ParamAttr(trainable=False))
        self.weight_v = make_param((w,), ParamAttr(trainable=False))
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_normal_(self.weight_u, 1.0, generator)
        init_normal_(self.weight_v, 1.0, generator)

    def forward(self, x):
        perm = [self.dim] + [d for d in range(x.dim()) if d != self.dim]
        mat = x.permute(perm).reshape(x.shape[self.dim], -1)
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            for _ in range(self.power_iters):
                v = mat.T @ u
                v = v / (torch.linalg.vector_norm(v) + self.eps)
                u = mat @ v
                u = u / (torch.linalg.vector_norm(u) + self.eps)
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        sigma = u @ mat @ v
        return x / sigma
