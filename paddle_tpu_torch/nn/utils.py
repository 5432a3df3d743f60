"""paddle.nn.utils of the port (counterpart of paddle_tpu/nn/utils.py):
weight and spectral normalization, and parameters to and from one vector.

As in the JAX package, the normalized weight is a property of the layer
computed from live parameters at every access (``weight_g`` /
``weight_v``, or ``weight_orig``), so gradients reach them on every path;
the layer's class becomes a per-instance subclass carrying the property,
and ``remove_weight_norm`` restores it.

``dim`` is the JAX layout's axis. A port ``Linear`` stores its weight
``[out, in]``, the transpose of the JAX ``[in, out]``, so for a weight the
port keeps transposed (``Parameter._jax_transposed``, set by
nn/layers/common.py's ``make_param``) axis 0 and 1 swap: ``weight_norm(
linear, dim=0)`` takes one norm a JAX row, i.e. a norm over the port
weight's dim 0 for each of its columns, and ``weight_g`` has the JAX shape
``[in]``. ``spectral_norm``'s default ``dim`` is the JAX one (1 for a
Linear or a transposed convolution, else 0) mapped the same way, so the
matrix it normalizes is the same in both packages. Every other weight
(convolutions, ``[out, in / groups, *k]`` in both) keeps its ``dim``.
"""
from __future__ import annotations

import torch

from ..core import random as random_mod
from .layer import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]

_EPS = 1e-12


def _check_dim(w, dim, what):
    if not (-1 <= dim < w.dim()):
        raise ValueError(f"{what}: dim must be -1 (whole-tensor) or in [0, {w.dim()}) for a "
                         f"{w.dim()}-D weight, got {dim}")


def _port_dim(w, dim):
    """The port's axis of the JAX layout's ``dim`` of weight ``w``."""
    if w.dim() == 2 and getattr(w, "_jax_transposed", False) and dim in (0, 1):
        return 1 - dim
    return dim


def _norm_except_dim(v, dim):
    """L2 norm over every axis but ``dim`` (one norm of everything at -1)."""
    if dim == -1:
        return torch.sqrt((v * v).sum() + _EPS)
    axes = [i for i in range(v.dim()) if i != dim]
    return torch.sqrt((v * v).sum(axes) + _EPS)


def _weight_from_gv(g, v, dim):
    """w = g v / ||v||, g broadcast over every axis but ``dim``."""
    if dim == -1:
        return g * v / torch.sqrt((v * v).sum() + _EPS)
    axes = [i for i in range(v.dim()) if i != dim]
    norm = torch.sqrt((v * v).sum(axes, keepdim=True) + _EPS)
    shape = [1] * v.dim()
    shape[dim] = v.shape[dim]
    return g.reshape(shape) * v / norm


def _install_property(layer, name, fget):
    """The layer onto a subclass of its class carrying ``name`` as a
    property; returns the previous class."""
    prev_cls = layer.__class__
    layer.__class__ = type(prev_cls.__name__, (prev_cls,), {name: property(fget)})
    return prev_cls


def _new_param(data, like):
    """A Parameter of ``data`` with ``like``'s attributes."""
    return like.rewrap(data) if isinstance(like, Parameter) else Parameter(data,
                                                                          like.requires_grad)


def weight_norm(layer, name="weight", dim=0):
    """``layer.<name>`` as magnitude ``<name>_g`` times direction
    ``<name>_v`` / ||``<name>_v``|| (``dim`` in the JAX layout; -1: one
    norm of the whole weight)."""
    w = layer._parameters.get(name)
    if w is None:
        raise ValueError(f"layer has no Parameter {name!r}")
    if f"_{name}_weight_norm" in layer.__dict__:
        raise ValueError(f"weight_norm already applied to {name!r}")
    _check_dim(w, dim, "weight_norm")
    pdim = _port_dim(w, dim)
    with torch.no_grad():
        g = Parameter(_norm_except_dim(w.detach(), pdim).clone())
        v = _new_param(w.detach().clone(), w)
    del layer._parameters[name]
    layer.register_parameter(f"{name}_g", g)
    layer.register_parameter(f"{name}_v", v)

    def fget(self):
        return _weight_from_gv(getattr(self, f"{name}_g"), getattr(self, f"{name}_v"), pdim)

    prev_cls = _install_property(layer, name, fget)
    layer.__dict__[f"_{name}_weight_norm"] = (prev_cls, pdim, w)
    return layer


def remove_weight_norm(layer, name="weight"):
    """The current g v / ||v|| baked back into one ``<name>`` parameter."""
    key = f"_{name}_weight_norm"
    if key not in layer.__dict__:
        raise ValueError(f"weight_norm was not applied to {name!r}")
    prev_cls, pdim, orig = layer.__dict__.pop(key)
    with torch.no_grad():
        w = _weight_from_gv(getattr(layer, f"{name}_g"), getattr(layer, f"{name}_v"), pdim)
    del layer._parameters[f"{name}_g"]
    del layer._parameters[f"{name}_v"]
    layer.__class__ = prev_cls
    layer.register_parameter(name, _new_param(w.detach().clone(), orig))
    return layer


def _default_sn_dim(layer):
    """The JAX default: 1 for layers whose weight holds the output on axis 1
    there (Linear ``[in, out]`` and the transposed convolutions), else 0."""
    cls = type(layer).__name__
    return 1 if ("Linear" in cls or "Transpose" in cls) else 0


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=None):
    """``layer.<name>`` divided by its largest singular value sigma = u^T W v,
    u and v from ``n_power_iterations`` power iterations (on the detached
    weight) from the buffer ``<name>_u``, which keeps each access's u; the
    weight moves to ``<name>_orig`` and the gradient flows through W in
    sigma. The first u is drawn N(0, 1) from the port's default CPU
    generator (the JAX package draws another)."""
    if n_power_iterations < 1:
        raise ValueError("n_power_iterations must be >= 1")
    w = layer._parameters.get(name)
    if w is None:
        raise ValueError(f"layer has no Parameter {name!r}")
    if dim is None:
        dim = _default_sn_dim(layer)
    _check_dim(w, dim, "spectral_norm")
    pdim = _port_dim(w, dim)
    h = w.shape[pdim]
    u0 = torch.empty(h, dtype=torch.float32).normal_(generator=random_mod.generator("cpu"))
    layer.register_buffer(f"{name}_u", (u0 / (torch.linalg.vector_norm(u0) + eps)).to(
        w.device))
    del layer._parameters[name]
    layer.register_parameter(f"{name}_orig", w)
    perm = [pdim] + [i for i in range(w.dim()) if i != pdim]

    def fget(self):
        w_t = getattr(self, f"{name}_orig")
        m_t = w_t.permute(perm).reshape(h, -1)
        u = getattr(self, f"{name}_u")
        with torch.no_grad():
            m = m_t.detach()
            for _ in range(n_power_iterations):
                v = m.T @ u
                v = v / (torch.linalg.vector_norm(v) + eps)
                u = m @ v
                u = u / (torch.linalg.vector_norm(u) + eps)
            getattr(self, f"{name}_u").copy_(u)
        return w_t / (u * (m_t @ v)).sum()

    _install_property(layer, name, fget)
    return layer


def parameters_to_vector(parameters, name=None):
    """Every parameter flattened and concatenated into one 1-D tensor."""
    return torch.cat([p.reshape(-1) for p in parameters])


@torch.no_grad()
def vector_to_parameters(vec, parameters, name=None):
    """``vec`` sliced back into the parameters, in place, in order."""
    parameters = list(parameters)
    total = sum(p.numel() for p in parameters)
    if total != vec.shape[0]:
        raise ValueError(f"vector length {vec.shape[0]} does not match total parameter "
                         f"size {total}")
    off = 0
    for p in parameters:
        p.copy_(vec[off:off + p.numel()].reshape(p.shape))
        off += p.numel()
    return parameters
