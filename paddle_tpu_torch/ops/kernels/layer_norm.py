"""Fused LayerNorm, forward and backward (counterpart of
paddle_tpu/ops/pallas/layer_norm.py).

``layer_norm(x, weight, bias, eps)`` normalises over the last dim with f32
statistics and a two-pass variance, applies the affine in f32 and casts once
to x's dtype; it is differentiable in all three inputs. Like the JAX
package's ``custom_vjp``, a call with no input that needs a gradient (or
under ``no_grad``) runs the inference forward, which writes no statistics;
otherwise the training forward saves mu and rstd and the backward recomputes
xhat from them.

On CUDA tensors the three wrappers launch the kernels of
``csrc/layer_norm.cu`` or raise; on CPU tensors they take the plain
versions, the same arithmetic in plain PyTorch. The backward's dg and db are
f32 sums (the CTAs' and clusters' partials added inside the same launch, in
a fixed order) and come back in the weight's dtype, as in the JAX package.

``launches_fwd``, ``launches_infer`` and ``launches_bwd`` count launches of
the training forward, the inference forward and the backward (one per call).
This is a direct-call library op, as in the JAX package: nothing routes the
model's LayerNorm here (``ops/nn_functional.layer_norm`` is the model's).
"""
from __future__ import annotations

import ctypes
import math

import torch

#: kernel launches since import (chip_smoke.py resets and reads them)
launches_fwd = 0     # training forward (writes mu, rstd)
launches_infer = 0   # inference forward
launches_bwd = 0     # backward (dx, then dg and db)

_LANES = 128
MAX_HIDDEN = 8192    # the CUDA kernels keep a row in the registers of <= 16 warps
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "layer_norm_fwd": [_PTR] * 6 + [_INT] * 3 + [ctypes.c_float, _INT, _PTR],
    "layer_norm_bwd": [_PTR] * 9 + [_INT] * 4 + [_PTR],
    "layer_norm_bwd_clusters": [_INT] * 3,
}
_fns = {}
_tickets = {}        # (device, stream) -> the backward's tickets (8 int32)


def supported(n_rows: int, hidden: int) -> bool:
    """The JAX package's predicate, kept so both packages take the same
    shapes: a lane-aligned hidden size and at least one row."""
    return hidden % _LANES == 0 and n_rows >= 1


# ------------------------------------------------------------ plain versions

def layer_norm_fwd_plain(x2, weight, bias, eps=1e-5):
    """The forward kernels' arithmetic in plain PyTorch. x2: [n, h]; weight,
    bias: [h]. Returns (o [n, h] in x2's dtype, mu [n] f32, rstd [n] f32).
    Unlike ``ops/nn_functional.layer_norm`` (the JAX route's arithmetic,
    which casts xhat before the affine), the affine runs in f32 and the cast
    comes last, as in the Pallas kernel."""
    x = x2.float()
    mu = x.mean(dim=1)
    xc = x - mu[:, None]
    rstd = torch.rsqrt((xc * xc).mean(dim=1) + eps)
    o = xc * rstd[:, None] * weight.float() + bias.float()
    return o.to(x2.dtype), mu, rstd


def layer_norm_bwd_plain(x2, weight, dy, mu, rstd):
    """The backward kernel's arithmetic in plain PyTorch. Returns (dx [n, h]
    in x2's dtype, dg [h] f32, db [h] f32)."""
    x, g, d = x2.float(), weight.float(), dy.float()
    xhat = (x - mu[:, None]) * rstd[:, None]
    wdy = d * g
    c1 = wdy.mean(dim=1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    return dx.to(x2.dtype), (d * xhat).sum(dim=0), d.sum(dim=0)


# ---------------------------------------------------------------- kernels

def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("layer_norm"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _call(name, device, *args):
    with torch.cuda.device(device):
        err = _kernel(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _ticket(device):
    """The backward's tickets on the current stream of ``device``: one int32
    for each column slice of a cluster (8), zero before and after every
    launch (the slice's last CTA resets it), so a stream's calls share them
    and calls on two streams never do."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(8, dtype=torch.int32, device=device)
    return t


def _aligned(t):
    """t contiguous with a 16-byte aligned start (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x2, *vectors):
    if x2.dim() != 2:
        raise ValueError(f"x must be [n, hidden], got {tuple(x2.shape)}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm takes float32 or bfloat16 x, got {x2.dtype}")
    n, h = x2.shape
    if not supported(n, h) or h > MAX_HIDDEN:
        raise ValueError(f"the CUDA kernel takes hidden a multiple of {_LANES} up to "
                         f"{MAX_HIDDEN} and at least one row, got [{n}, {h}]")
    for v in vectors:
        if tuple(v.shape) != (h,) or v.device != x2.device:
            raise ValueError(f"weight and bias must be [{h}] on {x2.device}, got "
                             f"{tuple(v.shape)} on {v.device}")


def _f32(v):
    return _aligned(v.detach().float())


def layer_norm_fwd(x2, weight, bias, eps=1e-5, stats=True):
    """The training forward (``stats=True``: returns (o, mu, rstd)) or the
    inference forward (``stats=False``: returns o). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global launches_fwd, launches_infer
    if not x2.is_cuda:
        out = layer_norm_fwd_plain(x2, weight, bias, eps)
        return out if stats else out[0]
    _check(x2, weight, bias)
    x2 = _aligned(x2)
    n, h = x2.shape
    o = torch.empty_like(x2)
    mu = rstd = None
    if stats:
        mu = torch.empty(n, dtype=torch.float32, device=x2.device)
        rstd = torch.empty_like(mu)
    g, b = _f32(weight), _f32(bias)
    _call("layer_norm_fwd", x2.device, x2.data_ptr(), g.data_ptr(), b.data_ptr(),
          o.data_ptr(), mu.data_ptr() if stats else None,
          rstd.data_ptr() if stats else None, _DTYPE_CODES[x2.dtype], n, h,
          float(eps), int(stats))
    if stats:
        launches_fwd += 1
        return o, mu, rstd
    launches_infer += 1
    return o


def layer_norm_bwd(x2, weight, dy, mu, rstd):
    """(dx, dg, db) with dg, db f32: one launch of the CUDA kernel on CUDA
    tensors (the same bits on every call), the plain version on CPU
    tensors."""
    global launches_bwd
    if not x2.is_cuda:
        return layer_norm_bwd_plain(x2, weight, dy, mu, rstd)
    _check(x2, weight)
    n, h = x2.shape
    if tuple(dy.shape) != (n, h) or dy.dtype != x2.dtype:
        raise ValueError(f"dy must be [{n}, {h}] {x2.dtype}, got {tuple(dy.shape)} "
                         f"{dy.dtype}")
    for name, s in (("mu", mu), ("rstd", rstd)):
        if tuple(s.shape) != (n,) or s.dtype != torch.float32 or s.device != x2.device:
            raise ValueError(f"{name} must be a float32 [{n}] tensor on {x2.device}")
    x2, dy, mu, rstd = _aligned(x2), _aligned(dy), mu.contiguous(), rstd.contiguous()
    g = _f32(weight)
    code = _DTYPE_CODES[x2.dtype]
    with torch.cuda.device(x2.device):
        clusters = _kernel("layer_norm_bwd_clusters")(n, h, code)
    if clusters < 1:
        raise RuntimeError(f"layer_norm_bwd has no launch shape: CUDA error {-clusters}")
    dx = torch.empty_like(x2)
    part = torch.empty((clusters, 2, h), dtype=torch.float32, device=x2.device)
    dgdb = torch.empty((2, h), dtype=torch.float32, device=x2.device)
    _call("layer_norm_bwd", x2.device, x2.data_ptr(), g.data_ptr(), dy.data_ptr(),
          mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(), part.data_ptr(),
          dgdb.data_ptr(), _ticket(x2.device).data_ptr(), code, n, h, clusters)
    launches_bwd += 1
    return dx, dgdb[0], dgdb[1]


# ---------------------------------------------------------------- autograd

class _LayerNorm(torch.autograd.Function):
    """The training forward and the backward (``_ln_fwd`` / ``_ln_bwd`` of
    the JAX package's custom_vjp)."""

    @staticmethod
    def forward(ctx, x2, weight, bias, eps):
        o, mu, rstd = layer_norm_fwd(x2, weight, bias, eps, stats=True)
        ctx.save_for_backward(x2, weight, mu, rstd)
        return o

    @staticmethod
    def backward(ctx, dy):
        x2, weight, mu, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x2, weight, dy.contiguous(), mu, rstd)
        return dx, dg.to(weight.dtype), db.to(weight.dtype), None


def layer_norm(x, weight, bias, eps=1e-5):
    """x: [..., hidden]; weight, bias: [hidden]. Returns x's shape and dtype.
    With no input needing a gradient (or grad mode off) this is the inference
    forward, the JAX primal ``_infer``."""
    shape = x.shape
    h = shape[-1]
    x2 = x.reshape(math.prod(shape[:-1]) if len(shape) > 1 else 1, h)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        out = _LayerNorm.apply(x2, weight, bias, float(eps))
    else:
        out = layer_norm_fwd(x2, weight, bias, float(eps), stats=False)
    return out.reshape(shape)
