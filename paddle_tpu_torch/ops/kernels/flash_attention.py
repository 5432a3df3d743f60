"""Flash attention, forward and FA2 backward (counterpart of
paddle_tpu/ops/pallas/flash_attention.py).

``flash_attention`` / ``flash_attention_with_lse`` take paddle's
``[b, s, h, d]`` layout, as the JAX entry points do, and are differentiable
in q, k, v (and, for the second, through both outputs: the lse cotangent
folds into ``delta``, as ring attention needs). On CUDA tensors the forward
launches a kernel of ``csrc/flash_attention_fwd.cu`` and the backward two
kernels of ``csrc/flash_attention_bwd.cu`` (dK/dV, then dQ), or they
raise; on CPU tensors they take the plain versions, the same arithmetic in
plain PyTorch. ``delta = rowsum(dO * O) - g_lse`` is plain PyTorch on both
devices, as the JAX package computes it outside its kernels.

Kernels are picked by dtype (``forward_route``, ``backward_route``): bf16
takes the bf16 tensor-core kernels (``"mma"``), f32 the TF32 tensor-core
kernels in 3xTF32 (``"tf32x3"``: each product as three TF32 ones, at f32
accuracy), forward and backward. The FMA kernels on the FP32 units
(``"fma"``) are their predecessors, which no route takes. The tensor-core
kernels copy 16-byte pieces, so a view whose start or strides are not
16-byte aligned is handed over as an aligned contiguous copy
(``_mma_operand``; the fused qkv projection's views are aligned and are
read in place).

``launches`` counts the forward's kernel launches (any kernel) and
``launches_by_route`` the same by kernel; ``launches_bwd_by_route[route]``
counts the backward's, ``"dkdv"`` and ``"dq"`` apart (``launches_bwd``
sums a function's over the routes). Blocks are fixed by the kernels
(64 x 64 tiles); the TPU package's block autotune has no counterpart.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._common import NEG_INF, pick_block

#: kernel launches since import (chip_smoke.py resets and reads them)
launches = 0        # forward, any kernel
launches_by_route = {"mma": 0, "tf32x3": 0, "fma": 0}   # forward, by kernel
launches_bwd_by_route = {r: {"dkdv": 0, "dq": 0}        # backward, by kernel
                         for r in ("mma", "tf32x3", "fma")}

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns = {}

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_STRIDES = ctypes.POINTER(_LL)
_SIGNATURES = {
    # entry point: (library, argtypes)
    "flash_attention_fwd": ("flash_attention_fwd",
                            [_PTR] * 5 + [_INT] * 6 + [_LL] * 12
                            + [ctypes.c_float, _INT, _PTR]),
    # the tensor-core forwards (bf16, 3xTF32) take no dtype argument
    **{f"flash_attention_fwd_{r}": ("flash_attention_fwd",
                                    [_PTR] * 5 + [_INT] * 5 + [_LL] * 12
                                    + [ctypes.c_float, _INT, _PTR]) for r in ("mma", "tf32")},
    "flash_attention_bwd_dkdv": ("flash_attention_bwd",
                                 [_PTR] * 8 + [_INT] * 6
                                 + [_STRIDES, ctypes.c_float, _INT, _PTR]),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               [_PTR] * 7 + [_INT] * 6
                               + [_STRIDES, ctypes.c_float, _INT, _PTR]),
}
# the tensor-core pairs (bf16, 3xTF32) take no dtype argument
_SIGNATURES.update({
    f"flash_attention_bwd_{k}_{r}": ("flash_attention_bwd",
                                     [_PTR] * n + [_INT] * 5
                                     + [_STRIDES, ctypes.c_float, _INT, _PTR])
    for k, n in (("dkdv", 8), ("dq", 7)) for r in ("mma", "tf32")})


def supported(seq_q: int, seq_k: int, head_dim: int) -> bool:
    """The routing predicate of the JAX package, kept so both packages send
    the same shapes to the kernel: at least 8 rows, 8-aligned tiles and
    head_dim. The CUDA kernels themselves mask ragged lengths; they take the
    head dims in ``HEAD_DIMS``."""
    return (
        seq_q >= 8
        and seq_k >= 8
        and pick_block(seq_q) % 8 == 0
        and pick_block(seq_k) % 8 == 0
        and head_dim % 8 == 0
    )


#: the route of each dtype, forward and backward, and the dtype each
#: tensor-core route takes
_ROUTES = {torch.bfloat16: "mma", torch.float32: "tf32x3"}
_ROUTE_DTYPE = {r: dt for dt, r in _ROUTES.items()}


def forward_route(dtype, head_dim: int) -> str:
    """The forward kernel for q, k, v of ``dtype`` and ``head_dim``:
    ``"mma"`` (the bf16 tensor-core kernel) for bfloat16, ``"tf32x3"`` (the
    TF32 tensor-core kernel in 3xTF32, f32 accuracy) for float32, at every
    head dim in ``HEAD_DIMS``. Picked by dtype alone, never by failure;
    other head dims raise ValueError, other dtypes TypeError. (The FMA
    kernel, ``"fma"``, is the predecessor both are timed against.)"""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got {head_dim}")
    if dtype not in _ROUTES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")
    return _ROUTES[dtype]


def backward_route(dtype, head_dim: int) -> str:
    """The backward pair's kernels (dK/dV and dQ) for q, k, v and dO of
    ``dtype`` and ``head_dim``: ``"mma"`` (the bf16 tensor-core kernels) for
    bfloat16, ``"tf32x3"`` (the TF32 tensor-core kernels in 3xTF32, f32
    accuracy) for float32, at every head dim in ``HEAD_DIMS``: the
    forward's table. Picked by dtype alone, never by failure; other head
    dims raise ValueError, other dtypes TypeError. (The FMA pair, ``"fma"``,
    is the predecessor both pairs are timed against.)"""
    return forward_route(dtype, head_dim)


def launches_bwd(kernel: str) -> int:
    """Launches of the backward's ``kernel`` ("dkdv" or "dq") on either route."""
    return sum(counts[kernel] for counts in launches_bwd_by_route.values())


# ------------------------------------------------------------ plain versions

def _bhsd(x):
    """[b, s, h, d] -> [b, h, s, d] in f32 (a bf16 value is exact in f32, so
    f32 products of widened bf16 inputs are the reference's storage-dtype
    products with f32 accumulation)."""
    return x.transpose(1, 2).float()


def _scores(q, k, causal, sm_scale):
    s = torch.matmul(_bhsd(q), _bhsd(k).transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal: bool = False,
                          sm_scale: float | None = None):
    """The forward kernel's arithmetic in plain PyTorch, on any device.
    q, k, v: [b, s, h, d]. Returns (o [b, sq, h, d] in q's dtype,
    lse [b, h, sq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = l.masked_fill(l == 0, 1.0)  # a fully masked row gives 0, not NaN
    o = torch.matmul(p.to(v.dtype).float(), _bhsd(v)) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype).transpose(1, 2).contiguous(), lse


def flash_attention_bwd_plain(q, k, v, do, lse, delta, causal: bool = False,
                              sm_scale: float | None = None):
    """The two backward kernels' arithmetic in plain PyTorch, on any device.
    q, do: [b, sq, h, d]; k, v: [b, sk, h, d]; lse, delta: [b, h, sq] f32.
    Returns (dq, dk, dv) in [b, s, h, d] and the dtypes of q, k, v.

    P = exp(S - lse) from the forward's lse; P is rounded to dO's dtype
    before Pᵀ·dO, dS = P∘(dP − delta)·scale to q's dtype before dSᵀ·Q and to
    k's before dS·K (TPU kernels, flash_attention.py:161-176, 205-217)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])
    dof = _bhsd(do)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, _bhsd(v).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), _bhsd(q))
    dq = torch.matmul(ds.to(k.dtype).float(), _bhsd(k))
    return tuple(g.to(x.dtype).transpose(1, 2).contiguous()
                 for g, x in ((dq, q), (dk, k), (dv, v)))


def attention_delta(o, do, g_lse=None):
    """delta = rowsum(dO * O) [b, h, sq] f32, minus the lse cotangent when
    there is one (dS = P(dP - delta) + P g_lse = P(dP - (delta - g_lse)))."""
    delta = (do.float() * o.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


# ---------------------------------------------------------------- kernels

def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        lib, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(lib), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be [b, s, h, d], got {tuple(q.shape)}")
    b, _, h, d = q.shape
    sk = k.shape[1]
    if tuple(k.shape) != (b, sk, h, d) or tuple(v.shape) != (b, sk, h, d):
        raise ValueError(f"k and v must be [{b}, sk, {h}, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, got {d}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _strides(*xs):
    return [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]


def _call(name, device, *args):
    fn = _kernel(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _mma_operand(x):
    """x as the tensor-core kernels read it: x itself where its start and its
    batch, seq and head strides are 16-byte aligned (strides a multiple of 8
    bf16 or 4 f32 elements; the fused qkv projection's views are), else an
    aligned contiguous copy."""
    vec = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and all(s % vec == 0 for s in x.stride()[:3]):
        return x
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _forced(route, dtype):
    """A route forced by its caller (chip_smoke.py and the card tests, on the
    forward or the backward): "fma" at either dtype, "mma" only at bf16 and
    "tf32x3" only at f32 (each tensor-core kernel takes nothing else)."""
    routes = ("mma", "tf32x3", "fma")
    if route not in routes:
        raise ValueError(f"route must be one of {routes}, got {route!r}")
    if route in _ROUTE_DTYPE and dtype != _ROUTE_DTYPE[route]:
        raise ValueError(f"the {route!r} kernels take {_ROUTE_DTYPE[route]} inputs, "
                         f"got {dtype}")
    return route


def _launch(q, k, v, causal, sm_scale, route=None):
    """(o, lse) from the forward kernel of ``forward_route`` on CUDA tensors.
    ``route`` forces a kernel: chip_smoke.py and the card tests time and
    check the FMA kernel, the tensor-core kernels' predecessor, with "fma";
    no path passes it."""
    global launches
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    route = forward_route(q.dtype, d) if route is None else _forced(route, q.dtype)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if route != "fma":
        q, k, v = (_mma_operand(x) for x in (q, k, v))
        _call("flash_attention_fwd_tf32" if route == "tf32x3" else "flash_attention_fwd_mma",
              q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), d, b, h, sq, sk, *_strides(q, k, v, o), float(sm_scale),
              int(bool(causal)))
    else:
        _call("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(),
              v.data_ptr(), o.data_ptr(), lse.data_ptr(), _DTYPE_CODES[q.dtype],
              d, b, h, sq, sk, *_strides(q, k, v, o), float(sm_scale),
              int(bool(causal)))
    launches += 1
    launches_by_route[route] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    _check(q, k, v)
    b, sq, h, _ = q.shape
    if (tuple(do.shape) != tuple(q.shape) or do.dtype != q.dtype
            or do.stride(-1) != 1):
        raise ValueError(f"dO must be {tuple(q.shape)} {q.dtype}, contiguous "
                         f"in its last dim, got {tuple(do.shape)} {do.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if (tuple(x.shape) != (b, h, sq) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous float32 [{b}, {h}, "
                             f"{sq}] tensor on {q.device}")


def _launch_bwd(kernel, q, k, v, do, lse, delta, outs, causal, sm_scale, route):
    """One backward kernel ("dkdv" or "dq") of ``backward_route`` on CUDA
    tensors, writing ``outs``. ``route`` forces a kernel: chip_smoke.py and
    the card tests check and time the FMA kernels, the tensor-core pairs'
    predecessors, with "fma"; no path passes it."""
    _check_bwd(q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    route = backward_route(q.dtype, d) if route is None else _forced(route, q.dtype)
    name = f"flash_attention_bwd_{kernel}"
    dtype_arg = ()
    if route != "fma":
        q, k, v, do = (_mma_operand(x) for x in (q, k, v, do))
        name += "_tf32" if route == "tf32x3" else "_mma"
    else:
        dtype_arg = (_DTYPE_CODES[q.dtype],)
    strides = (_LL * 18)(*_strides(q, k, v, do, *outs))
    _call(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          *(x.data_ptr() for x in outs), *dtype_arg, d, b, h, sq,
          k.shape[1], strides, float(sm_scale), int(bool(causal)))
    launches_bwd_by_route[route][kernel] += 1


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal: bool = False,
                             sm_scale: float | None = None, route=None):
    """(dk, dv) of the FA2 backward: the CUDA kernel of ``backward_route`` on
    CUDA tensors (dO is copied to contiguous first if its last dim is
    strided), the plain version on CPU tensors. Shapes as
    ``flash_attention_bwd_plain``. ``route`` is private (``_launch_bwd``)."""
    sm_scale = _scale(q, sm_scale)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale)[1:]
    do = do if do.stride(-1) == 1 else do.contiguous()
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dkdv", q, k, v, do, lse, delta, (dk, dv), causal, sm_scale, route)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                           sm_scale: float | None = None, route=None):
    """dq of the FA2 backward: the CUDA kernel of ``backward_route`` on CUDA
    tensors, the plain version on CPU tensors. ``route`` is private."""
    sm_scale = _scale(q, sm_scale)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, do, lse, delta, causal, sm_scale)[0]
    do = do if do.stride(-1) == 1 else do.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), causal, sm_scale, route)
    return dq


# ---------------------------------------------------------------- autograd

class _FlashAttention(torch.autograd.Function):
    """(o, lse) = attention(q, k, v), differentiable in q, k, v through both
    outputs (the custom_vjp pair _flash_bhsd / _flash_bhsd_lse of the JAX
    package: an unused lse has no cotangent)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.is_cuda:
            o, lse = _launch(q, k, v, causal, sm_scale)
        else:
            o, lse = flash_attention_plain(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        delta = attention_delta(o, g_o, g_lse)
        args = (q, k, v, g_o, lse, delta, ctx.causal, ctx.sm_scale)
        if not q.is_cuda:
            return (*flash_attention_bwd_plain(*args), None, None)
        dq = dk = dv = None
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        if need_k or need_v:
            dk, dv = flash_attention_bwd_dkdv(*args)
        if need_q:
            dq = flash_attention_bwd_dq(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, causal: bool = False,
                             sm_scale: float | None = None):
    """q, k, v: [b, s, h, d]. Returns (out [b, sq, h, d], lse [b, h, sq] f32),
    both differentiable. The causal mask is top-left aligned (query i sees
    keys 0..i)."""
    return _FlashAttention.apply(q, k, v, bool(causal), float(_scale(q, sm_scale)))


def flash_attention(q, k, v, causal: bool = False,
                    sm_scale: float | None = None):
    """q, k, v: [b, s, h, d] (paddle layout). Returns [b, sq, h, d]."""
    return flash_attention_with_lse(q, k, v, causal, sm_scale)[0]
