"""Fused LM head + softmax cross entropy, online over vocab tiles
(counterpart of paddle_tpu/ops/pallas/lm_loss.py).

``lm_head_cross_entropy(h2, w, labels)`` gives the per-row f32 loss
``logsumexp(h2 @ wᵀ) - (h2 @ wᵀ)[label]`` without writing the [N, V] logits
to device memory, and is differentiable in ``h2`` and ``w``: the forward
saves the per-row logsumexp, the backward recomputes the logits tile by tile
(dh with the row tile as the outer loop, dW with the vocab tile). W is taken
in h2's dtype (rounded on load); dh comes back in h2's dtype, dW in W's own
(an f32 master W under bf16 activations gets an f32 gradient).

Labels are used as given: like the JAX kernel there is no ``ignore_index``
(callers mask first), and a label outside [0, V) picks nothing, so its row's
loss is the logsumexp and its gradient ``softmax * g``. The vocab needs no
padding: the kernels mask the ragged edge by index (the JAX wrapper pads W
to a multiple of 512 and masks the pad; the results are the same).

On CUDA tensors the three wrappers launch the kernels of ``csrc/lm_loss.cu``
or raise; on CPU tensors they take the plain versions (dense logits, the
same rounding points). The routes are picked by h2's dtype and hidden
size, never by failure (``forward_route``, ``backward_plan``):
- bf16 h2: the bf16 tensor-core kernels (``"mma"``), forward at every
  hidden; backward with one CTA an own tile while its tiles fit (H <=
  1536), past that with the hidden dim split across a thread-block
  cluster of 2 to 8 CTAs (up to H = 6144);
- f32 h2: the TF32 tensor-core kernels with error compensation
  (``"tf32x3"``: each operand split into two TF32 parts and three
  products summed, which holds f32 accuracy), forward at every hidden;
  backward with one CTA an own tile while its f32 tiles fit (H <= 768),
  past that in a cluster (up to H = 6144);
- past the cluster limit (H > 6144) the FMA backward on the FP32 units
  (``"fma"``, W rounded on load), the tensor-core backwards'
  predecessor. The FMA forward is the predecessor of both tensor-core
  forwards; no route takes it.
The tensor-core kernels read W in their operand dtype: a W of the other
dtype is cast once in the forward's call and once per backward, the copy
shared by dh and dW, as the JAX ``_fwd`` and ``_bwd`` do (to f32 the cast
is exact); the forward's copy is not kept for the backward.
``launches_fwd``, ``launches_dh`` and ``launches_dw`` count every launch
(the forward's call also runs the kernel that merges its vocab splits);
``launches_by_route`` counts them by route. A direct-call library op, as
in the JAX package: ``ops/fused.fused_linear_cross_entropy`` (the model's
loss) does not route here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

#: kernel launches since import (chip_smoke.py resets and reads them)
launches_fwd = 0   # forward (loss and lse)
launches_dh = 0    # backward, dh (either route)
launches_dw = 0    # backward, dW (either route)
launches_by_route = {r: {"fwd": 0, "dh": 0, "dw": 0} for r in ("mma", "tf32x3", "fma")}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"full": 0, "bare": 1, "picked": 2}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "lm_loss_fwd": [_PTR] * 6 + [_INT] * 7 + [_PTR],
    "lm_loss_fwd_mma": [_PTR] * 6 + [_INT] * 6 + [_PTR],
    "lm_loss_fwd_tf32": [_PTR] * 6 + [_INT] * 5 + [_PTR],
    "lm_loss_fwd_mma_splits": [_INT, _INT],
    "lm_loss_bwd": [_PTR] * 6 + [_INT] * 6 + [_PTR],
    "lm_loss_bwd_mma": [_PTR] * 6 + [_INT] * 10 + [_PTR],
    "lm_loss_fwd_splits": [_INT, _INT],
}
_fns = {}


def _pick_rows(n: int) -> int:
    """1024 when n is a positive multiple of 1024, else 0: the JAX kernel's
    1D row blocks (a TPU layout rule), kept so both packages take the same
    row counts."""
    return 1024 if n % 1024 == 0 and n >= 1024 else 0


def _check_block_n(v) -> int:
    """``block_n`` as the JAX package validates it: 256, 512 or 1024, else
    ValueError."""
    v = int(v)
    if v not in (256, 512, 1024):
        raise ValueError(
            f"block_n must be 256, 512 or 1024 (the 1D operands tile at "
            f"1024 and the compute block must divide it); got {v}")
    return v


def supported(n_rows: int, vocab: int, hidden: int) -> bool:
    """The JAX package's predicate: rows a multiple of 1024, vocab >= 128,
    hidden a multiple of 128."""
    return _pick_rows(n_rows) > 0 and vocab >= 128 and hidden % 128 == 0


# ------------------------------------------------------------------- routes

#: the dtype each tensor-core route reads h2 and W in (and h2 must have)
_OPERAND = {"mma": torch.bfloat16, "tf32x3": torch.float32}


def forward_route(h_dtype) -> str:
    """The forward's kernel for h2 of ``h_dtype``, at any hidden a multiple
    of 128: ``"mma"`` (the bf16 tensor-core kernel) for bfloat16,
    ``"tf32x3"`` (the TF32 tensor-core kernel in 3xTF32, f32 accuracy) for
    float32."""
    for route, dtype in _OPERAND.items():
        if h_dtype == dtype:
            return route
    raise TypeError(f"lm_head_cross_entropy takes float32 or bfloat16 h2, got {h_dtype}")


#: shared memory a CTA may take on the H100 (227 KB)
_MAX_SMEM = 232448


class BackwardPlan(NamedTuple):
    """What the backward's launch takes: the ``route`` ("mma", "tf32x3" or
    "fma") and, for the tensor-core routes, the arguments of
    ``lm_loss_bwd_mma``: the hidden columns a CTA accumulates (``chunk``),
    the accumulator instance ``hc`` (in 128-column units, >= chunk / 128),
    the other-operand buffers ``stages`` and ``cluster``. With ``cluster``
    1 every CTA holds a [32, H] own tile, and the grid's y walks ceil(H /
    chunk) chunks, each recomputing the logits over the full H; with 2 to 8
    the CTAs of a thread-block cluster share one own tile, rank r holding
    its hidden slice [r * chunk, + chunk), and sum their partial logits
    through distributed shared memory. The FMA kernel picks its own chunks
    (``pick_hc`` in csrc/lm_loss.cu), so all are 0 there."""
    route: str
    chunk: int = 0
    hc: int = 0
    stages: int = 0
    cluster: int = 0


#: CTAs a thread-block cluster may portably hold, and the hidden size they
#: cover in slices of at most 768 columns
_MAX_CLUSTER = 8
_MAX_HIDDEN = _MAX_CLUSTER * 768


def _mma_smem(width: int, stages: int, cluster: int = 1) -> int:
    """The bf16 tensor-core kernel's shared memory: the resident [32,
    width] own tile (width: H, or a cluster's hidden slice), ``stages`` [32,
    width] other tiles (rows padded by 8 bf16), the [32, 40] bf16 dl tile,
    four [32, 40] f32 partials of S and, in a cluster, two [32, 32] f32
    slots of the CTA's partial S."""
    return (((1 + stages) * 32 * (width + 8) + 32 * 40) * 2 + 4 * 32 * 40 * 4
            + (2 * 32 * 32 * 4 if cluster > 1 else 0))


def _tf32_smem(width: int, cluster: int = 1, stages: int = 2) -> int:
    """The 3xTF32 kernel's shared memory: the resident [32, width] f32 own
    tile and ``stages`` [16, width] other tiles (rows padded by 4 f32), eight
    [32, 24] f32 partials of S, the [32, 20] f32 dl tile and, in a cluster,
    two [32, 16] f32 slots of the CTA's partial S."""
    return ((32 + stages * 16) * (width + 4) + 8 * 32 * 24 + 32 * 20
            + (2 * 32 * 16 if cluster > 1 else 0)) * 4


def _plan_smem(plan: BackwardPlan, hidden: int) -> int:
    """Shared memory a CTA of a tensor-core ``plan`` takes at ``hidden``."""
    width = hidden if plan.cluster == 1 else plan.chunk
    if plan.route == "tf32x3":
        return _tf32_smem(width, plan.cluster, plan.stages)
    return _mma_smem(width, plan.stages, plan.cluster)


def _plan(route: str, h_dtype, hidden: int) -> BackwardPlan:
    """The plan of ``route`` for h2 of ``h_dtype`` and ``hidden`` columns;
    ValueError where the route cannot take them. Where the [32, H] own tile
    fits, the hidden dim goes in ceil(units / 6) chunks over gridDim.y of
    chunk = ceil(units / chunks) x 128 columns (units = H / 128): at most
    768, the register accumulator's width. Past that a cluster of CTAs
    shares the own tile, one slice of chunk columns each (the last may be
    narrower), pipelined over three other buffers where they fit: bf16
    slices of at most 768 columns; f32 slices of at most 512 while 8 CTAs
    cover H (H <= 4096), else of at most 768 in order over two buffers. At
    most 8 CTAs (H <= 6144)."""
    if route == "fma":
        return BackwardPlan("fma")
    if route not in _OPERAND:
        raise ValueError(f"route must be 'mma', 'tf32x3' or 'fma', got {route!r}")
    if h_dtype != _OPERAND[route]:
        raise ValueError(f"the {route!r} backward takes {_OPERAND[route]} h2, got {h_dtype}")
    units = hidden // 128
    chunks = -(-units // 6)
    need = -(-units // chunks)
    hc = 2 if need <= 2 else 4 if need <= 4 else 6
    if _fits(route, hidden):
        if route == "tf32x3":
            stages = 2
        else:
            stages = 2 if _mma_smem(hidden, 2) <= _MAX_SMEM else 1
        return BackwardPlan(route, need * 128, hc, stages, 1)
    if hidden > _MAX_HIDDEN:
        raise ValueError(f"the {route!r} backward takes hidden up to {_MAX_HIDDEN} "
                         f"(clusters of at most {_MAX_CLUSTER} CTAs of 768 columns), "
                         f"got {hidden}")
    pipelined = route == "mma" or units <= 4 * _MAX_CLUSTER
    cluster = -(-units // 4) if route == "tf32x3" and pipelined else chunks
    need = -(-units // cluster)
    return BackwardPlan(route, need * 128, 4 if need <= 4 else 6, 3 if pipelined else 2,
                        cluster)


def _fits(route: str, hidden: int) -> bool:
    """Whether one CTA holds the [32, H] own tile of a tensor-core route
    beside its other tiles in shared memory."""
    smem = _tf32_smem(hidden) if route == "tf32x3" else _mma_smem(hidden, 1)
    return smem <= _MAX_SMEM


def backward_plan(h_dtype, hidden: int) -> BackwardPlan:
    """The backward's route and plan for h2 of ``h_dtype`` and ``hidden``
    columns (a multiple of 128).

    bf16 h2 takes the bf16 tensor-core route (``"mma"``) and f32 h2 the
    3xTF32 one (``"tf32x3"``) up to H = 6144. While a CTA's tiles fit in
    shared memory, one CTA holds an own tile: bf16 up to H = 1536 (chunks of
    at most 768 columns, 96 accumulator floats a thread; double-buffered
    up to H = 1024, single-buffered above), f32 up to H = 768 (one chunk,
    16-row other tiles double-buffered). Past those, a thread-block cluster
    of 2 to 8 CTAs shares one, each CTA a hidden slice (``_plan``). Past H =
    6144 (more than 8 slices of 768), and for other dtypes, the FMA
    route."""
    route = "mma" if h_dtype == torch.bfloat16 else "tf32x3"
    takes = h_dtype == _OPERAND[route] and hidden <= _MAX_HIDDEN
    return _plan(route if takes else "fma", h_dtype, hidden)


# ------------------------------------------------------------ plain versions

def _logits(h2, w):
    """[N, V] f32 logits with W taken in h2's dtype (a bf16 value is exact in
    f32, so this is the storage-dtype product with f32 accumulation)."""
    return torch.matmul(h2.float(), w.to(h2.dtype).float().t())


def _onehot(labels, v, like):
    """1.0 at each row's label, nothing for a label outside [0, v)."""
    lab = labels.long()
    valid = (lab >= 0) & (lab < v)
    hit = torch.zeros_like(like)
    rows = torch.arange(lab.shape[0], device=like.device)
    hit[rows[valid], lab[valid]] = 1.0
    return hit


def lm_loss_fwd_plain(h2, w, labels, v_true=None, pick=True):
    """The forward kernel's arithmetic in plain PyTorch. Returns (loss [N]
    f32, lse [N] f32). ``v_true`` masks columns from there on to NEG_INF and
    ``pick=False`` leaves the label's logit out (the compile probe's
    variants); the defaults are the public function."""
    s = _logits(h2, w)
    v = w.shape[0]
    if v_true is not None and v_true < v:
        s[:, v_true:] = -1e30
    m = s.amax(dim=1)
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=1))
    if not pick:
        return lse.clone(), lse
    picked = (s * _onehot(labels, v, s)).sum(dim=1)
    return lse - picked, lse


def lm_loss_bwd_plain(h2, w, labels, lse, g):
    """The two backward kernels' arithmetic in plain PyTorch. Returns (dh
    [N, H] in h2's dtype, dw [V, H] in w's dtype)."""
    s = _logits(h2, w)
    dl = (torch.exp(s - lse[:, None]) - _onehot(labels, w.shape[0], s)) * g.float()[:, None]
    dl = dl.to(h2.dtype).float()
    dh = torch.matmul(dl, w.to(h2.dtype).float()).to(h2.dtype)
    dw = torch.matmul(dl.t(), h2.float()).to(w.dtype)
    return dh, dw


# ---------------------------------------------------------------- kernels

def _kernel(name):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load("lm_loss"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _call(name, device, *args):
    with torch.cuda.device(device):
        err = _kernel(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def _aligned(t):
    """t contiguous with a 16-byte aligned start (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _prepare(h2, w, labels):
    """Checked, contiguous, aligned (h2, w, int32 labels) on one card."""
    if h2.dim() != 2 or w.dim() != 2 or h2.shape[1] != w.shape[1]:
        raise ValueError(f"h2 must be [N, H] and w [V, H], got {tuple(h2.shape)} and "
                         f"{tuple(w.shape)}")
    if h2.dtype not in _DTYPE_CODES or w.dtype not in _DTYPE_CODES:
        raise TypeError(f"lm_head_cross_entropy takes float32 or bfloat16 h2 and w, "
                        f"got {h2.dtype} and {w.dtype}")
    n, hdim = h2.shape
    if tuple(labels.shape) != (n,):
        raise ValueError(f"labels must be [{n}], got {tuple(labels.shape)}")
    if hdim % 128 or n == 0 or w.shape[0] == 0:
        raise ValueError(f"the CUDA kernels take hidden a multiple of 128 and at least "
                         f"one row and one vocab entry, got h2 {tuple(h2.shape)}, "
                         f"w {tuple(w.shape)}")
    if w.device != h2.device or labels.device != h2.device:
        raise ValueError("h2, w and labels must be on one device")
    return _aligned(h2), _aligned(w), labels.to(torch.int32).contiguous()


def lm_loss_fwd(h2, w, labels, variant="full", v_true=None, route=None):
    """(loss, lse): the kernel of ``forward_route`` on CUDA tensors, the
    plain version on CPU tensors. ``variant`` and ``v_true`` select the
    compile probe's stripped forwards (``"bare"``, ``"picked"``: instances
    of the bf16 tensor-core kernel); the launch counters count the public
    ``"full"`` forward. ``route`` forces a kernel: "fma" (the tensor-core
    kernels' predecessor, at either dtype; chip_smoke.py and the card tests
    check and time it with it), "mma" only at bf16 h2, "tf32x3" only at
    f32; no path passes it."""
    global launches_fwd
    if not h2.is_cuda:
        return lm_loss_fwd_plain(h2, w, labels, v_true, pick=variant != "bare")
    h2, w, labels = _prepare(h2, w, labels)
    if route is None:
        route = forward_route(h2.dtype)
    elif route != "fma" and route not in _OPERAND:
        raise ValueError(f"the forward's route must be 'mma', 'tf32x3' or 'fma', "
                         f"got {route!r}")
    if route in _OPERAND and h2.dtype != _OPERAND[route]:
        raise ValueError(f"the {route!r} forward takes {_OPERAND[route]} h2, got {h2.dtype}")
    if variant != "full" and route != "mma":
        raise ValueError(f"the {variant!r} forward is an instance of the tensor-core kernel")
    n, hdim = h2.shape
    v = w.shape[0]
    v_true = v if v_true is None else int(v_true)
    loss = torch.empty(n, dtype=torch.float32, device=h2.device)
    lse = torch.empty_like(loss)
    if route in _OPERAND:
        op = _OPERAND[route]
        w_read = w if w.dtype == op else _aligned(w.to(op))
        splits = _kernel("lm_loss_fwd_mma_splits")(n, v)  # CTAs sharing a row tile's vocab
        part = torch.empty((3, splits, n), dtype=torch.float32, device=h2.device)
        args = (h2.data_ptr(), w_read.data_ptr(), labels.data_ptr(), loss.data_ptr(),
                lse.data_ptr(), part.data_ptr(), n, v, hdim, v_true, splits)
        if route == "mma":
            _call("lm_loss_fwd_mma", h2.device, *args, _VARIANTS[variant])
        else:
            _call("lm_loss_fwd_tf32", h2.device, *args)
    else:
        splits = _kernel("lm_loss_fwd_splits")(n, v)
        part = torch.empty((3, splits, n), dtype=torch.float32, device=h2.device)
        _call("lm_loss_fwd", h2.device, h2.data_ptr(), w.data_ptr(), labels.data_ptr(),
              loss.data_ptr(), lse.data_ptr(), part.data_ptr(), _DTYPE_CODES[h2.dtype],
              _DTYPE_CODES[w.dtype], n, v, hdim, v_true, splits)
    if variant == "full":
        launches_fwd += 1
        launches_by_route[route]["fwd"] += 1
    return loss, lse


def _bwd_launch(h2, w, labels, lse, g, dw, w_read=None, route=None):
    """dh (dw False) or dW (dw True) through the kernel of ``backward_plan``.
    ``w_read``: W in the operand dtype of a tensor-core route, where W has
    the other one (made here when not given); dW comes out in ``w``'s own
    dtype. ``route`` forces a route (chip_smoke.py and the card tests time
    and check the FMA kernel, the tensor-core kernels' predecessor, with
    "fma"; no path passes it)."""
    global launches_dh, launches_dw
    h2, w, labels = _prepare(h2, w, labels)
    n, hdim = h2.shape
    v = w.shape[0]
    plan = (backward_plan(h2.dtype, hdim) if route is None
            else _plan(route, h2.dtype, hdim))
    for name, t in (("lse", lse), ("g", g)):
        if tuple(t.shape) != (n,) or t.device != h2.device:
            raise ValueError(f"{name} must be [{n}] on {h2.device}")
    lse, g = lse.float().contiguous(), g.float().contiguous()
    out = torch.empty(w.shape if dw else h2.shape, dtype=w.dtype if dw else h2.dtype,
                      device=h2.device)
    common = (labels.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr())
    if plan.route in _OPERAND:
        if w_read is None:
            op = _OPERAND[plan.route]
            w_read = w if w.dtype == op else w.to(op)
        w_read = _aligned(w_read)
        _call("lm_loss_bwd_mma", h2.device, h2.data_ptr(), w_read.data_ptr(), *common,
              _DTYPE_CODES[h2.dtype], _DTYPE_CODES[out.dtype], n, v, hdim, int(dw),
              plan.chunk, plan.hc, plan.stages, plan.cluster)
    else:
        _call("lm_loss_bwd", h2.device, h2.data_ptr(), w.data_ptr(), *common,
              _DTYPE_CODES[h2.dtype], _DTYPE_CODES[w.dtype], n, v, hdim, int(dw))
    key = "dw" if dw else "dh"
    launches_by_route[plan.route][key] += 1
    if dw:
        launches_dw += 1
    else:
        launches_dh += 1
    return out


def lm_loss_dh(h2, w, labels, lse, g):
    """dh [N, H] in h2's dtype: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not h2.is_cuda:
        return lm_loss_bwd_plain(h2, w, labels, lse, g)[0]
    return _bwd_launch(h2, w, labels, lse, g, False)


def lm_loss_dw(h2, w, labels, lse, g):
    """dW [V, H] in w's dtype: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if not h2.is_cuda:
        return lm_loss_bwd_plain(h2, w, labels, lse, g)[1]
    return _bwd_launch(h2, w, labels, lse, g, True)


# ---------------------------------------------------------------- autograd

class _LMLoss(torch.autograd.Function):
    """loss = lm_head_cross_entropy(h2, w, labels), differentiable in h2 and
    w (``_lm_loss`` with its ``_fwd_rule`` / ``_bwd_rule`` in the JAX
    package; labels get no gradient)."""

    @staticmethod
    def forward(ctx, h2, w, labels):
        loss, lse = lm_loss_fwd(h2, w, labels)
        ctx.save_for_backward(h2, w, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        h2, w, labels, lse = ctx.saved_tensors
        if not h2.is_cuda:
            dh, dw = lm_loss_bwd_plain(h2, w, labels, lse, g)
            return dh, dw, None
        need_h, need_w = ctx.needs_input_grad[:2]
        # a tensor-core route reads W in its operand dtype: one copy, shared
        # by dh and dW
        op = _OPERAND.get(backward_plan(h2.dtype, h2.shape[1]).route)
        w_read = w.to(op) if op is not None and w.dtype != op else None
        dh = _bwd_launch(h2, w, labels, lse, g, False, w_read=w_read) if need_h else None
        dw = _bwd_launch(h2, w, labels, lse, g, True, w_read=w_read) if need_w else None
        return dh, dw, None


def lm_head_cross_entropy(h2, w, labels, block_n=256):
    """h2 [N, H], w [V, H], labels [N] integers (already masked by the caller)
    -> per-row loss [N] f32. N must be a multiple of 1024, as in the JAX
    package (``supported``).

    ``block_n`` is validated as the JAX package does (256, 512 or 1024, else
    ValueError) and then has no effect: on the TPU it sets Mosaic's compute
    block (a compile-time knob), while the CUDA kernels' tiles are their own,
    fixed for the H100. Every valid ``block_n`` gives the same bits."""
    n = h2.shape[0]
    if _pick_rows(n) != 1024:
        raise ValueError(f"lm_head_cross_entropy takes a row count that is a multiple "
                         f"of 1024 (callers pad rows), got {n}")
    _check_block_n(block_n)
    return _LMLoss.apply(h2, w, labels.to(torch.int32))

