"""Automatic mixed precision (counterpart of paddle_tpu/amp/__init__.py and the
autocast half of paddle_tpu/core/dispatch.py).

``auto_cast`` sets a thread-local context; each op of the port looks itself
up by the JAX package's op name (``"linear"``, ``"matmul"``, ``"attention"``,
``"layer_norm"``, ``"mean"``, ...) with ``autocast_dtype_for`` and casts its
float inputs as ``dispatch.apply`` does (``cast_inputs``). The op lists are
the JAX package's, copied as they stand (dispatch.py:66-77). This is not
``torch.autocast``, whose lists differ: for example the JAX package leaves
``fused_linear_cross_entropy`` and ``embedding`` uncast, so under bf16 O1 the
loss's LM-head product runs in f32 on the f32 output of the black-listed
final LayerNorm, and the port does the same.

Levels: O1 casts white-listed ops to the low dtype and black-listed ops to
f32 and leaves the rest in their input dtype; O2 casts every op to the low
dtype except the black-listed ones (f32). Parameters stay f32 either way
(master weights; the optimizer updates them in f32). The port's ops of
``ops/`` take the lookup; plain tensor code around them (the model's
residual adds, reshapes) does not, where the JAX package casts those too at
O2.
"""
from __future__ import annotations

import contextlib
import threading

import torch

AMP_WHITE = frozenset({
    "matmul", "conv2d", "conv1d", "conv3d", "conv2d_transpose", "bmm", "mm",
    "einsum", "linear", "addmm", "mv", "attention",
})
AMP_BLACK = frozenset({
    "exp", "log", "log2", "log10", "log1p", "softmax", "log_softmax",
    "cross_entropy", "softmax_with_cross_entropy", "mean", "sum", "norm",
    "layer_norm", "layer_norm_pallas", "batch_norm", "group_norm",
    "instance_norm", "cumsum",
    "pow", "rsqrt", "sigmoid_cross_entropy_with_logits", "binary_cross_entropy",
    "nll_loss", "kl_div", "erf", "logsumexp", "var", "std",
})

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

_state = threading.local()


class auto_cast:
    """Context manager: ``with auto_cast(dtype="bfloat16"): loss = model(...)``.

    enable=False installs no context (ops run in their input dtypes), as in
    the JAX package; contexts nest and restore the outer one on exit."""

    def __init__(self, enable=True, custom_white_list=None, custom_black_list=None,
                 level="O1", dtype="bfloat16"):
        if level not in ("O1", "O2"):
            raise ValueError(f"level must be 'O1' or 'O2', got {level!r}")
        self.enable = bool(enable)
        self.dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.level = level
        self.white = AMP_WHITE | set(custom_white_list or ())
        self.black = ((AMP_BLACK - set(custom_white_list or ()))
                      | set(custom_black_list or ()))

    def __enter__(self):
        self._prev = getattr(_state, "ctx", None)
        _state.ctx = self if self.enable else None
        return self

    def __exit__(self, *exc):
        _state.ctx = self._prev
        return False


def amp_ctx():
    """The active ``auto_cast`` of this thread, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def amp_scope(ctx):
    """Install ``ctx`` (an ``auto_cast`` or None) as this thread's context for
    the block and restore the one before. A recomputed segment's replay runs
    under its forward's context this way: the backward may run outside the
    ``with auto_cast`` block, or on autograd's device thread."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def autocast_dtype_for(name: str):
    """The dtype op ``name`` computes in under the active context: the low
    dtype, f32, or None (its inputs' own dtypes)."""
    ctx = amp_ctx()
    if ctx is None:
        return None
    if ctx.level == "O2":
        return torch.float32 if name in ctx.black else ctx.dtype
    if name in ctx.white:
        return ctx.dtype
    if name in ctx.black:
        return torch.float32
    return None


def cast_inputs(name: str, *tensors):
    """``tensors`` with every floating one cast to op ``name``'s autocast
    dtype (None entries and integer tensors pass through); differentiable."""
    dtype = autocast_dtype_for(name)
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) if t is not None and t.is_floating_point()
                 and t.dtype != dtype else t for t in tensors)
