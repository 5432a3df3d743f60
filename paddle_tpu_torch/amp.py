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
(the optimizer updates them in f32) unless ``decorate(level="O2")`` casts
them to the low dtype; the optimizer state stays f32 then too. The port's
ops of ``ops/`` take the lookup; plain tensor code around them (the model's
residual adds, reshapes) does not, where the JAX package casts those too at
O2.

``GradScaler`` is the JAX package's dynamic loss scaling (paddle's
check_finite_and_unscale and update_loss_scaling): ``unscale_`` scales
every gradient of the optimizer's parameters in place and reads back to
the host whether one was not finite, once a step, as the JAX package does;
``step`` then skips the optimizer's step. It reads the optimizer's
``_parameter_list``, so around ``incubate.LookAhead`` call ``unscale_`` on
the inner optimizer before ``step(lookahead)``.
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


def amp_guard_from_configs(cfg, force_bf16=False):
    """The ``auto_cast`` of a strategy's ``AMPConfig`` (the one mapping the
    eager AMP meta-optimizer and the engine's ``strategy.amp`` share): its
    dtype, O2 when ``use_pure_fp16``, else O1, and its white and black
    lists. ``force_bf16`` turns float16 into bfloat16 (the engine's step
    has no loss scaling)."""
    dtype = getattr(cfg, "dtype", "bfloat16")
    if force_bf16 and dtype == "float16":
        dtype = "bfloat16"
    return auto_cast(dtype=dtype,
                     level="O2" if getattr(cfg, "use_pure_fp16", False) else "O1",
                     custom_white_list=getattr(cfg, "custom_white_list", None),
                     custom_black_list=getattr(cfg, "custom_black_list", None))


def decorate(models, optimizers=None, level="O1", dtype="bfloat16", master_weight=None,
             save_dtype=None):
    """At O2, cast every floating parameter of ``models`` (a module or a list)
    to ``dtype`` in place (``p.data``), so the optimizers' references stay
    valid and their f32 state stays f32; O1 changes nothing. Returns
    ``models``, or ``(models, optimizers)`` when optimizers are given."""
    if level == "O2":
        low = _DTYPES[dtype] if isinstance(dtype, str) else dtype
        for m in models if isinstance(models, (list, tuple)) else [models]:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(low)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=1000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def _unscale(self, optimizer):
        """Every grad times 1 / scale, in place; one host read of whether
        any was not finite."""
        if not self._enable:
            return
        inv = 1.0 / self._scale
        found = None
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            bad = ~torch.isfinite(p.grad).all()
            found = bad if found is None else found | bad
            p.grad.mul_(inv)
        self._found_inf = found is not None and bool(found)
        self._unscaled = True

    def unscale_(self, optimizer):
        self._unscale(optimizer)

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._unscaled = False

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d.get("good_steps", 0)
        self._bad_steps = d.get("bad_steps", 0)
