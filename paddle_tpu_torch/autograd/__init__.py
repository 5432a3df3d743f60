"""paddle.autograd of the port (counterpart of paddle_tpu/autograd/__init__.py):
PyLayer, backward and grad over ``torch.autograd``.

A ``PyLayer`` subclass runs through a ``torch.autograd.Function`` made for
it at first use: ``forward(ctx, *args, **kwargs)`` under no_grad, and
``backward(ctx, *grads)`` returning one gradient for each tensor argument,
in order (None for one that needs none), as in the reference.
``ctx.save_for_backward(*tensors)`` keeps them through torch's saved-tensor
mechanism; ``ctx.saved_tensor()`` (or the attribute ``ctx.saved_tensor``)
and ``ctx.saved_tensors()`` give them back.
"""
from __future__ import annotations

import torch

from ..core.autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, run_backward, set_grad_enabled,
)


def backward(tensors, grad_tensors=None, retain_graph=False):
    run_backward(tensors, grad_tensors, retain_graph)


class _Saved(list):
    """The saved tensors: a list that is also callable, so that both
    ``ctx.saved_tensor`` and ``ctx.saved_tensor()`` read them."""

    def __call__(self):
        return self


class PyLayerContext:
    def __init__(self, fn_ctx=None):
        self._fn_ctx = fn_ctx
        self._saved = []
        self.not_inplace_tensors = ()

    def save_for_backward(self, *tensors):
        if self._fn_ctx is not None and all(t is None or torch.is_tensor(t) for t in tensors):
            self._fn_ctx.save_for_backward(*tensors)
            self._saved = None
        else:
            self._saved = list(tensors)

    @property
    def saved_tensor(self):
        if self._saved is None:
            return _Saved(self._fn_ctx.saved_tensors)
        return _Saved(self._saved)

    def saved_tensors(self):
        return self.saved_tensor

    def mark_not_inplace(self, *args):
        pass

    def mark_non_differentiable(self, *tensors):
        if self._fn_ctx is not None:
            self._fn_ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, v):
        if self._fn_ctx is not None:
            self._fn_ctx.set_materialize_grads(v)


class PyLayerMeta(type):
    pass


def _function_of(cls):
    fn = cls.__dict__.get("_torch_function")
    if fn is not None:
        return fn

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fn_ctx, kwargs, *args):
            ctx = PyLayerContext(fn_ctx)
            fn_ctx.pylayer_ctx = ctx
            fn_ctx.tensor_mask = [torch.is_tensor(a) for a in args]
            return cls.forward(ctx, *args, **kwargs)

        @staticmethod
        def backward(fn_ctx, *grads):
            in_grads = cls.backward(fn_ctx.pylayer_ctx, *grads)
            if not isinstance(in_grads, (tuple, list)):
                in_grads = (in_grads,)
            it = iter(in_grads)
            return (None, *(next(it, None) if is_t else None
                            for is_t in fn_ctx.tensor_mask))

    _Fn.__name__ = cls.__name__
    cls._torch_function = _Fn
    return _Fn


class PyLayer(metaclass=PyLayerMeta):
    """Custom autograd op:

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x): ...
            @staticmethod
            def backward(ctx, dy): ...
    """

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        return _function_of(cls).apply(kwargs, *args)


LegacyPyLayer = PyLayer


def set_grad_enabled_fn(mode):
    return set_grad_enabled(mode)
