"""Eager autograd (counterpart of paddle_tpu/core/autograd.py).

The reference builds its own tape (a grad node is the ``jax.vjp`` closure of
an op). The port's tensors are ``torch.Tensor`` and its tape is
``torch.autograd``: a grad node is the ``grad_fn`` the torch op recorded.
``stop_gradient=False`` is ``requires_grad=True``. The grad modes are
torch's own, so the torch ops the models run and the namespace's ops see the
same switch.
"""
from __future__ import annotations

import contextlib

import torch

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _as_list(x):
    if x is None:
        return None
    return list(x) if isinstance(x, (list, tuple)) else [x]


def run_backward(tensors, grad_tensors=None, retain_graph: bool = False,
                 create_graph: bool = False):
    """Accumulate the gradients of ``tensors`` into the leaves' ``.grad``
    (egr::RunBackward). A non-scalar output needs its ``grad_tensors`` entry."""
    tensors = _as_list(tensors)
    grads = _as_list(grad_tensors)
    for t in tensors:
        if not t.requires_grad:
            raise RuntimeError(
                "backward() called on a tensor with stop_gradient=True; nothing to do")
    torch.autograd.backward(tensors, grads, retain_graph=retain_graph,
                            create_graph=create_graph)


@contextlib.contextmanager
def _stopped(tensors):
    """Gradient does not flow back through ``tensors`` inside the block: a
    hook replaces the gradient each receives with zeros."""
    handles = [t.register_hook(torch.zeros_like) for t in tensors if t.requires_grad]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def grad(outputs, inputs, grad_outputs=None, retain_graph=None, create_graph=False,
         only_inputs=True, allow_unused=False, no_grad_vars=None):
    """Functional paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs``, without touching ``.grad``. ``create_graph=True`` gives
    gradients that carry their graph (double grad). ``no_grad_vars`` are
    held constant: no gradient flows back through them. ``only_inputs`` is
    accepted for the reference's signature (only True is meaningful)."""
    outputs = _as_list(outputs)
    inputs = _as_list(inputs)
    grad_outputs = _as_list(grad_outputs)
    if grad_outputs is not None:
        grad_outputs = [g if g is None or torch.is_tensor(g)
                        else torch.as_tensor(g, dtype=o.dtype, device=o.device)
                        for g, o in zip(grad_outputs, outputs)]
    if retain_graph is None:
        retain_graph = create_graph
    with _stopped(_as_list(no_grad_vars) or []):
        result = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs,
                                     retain_graph=retain_graph, create_graph=create_graph,
                                     allow_unused=True)
    if not allow_unused and any(g is None for g in result):
        raise RuntimeError("one of the input tensors received no gradient; "
                           "pass allow_unused=True to get None instead")
    return list(result)
