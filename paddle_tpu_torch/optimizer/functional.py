"""Optimizer update rules as plain functions on tensors (counterpart of
paddle_tpu/optimizer/functional.py).

One function per rule, ``rule(param, grad, state, *, lr, ...) -> (new_param,
new_state)``, with the JAX package's arithmetic: grads and params widened to
f32, state kept in f32 for any param dtype (master moments), the same bias
correction ``1 - beta**step``, the result cast back to the param's dtype.
The rules allocate their results; ``Optimizer._apply`` (one parameter at a
time) and ZeRO's flat update (``make_flat_update``, one block at a time)
copy them into the parameters and state in place.
"""
from __future__ import annotations

import torch

from ..nn.clip import ClipGradBase


def init_state(rule: str, param):
    """Zero state of ``rule`` for ``param``, in f32."""
    def z():
        return torch.zeros_like(param, dtype=torch.float32)
    if rule == "sgd":
        return ()
    if rule == "momentum":
        return (z(),)
    if rule in ("adam", "adamw"):
        return (z(), z())  # m, v
    raise ValueError(f"optimizer rule {rule!r} is not ported")


def clip_grads(grads: dict, clip):
    """Apply a grad-clip rule over a name -> grad dict (no rule, or one of
    another kind, leaves the grads as they are, as in the JAX package)."""
    if not isinstance(clip, ClipGradBase):
        return grads
    return dict(clip(list(grads.items())))


def sgd(param, grad, state, *, lr, weight_decay=0.0):
    g = grad.float()
    if weight_decay:
        g = g + weight_decay * param.float()
    new_p = param.float() - lr * g
    return new_p.to(param.dtype), ()


def momentum(param, grad, state, *, lr, momentum=0.9, weight_decay=0.0,
             use_nesterov=False):
    (vel,) = state
    g = grad.float()
    if weight_decay:
        g = g + weight_decay * param.float()
    vel = momentum * vel + g
    update = g + momentum * vel if use_nesterov else vel
    new_p = param.float() - lr * update
    return new_p.to(param.dtype), (vel,)


def adam(param, grad, state, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8, step,
         weight_decay=0.0):
    m, v = state
    g = grad.float()
    p32 = param.float()
    if weight_decay:  # L2 regularization (paddle Adam semantics)
        g = g + weight_decay * p32
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g.square()
    m_hat = m / (1 - beta1 ** step)
    v_hat = v / (1 - beta2 ** step)
    new_p = p32 - lr * m_hat / (v_hat.sqrt() + epsilon)
    return new_p.to(param.dtype), (m, v)


def adamw(param, grad, state, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8, step,
          weight_decay=0.01):
    m, v = state
    g = grad.float()
    p32 = param.float()
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g.square()
    m_hat = m / (1 - beta1 ** step)
    v_hat = v / (1 - beta2 ** step)
    # decoupled decay: p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)
    new_p = p32 - lr * (m_hat / (v_hat.sqrt() + epsilon) + weight_decay * p32)
    return new_p.to(param.dtype), (m, v)


RULES = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}

_NEEDS_STEP = {"adam", "adamw"}


def make_param_update(optimizer):
    """update(name, param, grad, state, lr, step) -> (new_param, new_state):
    the optimizer's rule with parameter ``name``'s kwargs (weight-decay
    exclusion through ``apply_decay_param_fun``)."""
    rule = RULES[optimizer._rule]
    needs_step = optimizer._rule in _NEEDS_STEP

    def update(name, param, grad, state, lr, step):
        kw = optimizer._rule_kwargs(name)
        if needs_step:
            kw["step"] = step
        return rule(param, grad, state, lr=lr, **kw)

    return update


def make_flat_update(optimizer, name, block=1 << 24):
    """The ZeRO twin of ``make_param_update`` (the JAX engine's
    ``_make_flat_update``): ONE uniform rule, with parameter ``name``'s
    kwargs, over flat f32 ``[shard]`` vectors, written in place.

    update(p_shard, g_shard, state_shards, lr, step) runs the rule on
    ``block`` elements at a time (elementwise, so the blocks change no
    result and bound the temporaries). The engine engages it only when every
    parameter's kwargs equal ``name``'s; pad slots (zero parameter, gradient
    and state) stay zero under every rule."""
    param_update = make_param_update(optimizer)

    def update(p_shard, g_shard, state_shards, lr, step):
        for lo in range(0, p_shard.shape[0], block):
            sl = slice(lo, lo + block)
            new_p, new_state = param_update(name, p_shard[sl], g_shard[sl],
                                            tuple(s[sl] for s in state_shards), lr, step)
            p_shard[sl].copy_(new_p)
            for s, ns in zip(state_shards, new_state):
                s[sl].copy_(ns)

    return update
