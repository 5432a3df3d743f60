"""Optimizer update rules as plain functions on tensors (counterpart of
paddle_tpu/optimizer/functional.py).

One function per rule, ``rule(param, grad, state, *, lr, ...) -> (new_param,
new_state)``, with the JAX package's arithmetic: grads and params widened to
f32, state kept in f32 for any param dtype (master moments), the same bias
correction ``1 - beta**step``, the result cast back to the param's dtype.
The rules allocate their results; ``Optimizer._apply`` (one parameter at a
time) and ZeRO's flat update (``make_flat_update``, one block at a time)
copy them into the parameters and state in place.

``init_state`` gives each rule the JAX package's slots, in its order, count
and dtype (f32), whatever the rule reads: RMSProp keeps its mean gradient
when it is not centered. Checkpoints store the slots by index, so each
package resumes the other's. Lamb and Lars take norms over the whole
parameter, so they are not elementwise: ZeRO's flat shards do not take
them (``ELEMENTWISE_RULES``). Adagrad takes no
``initial_accumulator_value``, as the JAX package's optimizer passes none.
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
    if rule == "adamax":
        return (z(), z())  # m, inf-norm
    if rule == "adagrad":
        return (z(),)
    if rule == "adadelta":
        return (z(), z())  # avg sq grad, avg sq update
    if rule == "rmsprop":
        return (z(), z(), z())  # mean_sq, mean, momentum
    if rule == "lamb":
        return (z(), z())
    if rule == "lars":
        return (z(),)
    raise ValueError(f"unknown optimizer rule {rule!r}")


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


def adamax(param, grad, state, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8, step,
           weight_decay=0.0):
    m, u = state
    g = grad.float()
    p32 = param.float()
    if weight_decay:
        g = g + weight_decay * p32
    m = beta1 * m + (1 - beta1) * g
    u = torch.maximum(beta2 * u, g.abs())
    new_p = p32 - (lr / (1 - beta1 ** step)) * m / (u + epsilon)
    return new_p.to(param.dtype), (m, u)


def adagrad(param, grad, state, *, lr, epsilon=1e-6, weight_decay=0.0):
    (acc,) = state
    g = grad.float()
    p32 = param.float()
    if weight_decay:
        g = g + weight_decay * p32
    acc = acc + g.square()
    new_p = p32 - lr * g / (acc.sqrt() + epsilon)
    return new_p.to(param.dtype), (acc,)


def adadelta(param, grad, state, *, lr=1.0, rho=0.95, epsilon=1e-6, weight_decay=0.0):
    avg_sq_grad, avg_sq_update = state
    g = grad.float()
    p32 = param.float()
    if weight_decay:
        g = g + weight_decay * p32
    avg_sq_grad = rho * avg_sq_grad + (1 - rho) * g.square()
    update = (avg_sq_update + epsilon).sqrt() / (avg_sq_grad + epsilon).sqrt() * g
    avg_sq_update = rho * avg_sq_update + (1 - rho) * update.square()
    new_p = p32 - lr * update
    return new_p.to(param.dtype), (avg_sq_grad, avg_sq_update)


def rmsprop(param, grad, state, *, lr, rho=0.95, epsilon=1e-6, momentum=0.0,
            centered=False, weight_decay=0.0):
    mean_sq, mean_g, mom = state
    g = grad.float()
    p32 = param.float()
    if weight_decay:
        g = g + weight_decay * p32
    mean_sq = rho * mean_sq + (1 - rho) * g.square()
    if centered:
        mean_g = rho * mean_g + (1 - rho) * g
        denom = (mean_sq - mean_g.square() + epsilon).sqrt()
    else:
        denom = (mean_sq + epsilon).sqrt()
    mom = momentum * mom + lr * g / denom
    new_p = p32 - mom
    return new_p.to(param.dtype), (mean_sq, mean_g, mom)


def _norm(x):
    return x.square().sum().sqrt()


def lamb(param, grad, state, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-6, step,
         lamb_weight_decay=0.01, exclude_from_decay=False):
    """Layer-wise trust ratio ||p|| / ||r|| over the whole parameter (1 where
    either norm is 0)."""
    m, v = state
    g = grad.float()
    p32 = param.float()
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * g.square()
    m_hat = m / (1 - beta1 ** step)
    v_hat = v / (1 - beta2 ** step)
    r = m_hat / (v_hat.sqrt() + epsilon)
    if not exclude_from_decay:
        r = r + lamb_weight_decay * p32
    w_norm, r_norm = _norm(p32), _norm(r)
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
    new_p = p32 - lr * trust * r
    return new_p.to(param.dtype), (m, v)


def lars(param, grad, state, *, lr, momentum=0.9, lars_coeff=0.001,
         lars_weight_decay=0.0005, epsilon=0.0, exclude_from_decay=False):
    """LARS: layer-wise lr = lars_coeff * ||w|| / (||g|| + wd * ||w|| + eps)
    (1 where either norm is 0), momentum applied after."""
    (vel,) = state
    g = grad.float()
    p32 = param.float()
    wd = 0.0 if exclude_from_decay else lars_weight_decay
    w_norm, g_norm = _norm(p32), _norm(g)
    local_lr = torch.where((w_norm > 0) & (g_norm > 0),
                           lars_coeff * w_norm / (g_norm + wd * w_norm + epsilon), 1.0)
    d = g + wd * p32
    vel = momentum * vel + lr * local_lr * d
    new_p = p32 - vel
    return new_p.to(param.dtype), (vel,)


RULES = {
    "sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw,
    "adamax": adamax, "adagrad": adagrad, "adadelta": adadelta,
    "rmsprop": rmsprop, "lamb": lamb, "lars": lars,
}

_NEEDS_STEP = {"adam", "adamw", "adamax", "lamb"}

# rules whose update is one elementwise function of (param, grad, state),
# so ZeRO and FSDP may run them on any slice of the flat vector (the JAX
# engine's _ZERO_RULES); lamb and lars need per-parameter norms
ELEMENTWISE_RULES = frozenset({"sgd", "momentum", "adam", "adamw", "adamax",
                               "adagrad", "adadelta", "rmsprop"})


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
