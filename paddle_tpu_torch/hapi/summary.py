"""``summary`` of the port: each leaf layer's output shape and parameter
count from ``nn.Module`` forward hooks over one eval forward (counterpart
of paddle_tpu/hapi/summary.py; reference python/paddle/hapi/model_summary.py).
The rows and counts are the JAX package's for the same network."""
from __future__ import annotations

import torch

from .model import module_device


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def make_inputs(net, input_size, dtypes=None):
    """Zero inputs of ``input_size`` (one shape, or a list of shapes; a dim
    of None or below 1 counts as 1) on ``net``'s device, f32 unless
    ``dtypes`` says."""
    multi = (isinstance(input_size, (list, tuple)) and len(input_size) > 0
             and isinstance(input_size[0], (list, tuple)))
    sizes = list(input_size) if multi else [input_size]
    dts = dtypes if isinstance(dtypes, (list, tuple)) else [dtypes] * len(sizes)
    dev = module_device(net)
    return [torch.zeros([d if d and d > 0 else 1 for d in s],
                        dtype=getattr(torch, dt) if isinstance(dt, str) else (dt or torch.float32),
                        device=dev)
            for s, dt in zip(sizes, dts)]


def leaf_modules(net):
    """(name, module) of every leaf below ``net``, in module order."""
    return [(name, sub) for name, sub in net.named_modules()
            if sub is not net and not list(sub.children())]


def run_hooked(net, inputs, make_hook, modules):
    """One eval forward of ``net`` on ``inputs`` with ``make_hook(name,
    module)`` hooked after each of ``modules``; the train flag and the hooks
    are restored after it."""
    hooks = [sub.register_forward_hook(make_hook(name, sub)) for name, sub in modules]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()


def summary(net, input_size=None, dtypes=None, input=None):
    """Print and return ``{"total_params", "trainable_params"}`` of ``net``
    after one forward of ``input`` (or zeros of ``input_size``)."""
    if input is None:
        if input_size is None:
            raise ValueError("summary needs input_size or input")
        input = make_inputs(net, input_size, dtypes)
    elif not isinstance(input, (list, tuple)):
        input = [input]

    rows = []

    def make_hook(name, layer):
        def hook(lyr, inputs, outputs):
            out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
            shape = list(out.shape) if isinstance(out, torch.Tensor) else []
            n_params = sum(_numel(p.shape) for p in lyr.parameters(recurse=False))
            rows.append((name or lyr.__class__.__name__, shape, n_params))
        return hook

    run_hooked(net, input, make_hook, leaf_modules(net))
    total = sum(_numel(p.shape) for p in net.parameters())
    trainable = sum(_numel(p.shape) for p in net.parameters() if p.requires_grad)
    w1 = max([len(r[0]) for r in rows] + [10]) + 2
    print(f"{'Layer':<{w1}}{'Output Shape':<24}{'Param #':>12}")
    print("=" * (w1 + 36))
    for name, shape, n in rows:
        print(f"{name:<{w1}}{str(shape):<24}{n:>12,}")
    print("=" * (w1 + 36))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
