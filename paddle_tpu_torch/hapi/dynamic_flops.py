"""``flops`` of the port: a forward's FLOPs (a multiply-add counted once)
from ``nn.Module`` forward hooks, by layer type (counterpart of
paddle_tpu/hapi/dynamic_flops.py; reference python/paddle/hapi/dynamic_flops.py).
The handlers are the JAX package's: a convolution counts output elements x
(kernel elements x input channels a group + 1 with a bias), a Linear
output rows x out x (in + 1 with a bias), a norm 2 x its input's elements,
an activation or a pool its output's elements; other leaves count 0
unless ``custom_ops`` ({layer class: fn(layer, inputs, output)}) names
them."""
from __future__ import annotations

import math

from .summary import leaf_modules, make_inputs, run_hooked


def _numel(x):
    return math.prod(int(d) for d in x.shape)


def _count_conv(layer, inputs, output):
    kernel_ops = math.prod(layer.kernel_size) * (layer.in_channels // layer.groups)
    bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
    return _numel(output) * (kernel_ops + bias_ops)


def _count_linear(layer, inputs, output):
    bias_ops = 1 if getattr(layer, "bias", None) is not None else 0
    out = int(output.shape[-1])
    return _numel(output) // max(out, 1) * (layer.in_features * out + bias_ops * out)


def _count_norm(layer, inputs, output):
    return 2 * _numel(inputs[0])


def _count_act(layer, inputs, output):
    return _numel(output)


def _count_pool(layer, inputs, output):
    return _numel(output)


_HANDLERS = [
    ("Conv1D", _count_conv), ("Conv2D", _count_conv), ("Conv3D", _count_conv),
    ("Linear", _count_linear),
    ("BatchNorm", _count_norm), ("BatchNorm1D", _count_norm),
    ("BatchNorm2D", _count_norm), ("BatchNorm3D", _count_norm),
    ("LayerNorm", _count_norm), ("GroupNorm", _count_norm),
    ("InstanceNorm2D", _count_norm), ("SyncBatchNorm", _count_norm),
    ("ReLU", _count_act), ("ReLU6", _count_act), ("GELU", _count_act),
    ("Sigmoid", _count_act), ("Tanh", _count_act), ("LeakyReLU", _count_act),
    ("Hardswish", _count_act), ("Hardsigmoid", _count_act), ("Swish", _count_act),
    ("AvgPool1D", _count_pool), ("AvgPool2D", _count_pool), ("AvgPool3D", _count_pool),
    ("MaxPool1D", _count_pool), ("MaxPool2D", _count_pool), ("MaxPool3D", _count_pool),
    ("AdaptiveAvgPool1D", _count_pool), ("AdaptiveAvgPool2D", _count_pool),
    ("AdaptiveMaxPool2D", _count_pool),
]


def _handlers():
    from .. import nn

    return {getattr(nn, name): fn for name, fn in _HANDLERS if hasattr(nn, name)}


def flops(net, input_size=None, inputs=None, custom_ops=None, print_detail=False):
    """The FLOPs of one forward of ``net`` on ``inputs`` (or f32 zeros of
    ``input_size``)."""
    if inputs is None:
        if input_size is None:
            raise ValueError("flops needs input_size or inputs")
        inputs = make_inputs(net, input_size)
    elif not isinstance(inputs, (list, tuple)):
        inputs = [inputs]

    table = _handlers()
    if custom_ops:
        table.update(custom_ops)
    rows = []

    def handler(sub):
        for cls, fn in table.items():
            if isinstance(sub, cls):
                return fn
        return None

    def make_hook(name, layer):
        fn = handler(layer)

        def hook(lyr, ins, outs):
            out = outs[0] if isinstance(outs, (list, tuple)) else outs
            rows.append((name or lyr.__class__.__name__, int(fn(lyr, ins, out))))
        return hook

    run_hooked(net, inputs, make_hook,
               [(n, s) for n, s in leaf_modules(net) if handler(s) is not None])
    total = sum(n for _, n in rows)
    if print_detail:
        w1 = max([len(r[0]) for r in rows] + [10]) + 2
        print(f"{'Layer':<{w1}}{'FLOPs':>16}")
        for name, n in rows:
            print(f"{name:<{w1}}{n:>16,}")
        print(f"Total FLOPs: {total:,}")
    return total
