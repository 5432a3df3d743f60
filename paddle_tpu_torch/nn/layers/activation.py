"""Activation layers (counterpart of paddle_tpu/nn/layers/activation.py):
each calls its op of ops/activation.py with the arguments it was built
with, as the JAX layers do."""
from __future__ import annotations

from ...ops import activation as A
from ..layer import Layer
from .common import init_const_, make_param, place


def _simple(name, fn):
    def __init__(self, *args, **kwargs):
        Layer.__init__(self)
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return fn(x, *self._args, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward})


ReLU = _simple("ReLU", A.relu)
ReLU6 = _simple("ReLU6", A.relu6)
Sigmoid = _simple("Sigmoid", A.sigmoid)
Tanh = _simple("Tanh", A.tanh)
SiLU = _simple("SiLU", A.silu)
Swish = _simple("Swish", A.swish)
Mish = _simple("Mish", A.mish)
Hardswish = _simple("Hardswish", A.hardswish)
Hardsigmoid = _simple("Hardsigmoid", A.hardsigmoid)
Softsign = _simple("Softsign", A.softsign)
Tanhshrink = _simple("Tanhshrink", A.tanhshrink)
LogSigmoid = _simple("LogSigmoid", A.log_sigmoid)
GELU = _simple("GELU", A.gelu)
ELU = _simple("ELU", A.elu)
SELU = _simple("SELU", A.selu)
CELU = _simple("CELU", A.celu)
LeakyReLU = _simple("LeakyReLU", A.leaky_relu)
Hardtanh = _simple("Hardtanh", A.hardtanh)
Hardshrink = _simple("Hardshrink", A.hardshrink)
Softshrink = _simple("Softshrink", A.softshrink)
Softplus = _simple("Softplus", A.softplus)
ThresholdedReLU = _simple("ThresholdedReLU", A.thresholded_relu)
Maxout = _simple("Maxout", A.maxout)
GLU = _simple("GLU", A.glu)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return A.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return A.log_softmax(x, self.axis)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, data_format="NCHW",
                 name=None, device=None):
        super().__init__()
        self.data_format, self._init = data_format, init
        self.weight = make_param((num_parameters,), weight_attr)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, self._init)

    def forward(self, x):
        return A.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    """Training draws each slope from ``generator`` (an attribute; torch's
    default generator when None)."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper
        self.generator = None

    def forward(self, x):
        return A.rrelu(x, self.lower, self.upper, training=self.training,
                       generator=self.generator)


class Softmax2D(Layer):
    """Softmax over the channel axis of CHW / NCHW inputs."""

    def forward(self, x):
        if x.dim() not in (3, 4):
            raise ValueError("Softmax2D expects CHW or NCHW input")
        return A.softmax(x, axis=-3)


Silu = SiLU
