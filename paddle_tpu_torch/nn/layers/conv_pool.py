"""Convolution and pooling layers (counterpart of
paddle_tpu/nn/layers/conv_pool.py): ``Conv1D/2D/3D``,
``Conv1D/2D/3DTranspose``, ``MaxPool1D/2D/3D``, ``AvgPool1D/2D/3D``,
``Adaptive{Avg,Max}Pool{1,2,3}D`` and ``MaxUnPool1D/2D/3D``.

Weights are ``[out, in / groups, *k]`` (a transposed convolution's ``[in,
out / groups, *k]``), as in PyTorch and the JAX layers, drawn from N(0,
sqrt(2 / fan_in)) with fan_in = in / groups * prod(k) (the JAX layers'
default), biases zero; ``bias_attr=False`` leaves the bias out. At a channel-last ``data_format``
the layer hands its weight to the op in the op's HWIO layout (the JAX
layer passes its OIHW weight there, which the JAX op cannot take).
``padding_mode`` is accepted and, as in the JAX layers, not read. The
pools' ``ceil_mode`` is ignored, as the JAX ops ignore it
(ops/nn_functional.py).
"""
from __future__ import annotations

import math

from ...ops import nn_functional as F
from ..layer import Layer
from .common import init_const_, init_normal_, make_param, place

_ntuple = F._ntuple


class _ConvNd(Layer):
    _nd = 2
    _op = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None):
        super().__init__()
        nd = self._nd
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride = _ntuple(stride, nd)
        self.padding = padding
        self.dilation = _ntuple(dilation, nd)
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        self.weight = make_param(self._weight_shape(), weight_attr)
        self.bias = make_param((out_channels,), bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def _weight_shape(self):
        return (self.out_channels, self.in_channels // self.groups) + self.kernel_size

    def reset_parameters(self, generator=None):
        fan_in = self.in_channels // self.groups * math.prod(self.kernel_size)
        init_normal_(self.weight, math.sqrt(2.0 / fan_in) if fan_in else 1.0, generator)
        init_const_(self.bias, 0.0)

    def forward(self, x):
        w = self.weight
        if self.data_format in F._CHANNEL_LAST:
            w = w.permute(*range(2, 2 + self._nd), 1, 0)   # -> the op's HWIO
        return self._op(x, w, self.bias, self.stride, self.padding, self.dilation,
                        self.groups, self.data_format)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, kernel_size={self.kernel_size}, "
                f"stride={self.stride}, padding={self.padding}")


class Conv1D(_ConvNd):
    _nd = 1
    _op = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, device)


class Conv2D(_ConvNd):
    pass


class Conv3D(_ConvNd):
    _nd = 3
    _op = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, padding_mode, weight_attr, bias_attr, data_format, device)


class _Op(Layer):
    """A parameterless layer: ``op(x, *args)``."""
    _op = None

    def __init__(self, *args):
        super().__init__()
        self.args = args

    def forward(self, x):
        return type(self)._op(x, *self.args)


class MaxPool1D(_Op):
    _op = staticmethod(F.max_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode)


class MaxPool2D(_Op):
    _op = staticmethod(F.max_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode, data_format)


class MaxPool3D(_Op):
    _op = staticmethod(F.max_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, return_mask, ceil_mode, data_format)


class AvgPool1D(_Op):
    _op = staticmethod(F.avg_pool1d)

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__(kernel_size, stride, padding, exclusive, ceil_mode)


class AvgPool2D(_Op):
    _op = staticmethod(F.avg_pool2d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AvgPool3D(_Op):
    _op = staticmethod(F.avg_pool3d)

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__(kernel_size, stride, padding, ceil_mode, exclusive,
                         divisor_override, data_format)


class AdaptiveAvgPool1D(_Op):
    _op = staticmethod(F.adaptive_avg_pool1d)

    def __init__(self, output_size, name=None):
        super().__init__(output_size)
        self.output_size = output_size


class AdaptiveAvgPool2D(_Op):
    _op = staticmethod(F.adaptive_avg_pool2d)

    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__(output_size, data_format)
        self.output_size = output_size


class AdaptiveAvgPool3D(_Op):
    _op = staticmethod(F.adaptive_avg_pool3d)

    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__(output_size)
        self.output_size = output_size


class AdaptiveMaxPool1D(_Op):
    _op = staticmethod(F.adaptive_max_pool1d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)
        self.output_size = output_size


class AdaptiveMaxPool2D(_Op):
    """Its mask is not returned (``return_mask`` is not read), as in the JAX
    layer."""
    _op = staticmethod(F.adaptive_max_pool2d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size)
        self.output_size = output_size


class AdaptiveMaxPool3D(_Op):
    _op = staticmethod(F.adaptive_max_pool3d)

    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__(output_size, return_mask)
        self.output_size = output_size


class _ConvTransposeNd(_ConvNd):
    """A transposed convolution: weight ``[in, out / groups, *k]``; the
    forward's ``output_size`` is accepted and not read (the op drops it, as
    the JAX op does)."""
    _op = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dilation,
                         groups, "zeros", weight_attr, bias_attr, data_format, device)
        self.output_padding = output_padding

    def _weight_shape(self):
        return (self.in_channels, self.out_channels // self.groups) + self.kernel_size

    def forward(self, x, output_size=None):
        return self._op(x, self.weight, self.bias, self.stride, self.padding,
                        self.output_padding, self.groups, self.dilation, output_size,
                        self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _nd = 1
    _op = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCL", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr,
                         data_format, device)


class Conv2DTranspose(_ConvTransposeNd):
    pass


class Conv3DTranspose(_ConvTransposeNd):
    _nd = 3
    _op = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None, bias_attr=None,
                 data_format="NCDHW", device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, groups, dilation, weight_attr, bias_attr,
                         data_format, device)


class _MaxUnPoolNd(Layer):
    _op = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCHW",
                 output_size=None, name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.data_format, self.output_size = data_format, output_size

    def forward(self, x, indices):
        return type(self)._op(x, indices, self.kernel_size, self.stride, self.padding,
                              self.data_format, self.output_size)


class MaxUnPool1D(_MaxUnPoolNd):
    _op = staticmethod(F.max_unpool1d)

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCL",
                 output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format, output_size)


class MaxUnPool2D(_MaxUnPoolNd):
    _op = staticmethod(F.max_unpool2d)


class MaxUnPool3D(_MaxUnPoolNd):
    _op = staticmethod(F.max_unpool3d)

    def __init__(self, kernel_size, stride=None, padding=0, data_format="NCDHW",
                 output_size=None, name=None):
        super().__init__(kernel_size, stride, padding, data_format, output_size)
