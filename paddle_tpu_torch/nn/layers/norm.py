"""Normalization layers (counterpart of paddle_tpu/nn/layers/norm.py):
``BatchNorm``, ``BatchNorm1D/2D/3D``, ``SyncBatchNorm``, ``LayerNorm``,
``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D`` and
``LocalResponseNorm`` (weights ones, biases zeros, unless a ``ParamAttr``
says otherwise).

The running statistics are buffers named ``_mean`` and ``_variance`` (zeros
and ones at the start), as in the JAX layers, so state dicts and
``paddle_tpu_torch.save`` files carry the JAX names. ``momentum`` is
Paddle's (0.9: the share of the running statistics kept). In training the
layer normalizes by the batch's statistics and updates the running ones in
place (ops/nn_functional.py ``batch_norm``: the JAX package's eager
update). Under the engine's data-parallel step the batch is the ranks'
global batch (``batch_group_scope``), which is what ``SyncBatchNorm``
stands for: it is ``BatchNorm`` itself, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...ops import nn_functional as F
from ..layer import Layer
from .common import init_const_, make_param, place


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None,
                 device=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = make_param((num_features,), weight_attr)
        self.bias = make_param((num_features,), bias_attr, is_bias=True)
        self.register_buffer("_mean", torch.empty(num_features))
        self.register_buffer("_variance", torch.empty(num_features))
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, 1.0)
        init_const_(self.bias, 0.0)
        init_const_(self._mean, 0.0)
        init_const_(self._variance, 1.0)

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=self.training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCL", use_global_stats=None, name=None,
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format == "NCL" else "NLC", use_global_stats,
                         device=device)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None,
                 device=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         "NCHW" if data_format == "NCDHW" else "NDHWC", use_global_stats,
                         device=device)


class SyncBatchNorm(_BatchNormBase):
    """BatchNorm over the replicas' whole batch. The engine's step takes the
    statistics of every batch norm over its replica group already
    (``batch_group_scope``), as the JAX engine's pjit does; alone on one
    card it equals BatchNorm."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch norm below it (itself included) made a
        SyncBatchNorm with the same parameters and running statistics."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            with torch.device("meta"):
                out = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                    data_format=layer._data_format,
                                    use_global_stats=layer._use_global_stats)
            out.weight, out.bias = layer.weight, layer.bias
            out._mean, out._variance = layer._mean, layer._variance
            out.train(layer.training)
        for name, sub in list(layer._modules.items()):
            out._modules[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None, device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self._normalized_shape = tuple(normalized_shape)
        self._epsilon = epsilon
        self.weight = make_param(self._normalized_shape, weight_attr)
        self.bias = make_param(self._normalized_shape, bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, 1.0)
        init_const_(self.bias, 0.0)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={list(self._normalized_shape)}, epsilon={self._epsilon}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = make_param((hidden_size,), weight_attr)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, 1.0)

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, device=None):
        super().__init__()
        self._num_groups, self._epsilon, self._data_format = num_groups, epsilon, data_format
        self.weight = make_param((num_channels,), weight_attr)
        self.bias = make_param((num_channels,), bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, 1.0)
        init_const_(self.bias, 0.0)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self.weight, self.bias, self._epsilon,
                            self._data_format)


class _InstanceNormBase(Layer):
    """Instance statistics always (the running statistics and ``momentum``
    are not kept, as in the JAX layer). As there, when either attr is
    False the other parameter is made with the default attributes."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCL", name=None, device=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            weight_attr = False if weight_attr is False else None
            bias_attr = False if bias_attr is False else None
        self.weight = make_param((num_features,), weight_attr)
        self.bias = make_param((num_features,), bias_attr, is_bias=True)
        self.reset_parameters()
        place(self, device)

    def reset_parameters(self, generator=None):
        init_const_(self.weight, 1.0)
        init_const_(self.bias, 0.0)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)
