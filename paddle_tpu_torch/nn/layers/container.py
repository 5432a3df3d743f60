"""Container layers (counterpart of paddle_tpu/nn/layers/container.py) on
PyTorch's containers (each also a ``Layer``).

``Sequential`` takes positional layers, ``(name, layer)`` pairs or an
``OrderedDict``, and indexes by int, slice (a new Sequential, renumbered
from 0, as the JAX package's) and name.
"""
from __future__ import annotations

import collections

from torch import nn

from ..layer import Layer


class Sequential(nn.Sequential, Layer):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            super().__init__(layers[0])
        elif (layers and isinstance(layers[0], (list, tuple)) and len(layers[0]) == 2
              and isinstance(layers[0][0], str)):
            super().__init__(collections.OrderedDict(layers))
        else:
            super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self._modules[idx]
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList, Layer):
    pass


class LayerDict(nn.ModuleDict, Layer):
    pass


class ParameterList(nn.ParameterList, Layer):
    pass
