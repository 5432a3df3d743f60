"""LeNet, the BASELINE config-1 model (counterpart of
paddle_tpu/vision/models/lenet.py); ``device`` and ``seed`` as ResNet's."""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.layers import Conv2D, Linear, MaxPool2D, ReLU, Sequential
from ...nn.layers.common import materialize


class LeNet(nn.Module):
    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        with torch.device("meta"):
            self.features = Sequential(
                Conv2D(1, 6, 3, stride=1, padding=1), ReLU(), MaxPool2D(2, 2),
                Conv2D(6, 16, 5, stride=1, padding=0), ReLU(), MaxPool2D(2, 2))
            if num_classes > 0:
                self.fc = Sequential(Linear(400, 120), Linear(120, 84),
                                     Linear(84, num_classes))
        materialize(self, dev, seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
