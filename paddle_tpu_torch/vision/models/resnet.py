"""ResNet and ResNeXt, the BASELINE config-2 models (counterpart of
paddle_tpu/vision/models/resnet.py): the same modules, parameter and buffer
names and arithmetic as the JAX models, so a state dict carries over by
name (models/convert.py transposes the ``fc`` weight).

The models and factories take ``device`` (the card unless ``device="cpu"``
is asked for) and ``seed``: the model is built on meta, its weights drawn
from ``seed`` (the JAX layers' distributions), then moved, as
``GPTForPretraining`` is. Convolutions, pools and batch norm are PyTorch's
calls (cuDNN on the card), as the JAX package runs them through XLA.
"""
from __future__ import annotations

import torch
from torch import nn

from ...device import resolve_device
from ...nn.layers import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear, MaxPool2D, ReLU,
                          Sequential)
from ...nn.layers.common import materialize


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        self.conv1 = Conv2D(inplanes, planes, 3, padding=1, stride=stride, bias_attr=False)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None):
        super().__init__()
        norm_layer = norm_layer or BatchNorm2D
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False)
        self.bn1 = norm_layer(width)
        self.conv2 = Conv2D(width, width, 3, padding=dilation, stride=stride,
                            groups=groups, dilation=dilation, bias_attr=False)
        self.bn2 = norm_layer(width)
        self.conv3 = Conv2D(width, planes * self.expansion, 1, bias_attr=False)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """``forward(x)`` [b, 3, H, W] -> logits [b, num_classes] (the pooled
    features with ``num_classes=0``). Starts in training mode."""

    def __init__(self, block, depth=50, width=64, num_classes=1000, with_pool=True,
                 groups=1, device=None, seed=0):
        super().__init__()
        dev = resolve_device(device)
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        with torch.device("meta"):
            self.conv1 = Conv2D(3, self.inplanes, kernel_size=7, stride=2, padding=3,
                                bias_attr=False)
            self.bn1 = self._norm_layer(self.inplanes)
            self.relu = ReLU()
            self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
            self.layer1 = self._make_layer(block, 64, layers[0])
            self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
            self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
            self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
            if with_pool:
                self.avgpool = AdaptiveAvgPool2D((1, 1))
            if num_classes > 0:
                self.fc = Linear(512 * block.expansion, num_classes)
        materialize(self, dev, seed)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1, stride=stride,
                       bias_attr=False),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, self.groups,
                        self.base_width, self.dilation, norm_layer)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, norm_layer=norm_layer))
        return Sequential(*layers)

    @property
    def device(self) -> torch.device:
        return self.conv1.weight.device

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled: load a state with "
                         "models/convert.py or paddle_tpu_torch.load")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 64 * 2
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


class ResNeXt(ResNet):
    """Aggregated residual transformations: ResNet bottlenecks with grouped
    3x3 convolutions (``cardinality`` groups of ``base_width`` channels)."""

    def __init__(self, depth=50, cardinality=32, base_width=4, num_classes=1000,
                 with_pool=True, device=None, seed=0):
        super().__init__(BottleneckBlock, depth, width=base_width, num_classes=num_classes,
                         with_pool=with_pool, groups=cardinality, device=device, seed=seed)


def _resnext(depth, cardinality, base_width, pretrained=False, **kwargs):
    if pretrained:
        raise ValueError("pretrained weights are not bundled: load a state with "
                         "models/convert.py or paddle_tpu_torch.load")
    return ResNeXt(depth, cardinality, base_width, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)
