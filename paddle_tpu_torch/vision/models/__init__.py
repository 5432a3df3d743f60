"""Vision models of the port (counterpart of paddle_tpu/vision/models/):
LeNet, ResNet and ResNeXt."""
from .lenet import LeNet  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet, ResNeXt, resnet18,  # noqa: F401
                     resnet34, resnet50, resnet101, resnet152, resnext50_32x4d,
                     resnext50_64x4d, resnext101_32x4d, resnext101_64x4d, resnext152_32x4d,
                     resnext152_64x4d, wide_resnet50_2, wide_resnet101_2)
