"""Vision of the port (counterpart of paddle_tpu/vision/): the models
(LeNet, ResNet, ResNeXt), the datasets (MNIST, FashionMNIST, Cifar10,
Cifar100, DatasetFolder, ImageFolder, Flowers, VOC2012) and the numpy
transforms. The vision ops are not ported (ROADMAP.md Queue 1 item 11)."""
from . import datasets, models, transforms  # noqa: F401
