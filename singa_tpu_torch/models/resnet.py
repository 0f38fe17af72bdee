"""ResNet, ported from ``singa_tpu/models/resnet.py``: CIFAR ResNet-18
and ImageNet ResNet-50 are the reference's headline CNN workloads
(BASELINE.json:8,10).

NHWC activations and HWIO kernels as in the reference; each layer is
given its input width at construction (``in_channels``, 3 for RGB).
"""

from __future__ import annotations

from typing import List, Optional, Type

import torch

from .. import layer
from ..device import Device
from ._base import Classifier

__all__ = ["BasicBlock", "Bottleneck", "ResNet", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152", "create_model"]


class BasicBlock(layer.Layer):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: Optional[layer.Layer] = None, *,
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
        kw = dict(device=self.device, generator=generator)
        self.conv1 = layer.Conv2d(planes, 3, in_planes, stride=stride,
                                  padding=1, bias=False, **kw)
        self.bn1 = layer.BatchNorm2d(planes, device=self.device)
        self.conv2 = layer.Conv2d(planes, 3, planes, stride=1, padding=1,
                                  bias=False, **kw)
        self.bn2 = layer.BatchNorm2d(planes, device=self.device)
        self.relu = layer.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + identity)


class Bottleneck(layer.Layer):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: Optional[layer.Layer] = None, *,
                 name: Optional[str] = None, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(name, device)
        kw = dict(device=self.device, generator=generator)
        self.conv1 = layer.Conv2d(planes, 1, in_planes, bias=False, **kw)
        self.bn1 = layer.BatchNorm2d(planes, device=self.device)
        self.conv2 = layer.Conv2d(planes, 3, planes, stride=stride, padding=1,
                                  bias=False, **kw)
        self.bn2 = layer.BatchNorm2d(planes, device=self.device)
        self.conv3 = layer.Conv2d(planes * 4, 1, planes, bias=False, **kw)
        self.bn3 = layer.BatchNorm2d(planes * 4, device=self.device)
        self.relu = layer.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + identity)


class ResNet(Classifier):
    """ResNet with the ImageNet (7x7 s2 + max-pool) or CIFAR (3x3 s1)
    stem."""

    def __init__(self, block: Type, layers: List[int],
                 num_classes: int = 1000, cifar_stem: bool = False, *,
                 in_channels: int = 3, device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        self.cifar_stem = cifar_stem
        kw = dict(device=self.device, generator=generator)
        if cifar_stem:
            self.conv1 = layer.Conv2d(64, 3, in_channels, stride=1,
                                      padding=1, bias=False, **kw)
        else:
            self.conv1 = layer.Conv2d(64, 7, in_channels, stride=2,
                                      padding=3, bias=False, **kw)
            self.maxpool = layer.MaxPool2d(3, 2, padding=1)
        self.bn1 = layer.BatchNorm2d(64, device=self.device)
        self.relu = layer.ReLU()
        self._in_planes = 64
        self.layer1 = self._make_layer(block, 64, layers[0], 1, kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw)
        self.avgpool = layer.GlobalAvgPool2d()
        self.fc = layer.Linear(num_classes, self._in_planes, **kw)

    def _make_layer(self, block, planes, blocks, stride, kw) -> layer.Layer:
        out_c = planes * block.expansion
        # a projection shortcut only where the residual's shape changes
        # (canonical ResNet: layer1 of 18/34 keeps the identity)
        ds = None
        if stride != 1 or self._in_planes != out_c:
            ds = layer.Sequential(
                layer.Conv2d(out_c, 1, self._in_planes, stride=stride,
                             bias=False, **kw),
                layer.BatchNorm2d(out_c, device=self.device))
        stages = [block(self._in_planes, planes, stride, ds, **kw)]
        stages += [block(out_c, planes, 1, None, **kw)
                   for _ in range(1, blocks)]
        self._in_planes = out_c
        return layer.Sequential(*stages)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        if not self.cifar_stem:
            x = self.maxpool(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x))


def resnet18(num_classes=10, cifar_stem=True, **kw) -> ResNet:
    """CIFAR ResNet-18 by default (the BASELINE.json:8 configuration)."""
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, cifar_stem, **kw)


def resnet34(num_classes=1000, cifar_stem=False, **kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, cifar_stem, **kw)


def resnet50(num_classes=1000, cifar_stem=False, **kw) -> ResNet:
    """ImageNet ResNet-50 (the BASELINE.json:10 workload)."""
    return ResNet(Bottleneck, [3, 4, 6, 3], num_classes, cifar_stem, **kw)


def resnet101(num_classes=1000, cifar_stem=False, **kw) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 23, 3], num_classes, cifar_stem, **kw)


def resnet152(num_classes=1000, cifar_stem=False, **kw) -> ResNet:
    return ResNet(Bottleneck, [3, 8, 36, 3], num_classes, cifar_stem, **kw)


def create_model(model_name: str = "resnet18", **kwargs) -> ResNet:
    zoo = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
           "resnet101": resnet101, "resnet152": resnet152}
    return zoo[model_name.lower()](**kwargs)
