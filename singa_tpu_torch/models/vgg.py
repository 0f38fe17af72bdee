"""VGG, ported from ``singa_tpu/models/vgg.py``: the reference's CIFAR
alternative backbone (BASELINE.json:8)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .. import layer
from ..device import Device
from ._base import Classifier

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "create_model"]

_CFGS = {
    "vgg11": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "vgg13": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M",
              512, 512, "M"],
    "vgg16": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
              "M", 512, 512, 512, "M"],
    "vgg19": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
              512, 512, "M", 512, 512, 512, 512, "M"],
}


class VGG(Classifier):
    def __init__(self, cfg: List[Union[int, str]], num_classes: int = 10,
                 batch_norm: bool = True, *, in_channels: int = 3,
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        kw = dict(device=self.device, generator=generator)
        blocks, width = [], in_channels
        for v in cfg:
            if v == "M":
                blocks.append(layer.MaxPool2d(2, 2))
                continue
            blocks.append(layer.Conv2d(v, 3, width, padding=1,
                                       bias=not batch_norm, **kw))
            if batch_norm:
                blocks.append(layer.BatchNorm2d(v, device=self.device))
            blocks.append(layer.ReLU())
            width = v
        self.features = layer.Sequential(*blocks)
        self.pool = layer.GlobalAvgPool2d()
        self.head = layer.Linear(num_classes, width, **kw)

    def forward(self, x):
        return self.head(self.pool(self.features(x)))


def vgg11(num_classes=10, batch_norm=True, **kw) -> VGG:
    return VGG(_CFGS["vgg11"], num_classes, batch_norm, **kw)


def vgg13(num_classes=10, batch_norm=True, **kw) -> VGG:
    return VGG(_CFGS["vgg13"], num_classes, batch_norm, **kw)


def vgg16(num_classes=10, batch_norm=True, **kw) -> VGG:
    return VGG(_CFGS["vgg16"], num_classes, batch_norm, **kw)


def vgg19(num_classes=10, batch_norm=True, **kw) -> VGG:
    return VGG(_CFGS["vgg19"], num_classes, batch_norm, **kw)


def create_model(model_name: str = "vgg16", **kwargs) -> VGG:
    return VGG(_CFGS[model_name.lower()], **kwargs)
