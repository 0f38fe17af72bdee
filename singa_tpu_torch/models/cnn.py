"""The small CNNs of the reference's examples/cnn, ported from
``singa_tpu/models/cnn.py`` (BASELINE.json:7-8).

NHWC throughout (``data_format="NCHW"`` for NCHW inputs).  Each model
flattens its last feature map into ``fc1``, whose width depends on the
image: the port builds widths at construction, so these models take the
image's ``input_shape=(H, W, C)`` (as the examples' ``dataset_arrays``
gives it).  An NHWC map flattens in (H, W, C) order, as in the
reference, so a carried ``fc1.W`` reads the same features.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import layer
from ..device import Device
from ._base import Classifier

__all__ = ["CNN", "LeNet5", "AlexNet", "create_model"]


def _out(n: int, k: int, s: int = 1, p: int = 0) -> int:
    """Spatial size after a window of k, stride s, padding p."""
    return (n + 2 * p - k) // s + 1


class CNN(Classifier):
    """The reference's simple MNIST CNN: two conv+pool blocks and two
    fully connected layers."""

    def __init__(self, num_classes: int = 10, data_format: str = "NHWC", *,
                 input_shape: Sequence[int] = (28, 28, 1),
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        df, kw = data_format, dict(device=self.device, generator=generator)
        h, w, c = input_shape
        self.conv1 = layer.Conv2d(32, 3, c, stride=1, padding=1,
                                  data_format=df, **kw)
        self.relu1 = layer.ReLU()
        self.pool1 = layer.MaxPool2d(2, 2, data_format=df)
        self.conv2 = layer.Conv2d(64, 3, 32, stride=1, padding=1,
                                  data_format=df, **kw)
        self.relu2 = layer.ReLU()
        self.pool2 = layer.MaxPool2d(2, 2, data_format=df)
        self.flat = layer.Flatten()
        flat = _out(_out(h, 2, 2), 2, 2) * _out(_out(w, 2, 2), 2, 2) * 64
        self.fc1 = layer.Linear(128, flat, **kw)
        self.relu3 = layer.ReLU()
        self.fc2 = layer.Linear(num_classes, 128, **kw)

    def forward(self, x):
        x = self.pool1(self.relu1(self.conv1(x)))
        x = self.pool2(self.relu2(self.conv2(x)))
        x = self.relu3(self.fc1(self.flat(x)))
        return self.fc2(x)


class LeNet5(Classifier):
    def __init__(self, num_classes: int = 10, data_format: str = "NHWC", *,
                 input_shape: Sequence[int] = (28, 28, 1),
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        df, kw = data_format, dict(device=self.device, generator=generator)
        h, w, c = input_shape
        self.conv1 = layer.Conv2d(6, 5, c, padding=2, data_format=df, **kw)
        self.pool1 = layer.AvgPool2d(2, 2, data_format=df)
        self.conv2 = layer.Conv2d(16, 5, 6, data_format=df, **kw)
        self.pool2 = layer.AvgPool2d(2, 2, data_format=df)
        self.act = layer.Tanh()
        self.flat = layer.Flatten()

        def side(n):
            return _out(_out(_out(_out(n, 5, 1, 2), 2, 2), 5), 2, 2)
        self.fc1 = layer.Linear(120, side(h) * side(w) * 16, **kw)
        self.fc2 = layer.Linear(84, 120, **kw)
        self.head = layer.Linear(num_classes, 84, **kw)

    def forward(self, x):
        x = self.pool1(self.act(self.conv1(x)))
        x = self.pool2(self.act(self.conv2(x)))
        x = self.flat(x)
        x = self.act(self.fc1(x))
        x = self.act(self.fc2(x))
        return self.head(x)


class AlexNet(Classifier):
    """AlexNet sized for 224x224 inputs (the reference's examples/cnn
    alexnet)."""

    def __init__(self, num_classes: int = 1000, data_format: str = "NHWC",
                 dropout: float = 0.5, *,
                 input_shape: Sequence[int] = (224, 224, 3),
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        df, kw = data_format, dict(device=self.device, generator=generator)
        h, w, c = input_shape
        self.features = layer.Sequential(
            layer.Conv2d(64, 11, c, stride=4, padding=2, data_format=df, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, 2, data_format=df),
            layer.Conv2d(192, 5, 64, padding=2, data_format=df, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, 2, data_format=df),
            layer.Conv2d(384, 3, 192, padding=1, data_format=df, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, 384, padding=1, data_format=df, **kw),
            layer.ReLU(),
            layer.Conv2d(256, 3, 256, padding=1, data_format=df, **kw),
            layer.ReLU(),
            layer.MaxPool2d(3, 2, data_format=df),
        )

        def side(n):
            n = _out(_out(n, 11, 4, 2), 3, 2)
            return _out(_out(n, 3, 2), 3, 2)
        self.flat = layer.Flatten()
        self.drop1 = layer.Dropout(dropout, device=self.device)
        self.fc1 = layer.Linear(4096, side(h) * side(w) * 256, **kw)
        self.relu1 = layer.ReLU()
        self.drop2 = layer.Dropout(dropout, device=self.device)
        self.fc2 = layer.Linear(4096, 4096, **kw)
        self.relu2 = layer.ReLU()
        self.head = layer.Linear(num_classes, 4096, **kw)

    def forward(self, x):
        x = self.flat(self.features(x))
        x = self.relu1(self.fc1(self.drop1(x)))
        x = self.relu2(self.fc2(self.drop2(x)))
        return self.head(x)


def create_model(model_name: str = "cnn", **kwargs):
    """The reference's factory (examples/cnn model selection)."""
    zoo = {"cnn": CNN, "lenet": LeNet5, "alexnet": AlexNet}
    return zoo[model_name.lower()](**kwargs)
