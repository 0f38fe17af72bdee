"""MLP, ported from ``singa_tpu/models/mlp.py``: the reference's smoke
workload (examples/mlp, BASELINE.json:7)."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .. import autograd, layer
from ..device import Device
from ._base import Classifier

__all__ = ["MLP", "create_model"]


class MLP(Classifier):
    """Stacked Linear + ReLU layers and a linear head over inputs of
    `input_shape` (flattened when they have more than one axis)."""

    def __init__(self, perceptron_size: Sequence[int] = (100,),
                 num_classes: int = 10, *,
                 input_shape: Sequence[int] = (28, 28, 1),
                 device: Optional[Device] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(device=device)
        if isinstance(perceptron_size, int):
            perceptron_size = (perceptron_size,)
        kw = dict(device=self.device, generator=generator)
        widths = [math.prod(input_shape), *perceptron_size]
        self.hidden = nn.ModuleList(layer.Linear(o, i, **kw)
                                    for i, o in zip(widths, widths[1:]))
        self.acts = nn.ModuleList(layer.ReLU() for _ in perceptron_size)
        self.head = layer.Linear(num_classes, widths[-1], **kw)
        self.num_classes = num_classes

    def forward(self, x):
        if x.dim() > 2:
            x = autograd.flatten(x, 1)
        for fc, act in zip(self.hidden, self.acts):
            x = act(fc(x))
        return self.head(x)


def create_model(pretrained: bool = False, **kwargs) -> MLP:
    """The reference's factory signature (examples/mlp)."""
    return MLP(**kwargs)
