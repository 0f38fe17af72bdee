"""Model base, ported from ``singa_tpu/model.py``: the train/eval flags
(``nn.Module.train``/``eval``) and ``model_device``.  Graph capture and
the step executor come with the training slice."""

from __future__ import annotations

from .device import Device, get_default_device
from .layer import Layer

__all__ = ["Model", "model_device"]


class Model(Layer):
    """Base model: a ``Layer`` whose train/eval flags are ``nn.Module``'s."""


def model_device(model) -> Device:
    """The port ``Device`` a model's parameters live on."""
    dev = getattr(model, "device", None)
    if isinstance(dev, Device):
        return dev
    return get_default_device()
