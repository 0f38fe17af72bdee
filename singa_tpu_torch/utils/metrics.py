"""Training metrics, ported from ``singa_tpu/utils/metrics.py``:
``Accuracy``, ``MeanMeter``, ``Throughput``, and the card's peak rate
for MFU (``peak_flops``)."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

__all__ = ["Accuracy", "MeanMeter", "Throughput", "peak_flops"]


class Accuracy:
    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, logits, labels) -> None:
        pred = np.argmax(np.asarray(logits), axis=-1)
        labels = np.asarray(labels)
        self.correct += int((pred == labels).sum())
        self.total += labels.size

    @property
    def value(self) -> float:
        return self.correct / max(1, self.total)


class MeanMeter:
    def __init__(self):
        self.sum = 0.0
        self.n = 0

    def update(self, v, n: int = 1) -> None:
        self.sum += float(v) * n
        self.n += n

    @property
    def value(self) -> float:
        return self.sum / max(1, self.n)


class Throughput:
    """Items a second since the first update (or `start`)."""

    def __init__(self):
        self.t0 = None
        self.items = 0

    def start(self):
        self.t0 = time.perf_counter()
        self.items = 0

    def update(self, n: int):
        if self.t0 is None:
            self.start()
        self.items += n

    @property
    def value(self) -> float:
        if self.t0 is None:
            return 0.0
        return self.items / max(1e-9, time.perf_counter() - self.t0)


#: dense bf16 peaks by device name (NVIDIA's data sheets, SXM parts)
_PEAK_FLOPS = (("h100", 989e12), ("h200", 989e12))


def peak_flops(device_kind: Optional[str] = None) -> float:
    """The card's dense bf16 peak FLOP/s; `device_kind` defaults to card
    0's name.  Raises for a device it does not know, since an MFU
    against a guessed peak misleads."""
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    kind = device_kind.lower()
    for k, v in _PEAK_FLOPS:
        if k in kind:
            return v
    raise ValueError(f"no peak FLOP/s known for {device_kind!r}")

