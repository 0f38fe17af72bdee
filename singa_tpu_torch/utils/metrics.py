"""Training metrics, ported from ``singa_tpu/utils/metrics.py``:
``accuracy``, ``Accuracy``, ``MeanMeter``, ``Throughput``, the card's
peak rates (``peak_flops``, ``peak_hbm_bw``), ``mfu`` and the JSONL
``MetricsLogger``."""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["Accuracy", "MeanMeter", "Throughput", "MetricsLogger",
           "accuracy", "peak_flops", "peak_hbm_bw", "mfu"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x)


def accuracy(logits, labels) -> float:
    """The share of rows whose argmax is the label (numpy arrays or
    tensors on any device)."""
    pred = np.argmax(_host(logits), axis=-1)
    return float((pred == _host(labels)).mean())


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


#: the SXM parts' names as the driver gives them, lower-cased: the PCIe
#: and NVL variants of the same chip have other rates and stay unknown
_H100_SXM = ("nvidia h100 80gb hbm3", "nvidia h100 sxm5 80gb")
_H200_SXM = ("nvidia h200",)

#: dense bf16 peaks by device name (NVIDIA's data sheets)
_PEAK_FLOPS = {**dict.fromkeys(_H100_SXM, 989e12),
               **dict.fromkeys(_H200_SXM, 989e12)}

#: memory rates in bytes/s by device name (the same data sheets)
_PEAK_BW = {**dict.fromkeys(_H100_SXM, 3.35e12),
            **dict.fromkeys(_H200_SXM, 4.8e12)}


def _peak_lookup(table, what: str, device_kind: Optional[str]) -> float:
    if device_kind is None:
        device_kind = (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu")
    try:
        return table[device_kind.strip().lower()]
    except KeyError:
        raise ValueError(f"no peak {what} known for {device_kind!r}") \
            from None


def peak_flops(device_kind: Optional[str] = None) -> float:
    """The card's dense bf16 peak FLOP/s; `device_kind` defaults to card
    0's name.  Raises for a device it does not know, since an MFU
    against a guessed peak misleads."""
    return _peak_lookup(_PEAK_FLOPS, "FLOP/s", device_kind)


def peak_hbm_bw(device_kind: Optional[str] = None) -> float:
    """The card's memory rate in bytes/s (the roofline's memory bound);
    `device_kind` defaults to card 0's name.  Raises for a device it
    does not know, as `peak_flops` does."""
    return _peak_lookup(_PEAK_BW, "memory rate", device_kind)


def mfu(model_flops_per_step: float, step_time_s: float,
        n_chips: int = 1, device_kind: Optional[str] = None) -> float:
    """Achieved model-FLOPs utilization.  model_flops must be the
    *model's* FLOPs (e.g. 6*N*T for transformers), not the captured
    graph's."""
    return model_flops_per_step / (step_time_s * peak_flops(device_kind)
                                   * n_chips)


class MetricsLogger:
    """JSONL sink: one dict per line, written through
    ``obs.events.JsonlSink`` (the telemetry layer's atomic-line,
    thread-safe writer)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        from ..obs.events import JsonlSink
        self.path = path
        self.echo = echo
        self._sink = JsonlSink(path) if path else None

    def log(self, **kv) -> None:
        # a wall-clock stamp that correlates with obs events across
        # files, not a duration
        kv.setdefault("t", time.time())
        payload = {k: _jsonable(v) for k, v in kv.items()}
        if self._sink:
            self._sink.emit(payload)
        if self.echo:
            print(json.dumps(payload))

    def close(self):
        if self._sink:
            self._sink.close()


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return float(v)
    return v

