"""Device layer: CppCPU (torch CPU) and CudaDevice (one NVIDIA card),
the port of ``singa_tpu/device.py``.

Each device carries the torch device it places tensors on, a default
floating dtype (f32 on the CPU, bf16 on the card, as the reference's
TpuDevice keeps bf16 activations) and a ``torch.Generator`` seeded by
``SetRandSeed``.

Unlike the reference, ``create_device("auto")`` never falls back to the
CPU: without a card it raises.  The CPU is used only when the caller
asks for it with ``create_device("cpu")``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "Device",
    "CppCPU",
    "CudaDevice",
    "create_device",
    "get_default_device",
    "set_default_device",
]


class Device:
    """Base device: a torch device, a default dtype and a generator."""

    def __init__(self, name: str, torch_device: torch.device,
                 default_dtype: torch.dtype):
        self.name = name
        self.torch_device = torch.device(torch_device)
        self.default_dtype = default_dtype
        self.generator = torch.Generator(self.torch_device)

    # -- reference-API surface ------------------------------------------------
    def SetRandSeed(self, seed: int) -> None:  # noqa: N802 (reference casing)
        self.generator.manual_seed(int(seed))

    def Sync(self) -> None:  # noqa: N802
        """Block until all queued work on this device is complete."""
        if self.torch_device.type == "cuda":
            torch.cuda.synchronize(self.torch_device)

    def memory_stats(self) -> dict:
        if self.torch_device.type == "cuda":
            return dict(torch.cuda.memory_stats(self.torch_device))
        return {}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} name={self.name} " \
               f"torch_device={self.torch_device}>"


class CppCPU(Device):
    """Host CPU device (f32 default dtype) — the device the tests use."""

    def __init__(self):
        super().__init__("CppCPU", torch.device("cpu"), torch.float32)


class CudaDevice(Device):
    """One NVIDIA card, the counterpart of the reference's TpuDevice:
    activations run bf16 by default."""

    def __init__(self, id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible to torch; pass "
                "create_device('cpu') to run on the host")
        n = torch.cuda.device_count()
        if not 0 <= id < n:
            raise ValueError(f"cuda device id {id} out of range (0..{n - 1})")
        super().__init__(f"CUDA:{id}", torch.device("cuda", id),
                         torch.bfloat16)


_default_device: Optional[Device] = None


def create_device(kind: str = "auto", id: int = 0) -> Device:
    """kind: 'auto' | 'cuda' | 'gpu' | 'cpu'.  'auto' is the card and
    raises when there is none (no silent fall back to the CPU)."""
    kind = kind.lower()
    if kind in ("auto", "cuda", "gpu"):
        return CudaDevice(id)
    if kind in ("cpu", "cppcpu"):
        return CppCPU()
    raise ValueError(f"unknown device kind: {kind!r}")


def get_default_device() -> Device:
    global _default_device
    if _default_device is None:
        _default_device = create_device("auto")
    return _default_device


def set_default_device(dev: Optional[Device]) -> None:
    global _default_device
    _default_device = dev
