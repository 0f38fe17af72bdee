"""Device layer: CppCPU (torch CPU) and CudaDevice (one NVIDIA card),
the port of ``singa_tpu/device.py``.

Each device carries the torch device it places tensors on, a default
floating dtype (f32 on the CPU, bf16 on the card, as the reference's
TpuDevice keeps bf16 activations) and a ``torch.Generator`` seeded by
``SetRandSeed``.

Unlike the reference, ``create_device("auto")`` never falls back to the
CPU: without a card it raises.  The CPU is used only when the caller
asks for it with ``create_device("cpu")``.

``CppCPU(use_native=True)`` (``create_cpu_device(use_native=True)``)
routes the reference's nine native ops (``autograd``'s add, mul,
matmul, linear, relu, sigmoid, tanh, softmax and conv2d) on f32 CPU
tensors through the host kernels of ``_core`` while it is the default
device; `native_cpu` says whether it is.  It builds the library when
made and raises when the library cannot be built.  Unlike the
reference, ``use_native`` defaults to False: the port's CPU contracts
are held over torch's CPU kernels.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = [
    "Device",
    "CppCPU",
    "CudaDevice",
    "Platform",
    "create_device",
    "create_cpu_device",
    "create_cuda_device",
    "get_default_device",
    "set_default_device",
    "native_cpu",
    "enable_lazy_alloc",
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
    """Host CPU device (f32 default dtype) — the device the tests use.
    With `use_native` the host kernels of ``_core`` take the native ops
    while it is the default device; the library is built here, and a
    failed build raises."""

    def __init__(self, use_native: bool = False):
        super().__init__("CppCPU", torch.device("cpu"), torch.float32)
        if use_native:
            from . import _core
            _core.lib()
        self.use_native = bool(use_native)


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


class Platform:
    """Static queries over the visible cards (reference:
    singa::Platform), over ``torch.cuda``."""

    @staticmethod
    def GetNumGPUs() -> int:  # noqa: N802 (reference casing)
        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    @staticmethod
    def CreateCudaDevices(num: int) -> List["CudaDevice"]:  # noqa: N802
        return [CudaDevice(i) for i in range(num)]

    @staticmethod
    def DeviceQuery() -> str:  # noqa: N802
        lines = []
        for i in range(Platform.GetNumGPUs()):
            p = torch.cuda.get_device_properties(i)
            lines.append(f"{i}: platform=cuda kind={p.name} "
                         f"capability={p.major}.{p.minor} "
                         f"memory={p.total_memory}")
        return "\n".join(lines)


_default_device: Optional[Device] = None
#: whether the default device is a CppCPU with use_native: the one
#: module global the native dispatch in ``autograd`` reads
_native_cpu = False


def create_cpu_device(use_native: bool = False) -> CppCPU:
    return CppCPU(use_native=use_native)


def create_cuda_device(id: int = 0) -> CudaDevice:
    """The card `id` (the counterpart of the reference's
    create_tpu_device)."""
    return CudaDevice(id)


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
    global _default_device, _native_cpu
    _default_device = dev
    _native_cpu = isinstance(dev, CppCPU) and dev.use_native


def native_cpu() -> bool:
    """True when the device set by `set_default_device` is a CppCPU with
    use_native (never makes a default device)."""
    return _native_cpu


def enable_lazy_alloc(flag: bool) -> None:
    """Reference-API no-op: torch's caching allocator owns allocation."""
    del flag
