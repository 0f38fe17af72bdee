"""The SINGA dtype and device enums, ported from ``singa_tpu/proto.py``.

The lineage serialises dtype and device kinds as protobuf enums; this
module keeps their *numbers* (so serialised configs interoperate with
the JAX package's) as plain IntEnums, with converters to numpy dtypes
and, in the port, to torch dtypes.

``kBfloat16`` has no numpy dtype here: numpy has none without
``ml_dtypes``, which the port does not use.  ``to_np_dtype(kBfloat16)``
raises and names ``to_torch_dtype``; ``from_np_dtype`` still reads a
bf16 numpy dtype (``ml_dtypes.bfloat16``, as the JAX package hands out)
by its name.  Every other number maps as in the reference.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

__all__ = ["DataType", "DeviceType", "LangType", "to_np_dtype",
           "from_np_dtype", "to_torch_dtype", "from_torch_dtype"]


class DataType(enum.IntEnum):
    """The lineage's core.proto DataType numbering; kBfloat16 is
    appended, so the older numbers are stable."""

    kFloat32 = 0
    kFloat16 = 1
    kInt = 2
    kChar = 3
    kDouble = 4
    kUChar = 5
    kBfloat16 = 6
    kInt64 = 7
    kUnknown = 10


class DeviceType(enum.IntEnum):
    """The lineage's device kinds; the port's card is kCuda."""

    kCpp = 0
    kCuda = 1
    kOpencl = 2
    kTpu = 3


class LangType(enum.IntEnum):
    """The kernel-language tag of device ops; the port's hand-written
    kernels are kCuda."""

    kCpp = 0
    kCuda = 1
    kOpencl = 2
    kXla = 3


_TO_NP = {
    DataType.kFloat32: np.dtype(np.float32),
    DataType.kFloat16: np.dtype(np.float16),
    DataType.kInt: np.dtype(np.int32),
    DataType.kChar: np.dtype(np.int8),
    DataType.kDouble: np.dtype(np.float64),
    DataType.kUChar: np.dtype(np.uint8),
    DataType.kInt64: np.dtype(np.int64),
}
_FROM_NP = {v: k for k, v in _TO_NP.items()}

_TO_TORCH = {
    DataType.kFloat32: torch.float32,
    DataType.kFloat16: torch.float16,
    DataType.kInt: torch.int32,
    DataType.kChar: torch.int8,
    DataType.kDouble: torch.float64,
    DataType.kUChar: torch.uint8,
    DataType.kBfloat16: torch.bfloat16,
    DataType.kInt64: torch.int64,
}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}


def to_np_dtype(dt: DataType) -> np.dtype:
    try:
        return _TO_NP[DataType(dt)]
    except KeyError:
        hint = ("; numpy has no bfloat16 without ml_dtypes, use "
                "to_torch_dtype" if dt == DataType.kBfloat16 else "")
        raise ValueError(f"no numpy dtype for {dt!r}{hint}") from None


def from_np_dtype(dtype) -> DataType:
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":
        return DataType.kBfloat16
    return _FROM_NP.get(dtype, DataType.kUnknown)


def to_torch_dtype(dt: DataType) -> torch.dtype:
    try:
        return _TO_TORCH[DataType(dt)]
    except KeyError:
        raise ValueError(f"no torch dtype for {dt!r}") from None


def from_torch_dtype(dtype: torch.dtype) -> DataType:
    return _FROM_TORCH.get(dtype, DataType.kUnknown)
