"""The SINGA ``tensor`` namespace, ported from ``singa_tpu/tensor.py``.

The port keeps ``torch.Tensor`` as its tensor type: ``tensor.Tensor``
*is* ``torch.Tensor``, and there is no wrapper class.  What the
reference's constructor offered is served by the creation functions
(``zeros``, ``gaussian``, ``from_numpy``, ...).  The module functions
keep the reference's names, arguments and results:

* functions given no device use the default device
  (``device.get_default_device()``: the card, which raises without
  one); the CPU is used only when asked for
  (``dev=create_device("cpu")``);
* a creation function's dtype defaults to the device's
  (``default_float``: f32 on the CPU, bf16 on the card); a dtype may be
  a torch dtype, a numpy dtype or a ``proto.DataType``;
* random functions take ``generator=``, by default a module generator
  per torch device that ``set_seed`` seeds (seed 0 until then);
* the differentiable math goes through ``singa_tpu_torch.autograd``,
  whose functions keep the reference's semantics; ``axpy``,
  ``add_column``, ``add_row`` and ``copy_data_to_from`` write in place,
  outside autograd, as the reference rebinds a buffer;
* ``lt``/``le``/``gt``/``ge``/``eq`` give a 0/1 mask in the first
  operand's dtype and ``argmax``/``argmin`` int32 indices, as the
  reference does; ``to_numpy`` of a bf16 tensor gives f32 (numpy has no
  bf16).  Dtypes are kept as given: the reference, under jax's 32-bit
  default, narrows 64-bit arrays.

Each member of the reference's ``Tensor`` and its counterpart here
(``t`` a ``torch.Tensor``; a bare name is a function of this module):

    ================  ===================================================
    shape             t.shape
    dtype             t.dtype
    ndim              t.ndim
    size              t.numel() (torch's t.size() is the shape)
    nDim              t.dim()
    Size              t.numel()
    T                 t.T for a matrix; transpose(t) for any rank
    grad              t.grad
    device            t.device (the caller's port Device is not stored)
    requires_grad     t.requires_grad
    stores_grad       t.is_leaf and t.requires_grad (an nn.Parameter)
    creator           t.grad_fn
    name              the key of Layer.get_params(), also p.param_name
    to_device         t.to(dev.torch_device) (a new tensor, not in place)
    as_type           t.to(dtype)
    astype            t.to(dtype)
    to_numpy          to_numpy(t)
    __array__         to_numpy(t)
    numpy             to_numpy(t)
    item              t.item()
    clone             t.clone()
    detach            t.detach()
    set_value         t.fill_(x)
    gaussian          t.normal_(mean, std, generator=g); gaussian(shape)
    uniform           t.uniform_(low, high, generator=g); uniform(shape)
    bernoulli         t.bernoulli_(p, generator=g); bernoulli(shape, p)
    copy_from         copy_data_to_from(t, src)
    copy_from_numpy   copy_data_to_from(t, array)
    reshape           t.reshape(shape)
    view              t.reshape(shape) (t.view needs contiguous memory)
    transpose         transpose(t, axes); t.permute(axes)
    flatten           flatten(t, start_axis)
    squeeze           squeeze(t, axis)
    sum               sum(t, axis, keepdims); t.sum(axis, keepdim=k)
    mean              mean(t, axis, keepdims); t.mean(axis, keepdim=k)
    __add__           t + x
    __radd__          x + t
    __sub__           t - x
    __rsub__          x - t
    __mul__           t * x
    __rmul__          x * t
    __truediv__       t / x
    __rtruediv__      x / t
    __matmul__        t @ x
    __pow__           t ** p
    __neg__           -t
    __iadd__          t += x (in place; the reference rebinds)
    __isub__          t -= x
    __imul__          t *= x
    __itruediv__      t /= x
    __lt__            lt(t, x) (the operator t < x gives a bool mask)
    __le__            le(t, x)
    __gt__            gt(t, x)
    __ge__            ge(t, x)
    __getitem__       t[idx]
    __len__           len(t)
    __repr__          repr(t)
    ================  ===================================================
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import proto
from .device import Device, get_default_device

__all__ = [
    "Tensor", "from_numpy", "to_numpy", "from_raw", "zeros", "ones",
    "zeros_like", "ones_like", "full", "arange", "eye", "gaussian",
    "uniform", "bernoulli", "set_seed", "add", "sub", "mul", "div",
    "matmul", "mult", "reshape", "transpose", "flatten", "squeeze",
    "unsqueeze", "concatenate", "stack", "split", "abs", "exp", "log",
    "sqrt", "pow", "square", "sign", "tanh", "sigmoid", "relu", "sum",
    "mean", "max", "min", "argmax", "argmin", "clip", "einsum",
    "copy_data_to_from", "default_float", "sum_all",
    "softmax", "lt", "le", "gt", "ge", "eq",
    "eltwise_mult", "axpy", "add_column", "add_row", "sum_columns",
    "sum_rows", "tensordot", "batchmatmul", "repeat", "ceil", "floor",
    "round",
]

Tensor = torch.Tensor

_seed = 0
#: one generator per torch device ("cpu", "cuda:0"), made at first use
_generators: Dict[str, torch.Generator] = {}


def set_seed(seed: int) -> None:
    """Seed the module generators of every device (the draws of
    `gaussian`, `uniform` and `bernoulli` given no generator)."""
    global _seed
    _seed = int(seed)
    _generators.clear()


def _generator(dev: Device) -> torch.Generator:
    key = str(dev.torch_device)
    g = _generators.get(key)
    if g is None:
        g = _generators[key] = torch.Generator(dev.torch_device)
        g.manual_seed(_seed)
    return g


def _dev(dev: Optional[Device]) -> Device:
    return dev or get_default_device()


def default_float(dev: Optional[Device]) -> torch.dtype:
    return _dev(dev).default_dtype


def _dtype(dtype, dev: Device) -> torch.dtype:
    """A torch dtype from a torch dtype, a proto.DataType or anything
    numpy reads as a dtype; None is the device's float."""
    if dtype is None:
        return dev.default_dtype
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, proto.DataType):
        return proto.to_torch_dtype(dtype)
    dt = proto.from_np_dtype(dtype)
    if dt == proto.DataType.kUnknown:
        raise ValueError(f"no torch dtype for {dtype!r}")
    return proto.to_torch_dtype(dt)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


# ---------------------------------------------------------------------------
# conversion and creation
# ---------------------------------------------------------------------------

def from_numpy(np_array: np.ndarray, dev: Optional[Device] = None
               ) -> torch.Tensor:
    """A copy of `np_array` on `dev`."""
    return torch.tensor(np.asarray(np_array), device=_dev(dev).torch_device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (f32 for a bf16 tensor)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def from_raw(t: torch.Tensor, dev: Optional[Device] = None,
             requires_grad: bool = False) -> torch.Tensor:
    """A torch tensor on `dev` (the reference wraps a jax array)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"from_raw takes a torch.Tensor, got "
                        f"{type(t).__name__}")
    out = t.to(_dev(dev).torch_device)
    if requires_grad:
        out.requires_grad_(True)
    return out


def zeros(shape, dev=None, dtype=None) -> torch.Tensor:
    dev = _dev(dev)
    return torch.zeros(_shape(shape), dtype=_dtype(dtype, dev),
                       device=dev.torch_device)


def ones(shape, dev=None, dtype=None) -> torch.Tensor:
    dev = _dev(dev)
    return torch.ones(_shape(shape), dtype=_dtype(dtype, dev),
                      device=dev.torch_device)


def full(shape, value, dev=None, dtype=None) -> torch.Tensor:
    dev = _dev(dev)
    return torch.full(_shape(shape), value, dtype=_dtype(dtype, dev),
                      device=dev.torch_device)


def zeros_like(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(t)


def ones_like(t: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(t)


def arange(start, stop=None, step=1, dev=None, dtype=None) -> torch.Tensor:
    """``jnp.arange``: int32 for integer arguments, else the default
    float, unless `dtype` says otherwise."""
    dev = _dev(dev)
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, stop, step))
        dtype = torch.int32 if ints else torch.float32
    return torch.arange(start, stop, step, dtype=_dtype(dtype, dev),
                        device=dev.torch_device)


def eye(n, dev=None, dtype=None) -> torch.Tensor:
    dev = _dev(dev)
    return torch.eye(n, dtype=_dtype(dtype, dev), device=dev.torch_device)


def gaussian(shape, mean=0.0, std=1.0, dev=None, dtype=None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Normal draws in f32, cast to `dtype` (as the reference)."""
    dev = _dev(dev)
    g = generator if generator is not None else _generator(dev)
    x = torch.randn(_shape(shape), generator=g, dtype=torch.float32,
                    device=dev.torch_device)
    return (mean + std * x).to(_dtype(dtype, dev))


def uniform(shape, low=0.0, high=1.0, dev=None, dtype=None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    dev = _dev(dev)
    g = generator if generator is not None else _generator(dev)
    x = torch.rand(_shape(shape), generator=g, dtype=torch.float32,
                   device=dev.torch_device)
    return (low + (high - low) * x).to(_dtype(dtype, dev))


def bernoulli(shape, p, dev=None, dtype=None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """1 with probability `p`: a uniform draw below `p`."""
    dev = _dev(dev)
    g = generator if generator is not None else _generator(dev)
    x = torch.rand(_shape(shape), generator=g, dtype=torch.float32,
                   device=dev.torch_device)
    return (x < p).to(_dtype(dtype, dev))


def copy_data_to_from(dst: torch.Tensor, src, size: Optional[int] = None
                      ) -> None:
    """Copy `src` (a tensor or an array, reshaped to `dst`'s shape and
    cast to its dtype) into `dst` in place.  `size` is the reference's
    argument, which it ignores too: the whole tensor is copied."""
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(np.asarray(src))
    with torch.no_grad():
        dst.copy_(src.reshape(dst.shape))


# ---------------------------------------------------------------------------
# math: the differentiable functions go through autograd
# ---------------------------------------------------------------------------

def _ag():
    from . import autograd
    return autograd


def add(a, b):
    return _ag().add(a, b)


def sub(a, b):
    return _ag().sub(a, b)


def mul(a, b):
    return _ag().mul(a, b)


def mult(a, b):
    """The reference's `tensor.mult` is MATRIX multiplication
    (GEMM/GEMV); the elementwise product is `eltwise_mult`."""
    return _ag().matmul(a, b)


def eltwise_mult(a, b):
    return _ag().mul(a, b)


def axpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y += alpha * x in place; returns y.  BLAS semantics: the shapes
    must match exactly."""
    if tuple(x.shape) != tuple(y.shape):
        raise ValueError(f"axpy shape mismatch: x {tuple(x.shape)} vs y "
                         f"{tuple(y.shape)}")
    with torch.no_grad():
        y.add_(x.to(y.dtype), alpha=alpha)
    return y


def add_column(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Add column vector v to every column of matrix m (in place)."""
    if m.dim() != 2 or v.numel() != m.shape[0]:
        raise ValueError(f"add_column needs v of length rows(m): v "
                         f"{tuple(v.shape)}, m {tuple(m.shape)}")
    with torch.no_grad():
        m.add_(v.reshape(-1, 1).to(m.dtype))
    return m


def add_row(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Add row vector v to every row of matrix m (in place)."""
    if m.dim() != 2 or v.numel() != m.shape[1]:
        raise ValueError(f"add_row needs v of length cols(m): v "
                         f"{tuple(v.shape)}, m {tuple(m.shape)}")
    with torch.no_grad():
        m.add_(v.reshape(1, -1).to(m.dtype))
    return m


def sum_columns(m):
    """Sum over columns: (r, c) -> (r,)."""
    return _ag().reduce_sum(m, axis=1)


def sum_rows(m):
    """Sum over rows: (r, c) -> (c,)."""
    return _ag().reduce_sum(m, axis=0)


def tensordot(a, b, axes=2):
    return _ag().tensordot(a, b, axes)


def batchmatmul(a, b):
    """Batched matmul over the leading dims (the reference's name)."""
    return _ag().matmul(a, b)


def repeat(t, repeats, axis=None):
    return _ag().repeat(t, repeats, axis)


def ceil(t):
    return _ag().ceil(t)


def floor(t):
    return _ag().floor(t)


def round(t):  # noqa: A001 - reference op name
    return _ag().round(t)


def div(a, b):
    return _ag().div(a, b)


def matmul(a, b):
    return _ag().matmul(a, b)


def einsum(subscripts, *ts):
    return _ag().einsum(subscripts, *ts)


def reshape(t, shape):
    return _ag().reshape(t, shape)


def transpose(t, axes=None):
    return _ag().transpose(t, axes)


def flatten(t, start_axis=0):
    return _ag().flatten(t, start_axis)


def squeeze(t, axis=None):
    return _ag().squeeze(t, axis)


def unsqueeze(t, axis):
    return _ag().unsqueeze(t, axis)


def concatenate(ts, axis=0):
    return _ag().cat(ts, axis)


def stack(ts, axis=0):
    return _ag().stack(ts, axis)


def split(t, parts, axis=0):
    return _ag().split(t, parts, axis)


def abs(t):  # noqa: A001
    return _ag().abs(t)


def exp(t):
    return _ag().exp(t)


def log(t):
    return _ag().log(t)


def sqrt(t):
    return _ag().sqrt(t)


def square(t):
    return _ag().mul(t, t)


def pow(t, p):  # noqa: A001
    return _ag().pow(t, p)


def sign(t):
    return torch.sign(t.detach())


def tanh(t):
    return _ag().tanh(t)


def sigmoid(t):
    return _ag().sigmoid(t)


def relu(t):
    return _ag().relu(t)


def softmax(t, axis=-1):
    return _ag().softmax(t, axis)


def sum(t, axis=None, keepdims=False):  # noqa: A001
    return _ag().reduce_sum(t, axis, keepdims)


def sum_all(t) -> float:
    return float(t.detach().sum())


def mean(t, axis=None, keepdims=False):
    return _ag().reduce_mean(t, axis, keepdims)


def max(t, axis=None, keepdims=False):  # noqa: A001
    return _ag().reduce_max(t, axis, keepdims)


def min(t, axis=None, keepdims=False):  # noqa: A001
    return _ag().reduce_min(t, axis, keepdims)


def argmax(t, axis=-1):
    return torch.argmax(t.detach(), dim=axis).to(torch.int32)


def argmin(t, axis=-1):
    return torch.argmin(t.detach(), dim=axis).to(torch.int32)


def clip(t, lo, hi):
    return _ag().clip(t, lo, hi)


def _mask(op, a, b):
    """A 0/1 mask in a's dtype, outside autograd (the reference's
    comparisons)."""
    if isinstance(b, torch.Tensor):
        b = b.detach()
    return op(a.detach(), b).to(a.dtype)


def lt(a, b):
    return _mask(torch.lt, a, b)


def le(a, b):
    return _mask(torch.le, a, b)


def gt(a, b):
    return _mask(torch.gt, a, b)


def ge(a, b):
    return _mask(torch.ge, a, b)


def eq(a, b):
    return _mask(torch.eq, a, b)
