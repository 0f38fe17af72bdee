"""The host runtime, ported from ``singa_tpu/_core/__init__.py``: a
``ctypes`` binding of the port's copy of the C++ core
(``singa_tpu_torch/csrc/core``, built by ``_build.build_core`` at first
use into ``build/singa_tpu_torch/``).

Four parts share one C API:

  * ``tensor_math_cpp``: host f32 kernels (`gemm`, the elementwise ops,
    the activations, `softmax`, `array_sum`, `conv2d_nhwc`,
    `sgd_update`), the kernels of ``device.CppCPU(use_native=True)``;
  * ``scheduler``: `NativeGraph`, a topological order and a first-fit
    arena plan by liveness (``graph.CapturedGraph.schedule``);
  * ``dataloader``: `NativeLoader`, worker threads that assemble
    shuffled batches into a bounded ring (``utils.data.DataLoader``);
  * ``allocator``: a size-bucketed host pool (`pool_alloc`, ...).

The wrappers take numpy arrays or CPU tensors and return the same kind;
a contiguous f32 tensor is passed by its ``data_ptr()``, without a copy.
The reference's CPython extension is not ported: its one reason is a
zero-copy call, which ``data_ptr()`` gives.

Where the reference's ``lib()`` returns None and its callers drop to
jnp, here whatever asks for the library raises when it cannot be built
or loaded (`lib`, `NativeGraph`, `NativeLoader`, every wrapper);
`available` is the query.  Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes as C
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["lib", "built", "available", "version", "omp_max_threads",
           "stats", "reset_stats", "gemm", "add", "sub", "mul", "div", "relu",
           "sigmoid", "tanh", "exp",
           "relu_grad", "softmax", "array_sum", "conv2d_nhwc", "sgd_update",
           "NativeGraph", "NativeLoader", "pool_alloc", "pool_free",
           "pool_bytes_in_use", "pool_bytes_reserved", "pool_trim"]

_built = None                       # the loaded library (_build.Built)
_error: Optional[str] = None        # why the last build or load failed
_lock = threading.Lock()


def built():
    """The library as it was built and loaded (``_build.Built``: the
    CDLL, its path, the compile seconds of this process's build, 0.0
    when it was already on disk, and the compiler's log); builds it at
    first use.  Raises RuntimeError (with the compiler's log) when it
    cannot be built or loaded.  A failure is remembered: later calls
    raise it again without rebuilding."""
    global _built, _error
    with _lock:
        if _built is not None:
            return _built
        if _error is not None:
            raise RuntimeError(f"native core unavailable: {_error}")
        from .. import _build
        try:
            b = _build.build_core()
            _declare(b.lib)
        except (OSError, AttributeError, RuntimeError,
                subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            raise RuntimeError(f"native core unavailable: {_error}") from e
        _built = b
        return _built


def lib() -> C.CDLL:
    """The loaded library (`built`'s), built from the sources at first
    use; raises as `built` does."""
    return built().lib


def available() -> bool:
    """Whether the library builds and loads here (builds it at first
    call)."""
    try:
        lib()
    except RuntimeError:
        return False
    return True


i64 = C.c_int64
vp = C.c_void_p


def _declare(l: C.CDLL) -> None:
    """Every entry point's argument and result types.  Pointers are
    ``c_void_p``: the wrappers pass numpy arrays' and tensors' addresses
    after checking dtype and contiguity themselves."""
    l.sg_version.restype = C.c_char_p
    l.sg_version.argtypes = []
    l.sg_gemm.restype = None
    l.sg_gemm.argtypes = [vp, vp, vp, i64, i64, i64, C.c_int, C.c_int,
                          C.c_float, C.c_float]
    for name in ("sg_add", "sg_sub", "sg_mul", "sg_div", "sg_relu_grad"):
        getattr(l, name).restype = None
        getattr(l, name).argtypes = [vp, vp, vp, i64]
    for name in ("sg_relu", "sg_sigmoid", "sg_tanh", "sg_exp", "sg_sum"):
        getattr(l, name).restype = None
        getattr(l, name).argtypes = [vp, vp, i64]
    l.sg_softmax.restype = None
    l.sg_softmax.argtypes = [vp, vp, i64, i64]
    l.sg_axpy.restype = None
    l.sg_axpy.argtypes = [C.c_float, vp, vp, i64]
    l.sg_scale.restype = None
    l.sg_scale.argtypes = [C.c_float, vp, i64]
    l.sg_conv2d_nhwc.restype = None
    l.sg_conv2d_nhwc.argtypes = [vp, vp, vp] + [i64] * 11
    l.sg_sgd_update.restype = None
    l.sg_sgd_update.argtypes = [vp, vp, vp, C.c_float, C.c_float,
                                C.c_float, i64]
    l.sg_graph_new.restype = i64
    l.sg_graph_new.argtypes = []
    l.sg_graph_free.restype = None
    l.sg_graph_free.argtypes = [i64]
    l.sg_graph_add_node.restype = i64
    l.sg_graph_add_node.argtypes = [i64, C.c_char_p, vp, i64, vp, i64, vp,
                                    i64]
    for name in ("sg_graph_toposort", "sg_graph_plan_memory"):
        getattr(l, name).restype = i64
        getattr(l, name).argtypes = [i64, vp, i64]
    for name in ("sg_graph_num_nodes", "sg_graph_total_flops",
                 "sg_loader_batches_per_epoch"):
        getattr(l, name).restype = i64
        getattr(l, name).argtypes = [i64]
    l.sg_loader_new.restype = i64
    l.sg_loader_new.argtypes = [vp, vp, i64, i64, i64, C.c_int, C.c_uint64,
                                C.c_int, C.c_int, C.c_int]
    l.sg_loader_next.restype = i64
    l.sg_loader_next.argtypes = [i64, vp, vp]
    l.sg_loader_free.restype = None
    l.sg_loader_free.argtypes = [i64]
    l.sg_pool_alloc.restype = vp
    l.sg_pool_alloc.argtypes = [C.c_size_t]
    l.sg_pool_free.restype = None
    l.sg_pool_free.argtypes = [vp]
    for name in ("sg_pool_bytes_in_use", "sg_pool_bytes_reserved"):
        getattr(l, name).restype = C.c_size_t
        getattr(l, name).argtypes = []
    l.sg_pool_trim.restype = None
    l.sg_pool_trim.argtypes = []


def version() -> str:
    return lib().sg_version().decode()


def omp_max_threads() -> int:
    """The OpenMP thread count of the runtime the library's kernels run
    on.  In a torch process that is torch's own libgomp: it carries the
    soname (libgomp.so.1) the library links, so the loader binds the
    library to it and one OpenMP runtime serves both."""
    lib()
    return int(C.CDLL("libgomp.so.1").omp_get_max_threads())


# ---------------------------------------------------------------------------
# tensor_math_cpp: wrappers over numpy arrays and CPU tensors
# ---------------------------------------------------------------------------

# dispatch instrumentation: counts PUBLIC kernel-wrapper calls (gemm,
# add, relu, ...) — proof that the library's kernels ran
stats = {"calls": 0}


def reset_stats() -> None:
    stats["calls"] = 0


def _count() -> C.CDLL:
    l = lib()
    stats["calls"] += 1
    return l


def _f32(a, as_tensor: bool):
    """`a` as a contiguous f32 array the library may read: a CPU tensor
    (itself when it is one already) or a numpy array."""
    if as_tensor:
        t = torch.as_tensor(a)
        if t.device.type != "cpu":
            raise ValueError(f"the native core reads host memory; got a "
                             f"tensor on {t.device}")
        return t.detach().to(torch.float32).contiguous()
    return np.ascontiguousarray(a, dtype=np.float32)


def _args(*arrays):
    """The arrays as `_f32` gives them, tensors if any of them is one."""
    as_tensor = any(isinstance(a, torch.Tensor) for a in arrays)
    return as_tensor, [_f32(a, as_tensor) for a in arrays]


def _empty(as_tensor: bool, shape):
    return (torch.empty(shape, dtype=torch.float32) if as_tensor
            else np.empty(shape, np.float32))


def _ptr(a) -> int:
    return a.data_ptr() if isinstance(a, torch.Tensor) else a.ctypes.data


def gemm(a, b, transa: bool = False, transb: bool = False,
         alpha: float = 1.0):
    """alpha · op(a) @ op(b) of 2-D f32 operands (op transposes when its
    flag is set)."""
    l = _count()
    as_tensor, (a, b) = _args(a, b)
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm takes 2-D operands, got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    m, k = (a.shape[1], a.shape[0]) if transa else a.shape
    kb, n = (b.shape[1], b.shape[0]) if transb else b.shape
    if k != kb:
        raise ValueError(f"gemm: inner dimensions {k} and {kb} differ")
    out = _empty(as_tensor, (m, n))
    l.sg_gemm(_ptr(a), _ptr(b), _ptr(out), m, k, n, int(transa),
              int(transb), alpha, 0.0)
    return out


def _binary(name):
    def fn(a, b):
        l = _count()
        as_tensor, (a, b) = _args(a, b)
        if tuple(a.shape) != tuple(b.shape):
            raise ValueError(f"{name} takes equal shapes, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        out = _empty(as_tensor, tuple(a.shape))
        getattr(l, name)(_ptr(a), _ptr(b), _ptr(out), int(np.prod(a.shape)))
        return out
    fn.__name__ = name[3:]
    return fn


add = _binary("sg_add")
sub = _binary("sg_sub")
mul = _binary("sg_mul")
div = _binary("sg_div")
relu_grad = _binary("sg_relu_grad")
relu_grad.__doc__ = "dy where a > 0, else 0: relu_grad(a, dy)."


def _unary(name):
    def fn(a):
        l = _count()
        as_tensor, (a,) = _args(a)
        out = _empty(as_tensor, tuple(a.shape))
        getattr(l, name)(_ptr(a), _ptr(out), int(np.prod(a.shape)))
        return out
    fn.__name__ = name[3:]
    return fn


relu = _unary("sg_relu")
sigmoid = _unary("sg_sigmoid")
tanh = _unary("sg_tanh")
exp = _unary("sg_exp")


def softmax(a):
    """Softmax over the last axis."""
    l = _count()
    as_tensor, (a,) = _args(a)
    cols = a.shape[-1] if a.ndim else 1
    rows = int(np.prod(a.shape[:-1])) if a.ndim > 1 else 1
    out = _empty(as_tensor, tuple(a.shape))
    l.sg_softmax(_ptr(a), _ptr(out), rows, cols)
    return out


def array_sum(a) -> float:
    """The sum of every element (accumulated in f64, in the library's
    OpenMP reduction order)."""
    l = _count()
    _, (a,) = _args(a)
    out = np.zeros(1, np.float32)
    l.sg_sum(_ptr(a), out.ctypes.data, int(np.prod(a.shape)))
    return float(out[0])


def conv2d_nhwc(x, w, stride: Tuple[int, int] = (1, 1),
                padding: Tuple[int, int] = (0, 0)):
    """Direct convolution of an NHWC `x` with an HWIO `w`, symmetric
    `padding` (rows, columns)."""
    l = _count()
    as_tensor, (x, w) = _args(x, w)
    N, H, W_, Cin = x.shape
    KH, KW, wc, OC = w.shape
    if wc != Cin:
        raise ValueError(f"conv2d_nhwc: x has {Cin} channels, w takes {wc}")
    sh, sw = stride
    ph, pw = padding
    OH = (H + 2 * ph - KH) // sh + 1
    OW = (W_ + 2 * pw - KW) // sw + 1
    y = _empty(as_tensor, (N, OH, OW, OC))
    l.sg_conv2d_nhwc(_ptr(x), _ptr(w), _ptr(y), N, H, W_, Cin, KH, KW, OC,
                     sh, sw, ph, pw)
    return y


def _writable_f32(a, what: str):
    ok = (a.dtype == torch.float32 and a.device.type == "cpu"
          and a.is_contiguous()) if isinstance(a, torch.Tensor) else (
        isinstance(a, np.ndarray) and a.dtype == np.float32
        and a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"])
    if not ok:
        raise ValueError(f"sgd_update updates {what} in place: it must be "
                         f"a writable contiguous f32 host array")


def sgd_update(param, grad, mom, lr: float, momentum: float = 0.0,
               weight_decay: float = 0.0) -> None:
    """In place: g = grad + weight_decay·param; with `mom`, mom =
    momentum·mom + g and g = mom; param -= lr·g."""
    l = _count()
    _writable_f32(param, "param")
    if mom is not None:
        _writable_f32(mom, "mom")
        if tuple(mom.shape) != tuple(param.shape):
            raise ValueError("sgd_update: mom and param differ in shape")
    grad = _f32(grad, isinstance(param, torch.Tensor))
    if tuple(grad.shape) != tuple(param.shape):
        raise ValueError("sgd_update: grad and param differ in shape")
    l.sg_sgd_update(_ptr(param), _ptr(grad),
                    _ptr(mom) if mom is not None else None, lr, momentum,
                    weight_decay, int(np.prod(param.shape)))


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def _i64(values) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.int64).reshape(-1)


class NativeGraph:
    """Handle on a native scheduler graph (topo sort + memory planning);
    raises RuntimeError when the library is unavailable."""

    def __init__(self):
        self._l = lib()
        self.h = self._l.sg_graph_new()
        self._nbufs = 0

    def add_node(self, name: str, in_bufs, out_bufs, out_sizes,
                 flops: int = 0) -> int:
        ib, ob, sz = _i64(in_bufs), _i64(out_bufs), _i64(out_sizes)
        if len(sz) != len(ob):
            raise ValueError("one size per output buffer")
        self._nbufs = max([self._nbufs] + [int(b) + 1 for b in
                                           list(ib) + list(ob)])
        return int(self._l.sg_graph_add_node(
            self.h, name.encode(), ib.ctypes.data, len(ib), ob.ctypes.data,
            len(ob), sz.ctypes.data, int(flops)))

    def toposort(self):
        n = self.num_nodes
        out = np.zeros(max(n, 1), np.int64)
        if int(self._l.sg_graph_toposort(self.h, out.ctypes.data, n)) < 0:
            raise ValueError("cycle in graph")
        return out[:n].tolist()

    def plan_memory(self):
        """(arena_bytes, {buf_id: offset})."""
        offsets = np.full(max(self._nbufs, 1), -1, np.int64)
        arena = int(self._l.sg_graph_plan_memory(self.h, offsets.ctypes.data,
                                                 self._nbufs))
        if arena < 0:
            raise ValueError("cycle in graph")
        return arena, {i: int(o) for i, o in enumerate(offsets[:self._nbufs])
                       if o >= 0}

    @property
    def num_nodes(self) -> int:
        return int(self._l.sg_graph_num_nodes(self.h))

    @property
    def total_flops(self) -> int:
        return int(self._l.sg_graph_total_flops(self.h))

    def __del__(self):
        h, self.h = getattr(self, "h", None), None
        if h is not None:
            self._l.sg_graph_free(h)


# ---------------------------------------------------------------------------
# data loader
# ---------------------------------------------------------------------------

class NativeLoader:
    """Shuffled (x, y) batches assembled by `workers` threads into a ring
    of `prefetch` batches; each epoch's order comes from
    ``std::mt19937_64(seed + epoch)``.  The threads read `x` and `y`
    after the constructor returns, so the loader holds the exact
    contiguous arrays it passed to the library until `close`."""

    def __init__(self, x: np.ndarray, y: Optional[np.ndarray], batch: int,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 workers: int = 2, prefetch: int = 4):
        self._l = lib()
        self.h = None
        x = np.asarray(x)
        self.sample_shape = x.shape[1:]
        self.x = np.ascontiguousarray(x.reshape(len(x), -1), np.float32)
        self.y = np.ascontiguousarray(y, np.int32) if y is not None else None
        if self.y is not None and self.y.shape != (len(x),):
            raise ValueError(f"y has shape {self.y.shape}, want ({len(x)},)")
        self.batch = batch
        self.stride = self.x.shape[1]
        h = self._l.sg_loader_new(
            self.x.ctypes.data,
            self.y.ctypes.data if self.y is not None else None, len(x),
            self.stride, batch, int(shuffle), seed, int(drop_last), workers,
            prefetch)
        if h < 0:
            raise ValueError("bad loader args")
        self.h = h

    def next(self):
        """The next batch (x, y), fresh arrays the library wrote;
        StopIteration once the loader is closed."""
        if self.h is None:
            raise StopIteration
        xb = np.empty((self.batch, self.stride), np.float32)
        yb = np.empty(self.batch, np.int32) if self.y is not None else None
        n = int(self._l.sg_loader_next(
            self.h, xb.ctypes.data, yb.ctypes.data if yb is not None
            else None))
        if n <= 0:
            raise StopIteration
        x = xb[:n].reshape((n,) + self.sample_shape)
        return x, (yb[:n] if yb is not None else None)

    @property
    def batches_per_epoch(self) -> int:
        return int(self._l.sg_loader_batches_per_epoch(self.h))

    def close(self) -> None:
        """Stop and join the worker threads (idempotent)."""
        h, self.h = self.h, None
        if h is not None:
            self._l.sg_loader_free(h)

    def __del__(self):
        if getattr(self, "h", None) is not None:
            self.close()


# ---------------------------------------------------------------------------
# allocator (host staging pool)
# ---------------------------------------------------------------------------

def pool_alloc(nbytes: int) -> int:
    """The address of a 64-byte aligned block of at least `nbytes` from
    the pool (a freed block of the same size bucket is reused)."""
    p = lib().sg_pool_alloc(nbytes)
    if not p:
        raise MemoryError(f"sg_pool_alloc({nbytes}) failed")
    return p


def pool_free(ptr: int) -> None:
    lib().sg_pool_free(ptr)


def pool_bytes_in_use() -> int:
    return int(lib().sg_pool_bytes_in_use())


def pool_bytes_reserved() -> int:
    return int(lib().sg_pool_bytes_reserved())


def pool_trim() -> None:
    """Return the cached free blocks to the system."""
    lib().sg_pool_trim()
