"""Step capture bookkeeping, ported from ``singa_tpu/graph.py``
(``CapturedGraph``, ``reset_graph``).

The reference's capture is a jax trace of the user's imperative step,
compiled by XLA into one module.  Here the capture is a CUDA graph
(``torch.cuda.CUDAGraph``) of one step: every kernel the step launches,
the hand-written flash kernels among them, recorded once and replayed
by one host call.  A ``CapturedGraph`` keeps that graph with what the
reference's keeps about its module: the ops of one recorded step
(``num_ops``, ``op_types``: aten ops as a ``TorchDispatchMode`` sees
them, plus the hand-written kernels' launches by name), their FLOPs
(by the formulas of ``torch.utils.flop_counter``, for matrix products;
not the hand-written kernels', which no aten op shows), the bytes those
ops move (each op's tensor inputs read once and its tensor outputs
written once; a view moves none; an indexing op moves the rows it
selects or writes, not the whole tensor it indexes) and the bytes of
the graph's private memory pool.  The ops are counted on an eager
run of the step, never inside the capture.  ``FlopCounterMode`` itself
is not used: it decomposes ops it has no formula for, which changes the
step's roundings, and a counted step must be the step.  On the CPU a
step is recorded the same way and ``graph`` stays None.

``hlo_text``, ``compiled_hlo``, ``save_hlo`` and ``Schedule`` read XLA's
modules and jaxprs and have no counterpart here.

A graph's ``launches`` are the hand-written kernels' launches that its
capture recorded (the wrappers' host counters).  A replay calls no
wrapper: the launches that ran, replays included, are counted on the
card by the kernels themselves (``ops.flash_attention.device_launches``).

``reset_graph`` moves an epoch; every executor and generate() session
remembers the epoch it was made in and is made anew once it has moved.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .ops import flash_attention as _fa

__all__ = ["CapturedGraph", "record", "reset_graph", "epoch",
           "kernel_launches"]

#: each hand-written kernel's name and its counter in ops.flash_attention
_COUNTERS = {"flash_fwd": "launches", "flash_bwd_dq": "dq_launches",
             "flash_bwd_dkv": "dkv_launches"}


#: moved by reset_graph(): graphs made in an earlier epoch are stale
_epoch = 0


def epoch() -> int:
    """How many times reset_graph() has run."""
    return _epoch


def kernel_launches() -> Dict[str, int]:
    """The hand-written kernels' wrapper launch counters, by kernel
    name."""
    return {k: getattr(_fa, attr) for k, attr in _COUNTERS.items()}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in kernel_launches().items()}


def _tensor_bytes(tree) -> int:
    """Bytes of the tensors in a pytree of op arguments or results."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _indexed_bytes(base: torch.Tensor, indices) -> int:
    """Bytes of ``base[indices]`` (advanced indexing; None keeps a
    dimension whole).  A boolean mask counts all its elements: its true
    count would need the host to read the mask."""
    shapes, taken = [], 0
    for i in indices:
        if i is None:
            taken += 1
        elif i.dtype == torch.bool:
            shapes.append((i.numel(),))
            taken += i.dim()
        else:
            shapes.append(tuple(i.shape))
            taken += 1
    whole = [d for n, d in enumerate(base.shape)
             if n >= taken or indices[n] is None]
    n = torch.Size(torch.broadcast_shapes(*shapes)).numel() if shapes \
        else 1
    return n * torch.Size(whole).numel() * base.element_size()


def _index_put(args, kwargs, out):
    """``self[indices] = values`` in place: the values and indices read,
    the indexed rows written (and read, to accumulate)."""
    self_, indices, values = args[:3]
    acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
    rows = _indexed_bytes(self_, indices)
    return _tensor_bytes((indices, values)) + rows * (2 if acc else 1)


def _into(n_of: Callable, combine: bool):
    """``index_copy_`` / ``index_add_`` (n_of: the source's elements) and
    ``scatter_`` and kin (n_of: the index's elements), in place: the
    index read, n elements of the source read (none for a scalar) and
    n elements of self written, and read as well where ``combine``."""
    def count(args, kwargs, out):
        self_, _, index = args[:3]
        src = args[3] if len(args) > 3 else kwargs.get("src")
        n = n_of(index, src)
        read = n * src.element_size() if isinstance(src, torch.Tensor) \
            else 0
        rows = n * self_.element_size()
        return _tensor_bytes(index) + read + rows * (2 if combine else 1)
    return count


def _source_n(index, src):
    return src.numel()


def _index_n(index, src):
    return index.numel()


def _gather_rows(index_at: int):
    """``embedding`` / ``index_select`` / ``gather`` / ``index``: the
    indices read, the selected rows read once and written once."""
    def count(args, kwargs, out):
        return _tensor_bytes(args[index_at]) + 2 * _tensor_bytes(out)
    return count


_aten = torch.ops.aten

#: ops whose bytes are not "every tensor argument read, every result
#: written": indexing ops touch the rows they select or write, ``copy_``
#: does not read its destination, ``fill_`` and ``zero_`` only write
_BYTES = {
    _aten.index_put_: _index_put,
    _aten._index_put_impl_: _index_put,
    _aten.index_copy_: _into(_source_n, False),
    _aten.index_add_: _into(_source_n, True),
    _aten.scatter_: _into(_index_n, False),
    _aten.scatter_add_: _into(_index_n, True),
    _aten.scatter_reduce_: _into(_index_n, True),
    _aten.embedding: _gather_rows(1),
    _aten.index_select: _gather_rows(2),
    _aten.gather: _gather_rows(2),
    _aten.index: _gather_rows(1),
    _aten._unsafe_index: _gather_rows(1),
    _aten.copy_: lambda args, kwargs, out: _tensor_bytes(args[:2]),
    _aten.fill_: lambda args, kwargs, out: _tensor_bytes(args[0]),
    _aten.zero_: lambda args, kwargs, out: _tensor_bytes(args[0]),
}


def _op_bytes(func, args, kwargs, out) -> int:
    """Bytes one aten op moves: a view none, an op of ``_BYTES`` its
    own count, any other each tensor argument read once and each result
    written once (an in-place op's result is the argument it wrote)."""
    if func.is_view:
        return 0
    count = _BYTES.get(func.overloadpacket)
    if count is not None:
        return count(args, kwargs, out)
    return _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops that run under it, by op, their FLOPs and the
    bytes they move (``_op_bytes``); runs each op as it is."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self.counts[str(packet)] = self.counts.get(str(packet), 0) + 1
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        self.bytes += _op_bytes(func, args, kwargs, out)
        return out


class CapturedGraph:
    """One captured (or, on the CPU, recorded) step: its ops, FLOPs and
    hand-written kernel launches, and on a CUDA device the graph and the
    bytes of its private pool."""

    def __init__(self, name: str, op_counts: Dict[str, int], flops: float,
                 launches: Dict[str, int], nbytes: float = 0):
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._op_counts = dict(op_counts)
        self._flops = float(flops)
        self._bytes = float(nbytes)
        self.launches = {k: n for k, n in launches.items() if n}
        self.pool_bytes = 0
        self.capture_seconds: Optional[float] = None

    # -- introspection --------------------------------------------------------
    @property
    def num_ops(self) -> int:
        return sum(self.op_types().values())

    def op_types(self) -> Dict[str, int]:
        """aten ops of one step by name (``aten.mm``, ...), and the
        hand-written kernels by name (``flash_fwd``, ...)."""
        return {**self._op_counts, **self.launches}

    def cost_analysis(self) -> Dict[str, Any]:
        """FLOPs of one step's aten ops and the bytes they move (the
        hand-written kernels' are not among them)."""
        return {"flops": self._flops, "bytes accessed": self._bytes}

    def flops(self) -> float:
        return self._flops

    def bytes_accessed(self) -> float:
        """Bytes one step's aten ops read and write, op by op."""
        return self._bytes

    def memory_analysis(self) -> Dict[str, Any]:
        """Bytes the capture reserved for the graph's private pool (0
        where nothing was captured)."""
        return {"pool_bytes": self.pool_bytes}

    # -- capture and replay ---------------------------------------------------
    def capture(self, fn: Callable[[], Any], stream: torch.cuda.Stream,
                generators: Tuple[torch.Generator, ...] = (),
                error_mode: str = "global"):
        """Capture fn() into a CUDA graph on `stream` and return what it
        returned (tensors in the graph's pool, written by each replay).
        Capture runs nothing: call `replay` for the first result.  A
        capture that fails raises.  `error_mode` is torch's
        ``capture_error_mode``: "thread_local" lets other threads (NCCL's
        watchdog) make CUDA calls while this one captures."""
        dev = stream.device
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernel_launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode=error_mode):
            out = fn()
        recorded = _since(before)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: n for k, n in recorded.items() if n}
        self.graph = graph
        return out

    def replay(self) -> None:
        self.graph.replay()


def record(name: str, fn: Callable[[], Any]):
    """Run fn() eagerly, counting its aten ops, their FLOPs and bytes and
    the hand-written kernels it launches: (fn's result, CapturedGraph)."""
    before = kernel_launches()
    with _OpCounter() as ops:
        out = fn()
    return out, CapturedGraph(name, ops.counts, ops.flops, _since(before),
                              ops.bytes)


def reset_graph(device=None) -> None:
    """Make every model's captured graphs stale, so that its next step
    or generate() call captures anew (reference ``Device.ResetGraph``);
    needed after a kernel library is swapped, since a graph keeps the
    kernels it captured."""
    global _epoch
    _epoch += 1
