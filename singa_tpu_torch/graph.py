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
not the hand-written kernels', which no aten op shows) and the bytes
of the graph's private memory pool.  The ops are counted on an eager
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


class _OpCounter(TorchDispatchMode):
    """Counts the aten ops that run under it, by op, and their FLOPs;
    runs each op as it is."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {}
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        self.counts[str(packet)] = self.counts.get(str(packet), 0) + 1
        formula = flop_registry.get(packet)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


class CapturedGraph:
    """One captured (or, on the CPU, recorded) step: its ops, FLOPs and
    hand-written kernel launches, and on a CUDA device the graph and the
    bytes of its private pool."""

    def __init__(self, name: str, op_counts: Dict[str, int], flops: float,
                 launches: Dict[str, int]):
        self.name = name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._op_counts = dict(op_counts)
        self._flops = float(flops)
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
        """FLOPs of one step's aten ops (the hand-written kernels' are
        not among them)."""
        return {"flops": self._flops}

    def flops(self) -> float:
        return self._flops

    def memory_analysis(self) -> Dict[str, Any]:
        """Bytes the capture reserved for the graph's private pool (0
        where nothing was captured)."""
        return {"pool_bytes": self.pool_bytes}

    # -- capture and replay ---------------------------------------------------
    def capture(self, fn: Callable[[], Any], stream: torch.cuda.Stream,
                generators: Tuple[torch.Generator, ...] = ()):
        """Capture fn() into a CUDA graph on `stream` and return what it
        returned (tensors in the graph's pool, written by each replay).
        Capture runs nothing: call `replay` for the first result.  A
        capture that fails raises."""
        dev = stream.device
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = kernel_launches()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
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
    """Run fn() eagerly, counting its aten ops, their FLOPs and the
    hand-written kernels it launches: (fn's result, CapturedGraph)."""
    before = kernel_launches()
    with _OpCounter() as ops:
        out = fn()
    return out, CapturedGraph(name, ops.counts, ops.flops, _since(before))


def reset_graph(device=None) -> None:
    """Make every model's captured graphs stale, so that its next step
    or generate() call captures anew (reference ``Device.ResetGraph``);
    needed after a kernel library is swapped, since a graph keeps the
    kernels it captured."""
    global _epoch
    _epoch += 1
