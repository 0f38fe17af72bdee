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

``schedule()`` feeds the native scheduler (``_core.NativeGraph``, the
port's copy of the C++ core) an SSA op graph of the step: a
``torch.fx`` graph from ``make_fx`` over the step, functionalized
(`trace`), the counterpart of the reference's jaxpr.  It is traced
when ``schedule()`` is called, never on the step's path, over fake
tensors of the step's shapes, so it holds no step's activations.  The
returned `Schedule` has the reference's surface (``order``,
``arena_bytes``, ``num_nodes``, ``buffer_offsets``, ``native_hits``)
and ``replay``s the graph on the host in that order, each f32 result
written into its arena offset.  ``hlo_text``, ``compiled_hlo`` and
``save_hlo`` read XLA's modules and have no counterpart here.

A graph's ``launches`` are the hand-written kernels' launches that its
capture recorded (the wrappers' host counters).  A replay calls no
wrapper: the launches that ran, replays included, are counted on the
card by the kernels themselves (``ops.flash_attention.device_launches``).

``reset_graph`` moves an epoch; every executor and generate() session
remembers the epoch it was made in and is made anew once it has moved.
"""

from __future__ import annotations

import operator
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .ops import flash_attention as _fa

__all__ = ["CapturedGraph", "Schedule", "record", "trace", "reset_graph",
           "epoch", "kernel_launches"]

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
    bytes of its private pool.  `fx` is the step's traced SSA graph
    (`trace`): given, or traced at first use by `fx_thunk`, which the
    step executor sets."""

    def __init__(self, name: str, op_counts: Optional[Dict[str, int]] = None,
                 flops: float = 0.0, launches: Optional[Dict[str, int]] = None,
                 nbytes: float = 0, fx=None):
        op_counts, launches = op_counts or {}, launches or {}
        self.name = name
        self._fx = fx
        self.fx_thunk: Optional[Callable[[], Any]] = None
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

    # -- native scheduler bridge ---------------------------------------------
    @property
    def fx(self):
        """The step's functionalized ``torch.fx`` graph (traced at first
        use), or None where there is none."""
        if self._fx is None and self.fx_thunk is not None:
            self._fx = self.fx_thunk()
            self.fx_thunk = None
        return self._fx

    def schedule(self) -> "Schedule":
        """Feed the traced op graph to the native scheduler: its
        deterministic topological order and first-fit arena plan for a
        serial host replay (raises when the library is unavailable).  A
        node's buffers are the values it reads and writes; a
        multi-output op's ``getitem`` reads its element in place, and a
        sink node keeps the graph's outputs live to the end."""
        from . import _core
        from .obs import events as obs_events
        gm = self.fx
        if gm is None:
            raise RuntimeError(f"graph {self.name!r} has no traced step")
        with obs_events.span("graph.schedule", graph=self.name,
                             nodes=len(gm.graph.nodes)):
            ng = _core.NativeGraph()
            buf_ids: Dict[Tuple, int] = {}
            steps: List[torch.fx.Node] = []

            def bid(key) -> int:
                return buf_ids.setdefault(key, len(buf_ids))

            def reads(node) -> List[int]:
                keys = []
                torch.fx.node.map_arg((node.args, node.kwargs),
                                      lambda n: keys.append(_value_key(n)))
                return [bid(k) for k in keys
                        if isinstance(_meta(k), torch.Tensor)]

            for node in gm.graph.nodes:
                if node.op in ("placeholder", "get_attr"):
                    bid((node, None))
                elif node.op == "call_function" and _is_alias(node):
                    continue
                elif node.op == "call_function":
                    outs = list(_out_values(node))
                    ng.add_node(str(node.target), reads(node),
                                [bid(k) for k, _ in outs],
                                [v.numel() * v.element_size()
                                 for _, v in outs])
                    steps.append(node)
                elif node.op == "output":
                    # outputs are read after the last node: their buffers
                    # stay live to the end (replay returns copies of them)
                    sink = reads(node)
                    if sink:
                        ng.add_node("__sink__", sink, [], [], 0)
            order = ng.toposort()
            arena, offsets = ng.plan_memory()
            return Schedule(order, arena, ng.num_nodes, offsets, gm, steps,
                            buf_ids)


def record(name: str, fn: Callable[[], Any]):
    """Run fn() eagerly, counting its aten ops, their FLOPs and bytes and
    the hand-written kernels it launches: (fn's result, CapturedGraph)."""
    before = kernel_launches()
    with _OpCounter() as ops:
        out = fn()
    return out, CapturedGraph(name, ops.counts, ops.flops, _since(before),
                              ops.bytes)


def trace(fn: Callable, *example_inputs):
    """An SSA ``torch.fx`` graph of fn(*example_inputs): ``make_fx`` over
    fn (autograd and in-place updates recorded as aten ops), then over
    that graph functionalized, so every node writes a new value and an
    input's update is one trailing ``copy_``.  Example inputs that are
    fake tensors trace in their fake mode and allocate nothing."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.func import functionalize
    from torch._subclasses.fake_tensor import FakeTensor
    mode = "fake" if any(isinstance(a, FakeTensor)
                         for a in example_inputs) else "real"
    raw = make_fx(fn, tracing_mode=mode)(*example_inputs)
    plain = [a.detach() if isinstance(a, torch.Tensor) else a
             for a in example_inputs]
    return make_fx(functionalize(raw, remove="mutations_and_views"),
                   tracing_mode=mode)(*plain)


def _meta(key):
    """The traced value (fake tensor) of a buffer key."""
    node, i = key
    val = node.meta.get("val")
    return val if i is None else val[i]


def _is_alias(node) -> bool:
    """A ``getitem`` of a multi-output op: it reads that op's element in
    place, no new buffer."""
    return node.target is operator.getitem and isinstance(
        node.args[0].meta.get("val"), (tuple, list))


def _value_key(node) -> Tuple:
    """The buffer key of the value `node` stands for: (producer, element
    index) for an alias, else (node, None)."""
    if node.op == "call_function" and _is_alias(node):
        return node.args[0], node.args[1]
    return node, None


def _out_values(node):
    """(key, fake tensor) of each tensor `node` writes."""
    val = node.meta.get("val")
    if isinstance(val, torch.Tensor):
        yield (node, None), val
    elif isinstance(val, (tuple, list)):
        for i, v in enumerate(val):
            if isinstance(v, torch.Tensor):
                yield (node, i), v


_aten_native = {
    torch.ops.aten.add.Tensor: "add", torch.ops.aten.sub.Tensor: "sub",
    torch.ops.aten.mul.Tensor: "mul", torch.ops.aten.div.Tensor: "div",
    torch.ops.aten.exp.default: "exp", torch.ops.aten.tanh.default: "tanh",
    torch.ops.aten.sigmoid.default: "sigmoid",
    torch.ops.aten.mm.default: "gemm",
}


class Schedule:
    """A native-planned execution schedule: the deterministic topological
    order and the first-fit arena plan of the C++ scheduler, and a host
    `replay` that consumes both (the reference's single-threaded
    deterministic replay).  Replay runs the traced graph node by node in
    the planned order, writes each f32 result into its planned arena
    offset (so an unsound liveness plan corrupts the outputs), and runs
    the elementwise ops and products the library has through its host
    kernels, as the reference's ``_native_eqn`` does."""

    def __init__(self, order, arena_bytes, num_nodes, buffer_offsets, gm,
                 steps, buf_ids):
        self.order = order
        self.arena_bytes = arena_bytes
        self.num_nodes = num_nodes
        self.buffer_offsets = buffer_offsets
        self.gm = gm                  # the traced graph it plans
        self._steps = steps           # its op nodes, by scheduler node id
        self._buf_ids = buf_ids       # (node, element) -> buffer id
        self.native_hits = 0

    def replay(self, *args, use_native: bool = True) -> List:
        """Serial host execution of the traced graph in planned order.
        `args` match its placeholders (tensors or numpy arrays; copied,
        so an update the step makes in place leaves them as they are).
        Returns the flat outputs, copied out of the arena.  With
        `use_native` the host kernels take what they can, and an
        unavailable library raises."""
        from . import _core
        if use_native:
            _core.lib()
        graph = self.gm.graph
        holders = [n for n in graph.nodes if n.op == "placeholder"]
        if len(args) != len(holders):
            raise ValueError(f"replay needs {len(holders)} args, got "
                             f"{len(args)}")
        arena = torch.zeros(self.arena_bytes, dtype=torch.uint8) \
            if self.arena_bytes else None
        env: Dict[Tuple, Any] = {}
        for n, a in zip(holders, args):
            env[(n, None)] = torch.as_tensor(a).clone()
        for n in graph.nodes:
            if n.op == "get_attr":
                env[(n, None)] = operator.attrgetter(n.target)(self.gm)

        def read(n):
            return env[_value_key(n)]

        def place(key, value):
            """Store a result, into its planned arena slot when f32."""
            off = self.buffer_offsets.get(self._buf_ids.get(key))
            if (arena is not None and off is not None
                    and isinstance(value, torch.Tensor)
                    and value.dtype == torch.float32 and value.ndim
                    and value.device.type == "cpu"):
                view = arena[off:off + value.numel() * 4].view(
                    torch.float32).view(value.shape)
                view.copy_(value)
                value = view
            env[key] = value

        self.native_hits = 0
        for idx in self.order:
            if idx >= len(self._steps):
                continue              # the liveness sink, nothing to run
            node = self._steps[idx]
            a, kw = torch.fx.node.map_arg((node.args, node.kwargs), read)
            out = self._native(node, a, kw) if use_native else None
            if out is None:
                out = node.target(*a, **kw)
            else:
                self.native_hits += 1
            if isinstance(out, (tuple, list)):
                for i, o in enumerate(out):
                    place((node, i), o)
            else:
                place((node, None), out)
        out_node = next(n for n in graph.nodes if n.op == "output")
        flat: List = []
        torch.fx.node.map_aggregate(
            out_node.args[0], lambda v: flat.append(
                read(v) if isinstance(v, torch.fx.Node) else v))
        # copies at the boundary: no output aliases the shared arena
        return [v.clone() if isinstance(v, torch.Tensor) else v
                for v in flat]

    @staticmethod
    def _native(node, args, kwargs):
        """A node through the host kernels, or None where the library
        has no kernel for it: add/sub/mul/div of equal f32 shapes, exp,
        tanh, sigmoid, and a 2-D f32 product."""
        from . import _core
        name = _aten_native.get(node.target)
        if name is None or kwargs or not all(
                isinstance(v, torch.Tensor) and v.dtype == torch.float32
                and v.device.type == "cpu" and v.ndim for v in args):
            return None
        if name == "gemm":
            return _core.gemm(*args) if all(v.ndim == 2 for v in args) \
                else None
        if len(args) == 2:
            return getattr(_core, name)(*args) \
                if args[0].shape == args[1].shape else None
        return getattr(_core, name)(args[0])

    def __repr__(self):
        return (f"<Schedule nodes={self.num_nodes} "
                f"arena={self.arena_bytes}B>")


def reset_graph(device=None) -> None:
    """Make every model's captured graphs stale, so that its next step
    or generate() call captures anew (reference ``Device.ResetGraph``);
    needed after a kernel library is swapped, since a graph keeps the
    kernels it captured."""
    global _epoch
    _epoch += 1
