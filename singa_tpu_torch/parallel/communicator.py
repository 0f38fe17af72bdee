"""The communicator, ported from ``singa_tpu/parallel/communicator.py``:
collectives over the ``data`` axis of the current mesh and the gradient
syncs DistOpt runs (plain, bf16-compressed, top-K sparsified, int8 with
an int32 wire, and the int8 ring with error feedback).

The reference's collectives are in-graph ``lax`` ops that take effect
only inside ``shard_map``.  Here each is a ``torch.distributed`` call on
the subgroup of the current mesh's `axis` (one axis, or a tuple of axes
taken together; NCCL on the card, gloo on the CPU), made eagerly or
recorded into the step's CUDA graph when the step is captured; NCCL runs
a captured collective on the capture stream's schedule, so a replay
needs no extra stream sync.  Ranks and indices are positions along the
axis, mapped to global ranks through the mesh.  An axis is *bound* when
a process group exists and the current mesh, bound to it, has that
axis; outside one every call here is the identity, as the reference's
are outside a mapped axis.

Hooks: each staged collective fires the ``comm.collective`` fault site
and emits its ``comm.<op>.bytes`` counter, and each gradient sync the
``comm.wire_bytes.compressed`` / ``.f32_equiv`` pair (``obs.events``).
They run on the host where the collective is issued: once per call
eagerly, and once when a step is captured (never on a replay), where
the reference fires them once per trace.

The int8 ring is bitwise the reference's on the same inputs: the same
chunking (`_ring_chunk`, rank-major chunks of `block`-element blocks),
the same consensus scales (a MAX allreduce of each block's absmax), the
same widened grids s·(t+1) for hop t and s·W for the final codes, the
same hop order, the same rotation undone after the all-gather, f32
throughout and ``torch.round`` (half to even, as ``jnp.round``).  Two
rewrites XLA makes of the reference are made here by hand: a division
by a constant (absmax/127, a sum over W ranks) is a product with its
f32 reciprocal (`_recip`), and the ring's two multiply-adds (a hop's
dequantize-and-add, the residual's x − q·grid) round once, as fused
multiply-adds (`_madd`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import faults
from ..obs import events
from . import mesh as mesh_mod

__all__ = ["axis_bound", "allreduce", "allreduce_grads", "allgather",
           "reduce_scatter", "ppermute", "broadcast", "axis_index",
           "axis_size", "barrier", "quantized_allreduce",
           "ef_quantized_allreduce", "int8_ring_wire_bytes",
           "f32_ring_wire_bytes"]


def _names(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_bound(axis) -> bool:
    """True when a process group exists and the current mesh, made over
    it, has `axis` (every axis of a tuple)."""
    m = mesh_mod.current_mesh()
    return (m is not None and dist.is_initialized() and m.bound
            and all(a in m.shape for a in _names(axis)))


def axis_index(axis) -> int:
    """This rank's position along `axis` (0 where it is not bound)."""
    if not axis_bound(axis):
        return 0
    return mesh_mod.current_mesh().axis_index(axis)


def axis_size(axis) -> int:
    """The number of ranks along `axis` (1 where it is not bound)."""
    if not axis_bound(axis):
        return 1
    return mesh_mod.current_mesh().axis_size(axis)


def _group(axis):
    """The subgroup of `axis` (None: the default group)."""
    return mesh_mod.current_mesh().group(axis)


def _label(axis) -> str:
    return ",".join(_names(axis))


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _staged(collective: str, x, axis: str, **attrs) -> None:
    """The ``comm.collective`` fault site, then the payload counter."""
    faults.fire("comm.collective", collective=collective,
                axis=_label(axis))
    if events.enabled():
        nbytes = sum(t.numel() * t.element_size() for t in _tensors(x))
        events.counter(f"comm.{collective}.bytes", nbytes,
                       axis=_label(axis), **attrs)


# ---------------------------------------------------------------------------
# wire-byte accounting (the obs ``comm.wire_bytes.*`` counters)
# ---------------------------------------------------------------------------

def _ring_chunk(n: int, world: int, block: int) -> int:
    """Per-rank chunk length of the int8 ring over `n` elements: the
    padded layout `_ring_int8_allreduce` and the byte model share."""
    C = -(-n // world)
    C += (-C) % block
    return C


def f32_ring_wire_bytes(n: int, world: int) -> int:
    """Per-participant ring-allreduce wire bytes of `n` f32 elements:
    2(W-1)/W x 4n."""
    if world <= 1:
        return 0
    return int(round(2.0 * (world - 1) / world * n * 4))


def int8_ring_wire_bytes(n: int, world: int, block: int = 256) -> int:
    """Per-participant wire bytes of one int8 ring RS+AG over `n`
    elements: (W-1) hops and an all-gather of C int8 bytes each, plus
    the consensus MAX of W·C/block f32 scales."""
    if world <= 1:
        return 0
    C = _ring_chunk(n, world, block)
    payload = 2 * (world - 1) * C
    consensus = int(round(2.0 * (world - 1) / world
                          * world * (C // block) * 4))
    return payload + consensus


def _emit_wire_counters(n_elems: int, axis: str, mode: str,
                        block: int = 256) -> None:
    """The ``comm.wire_bytes.compressed`` / ``.f32_equiv`` pair of one
    gradient sync."""
    if not events.enabled():
        return
    W = axis_size(axis)
    f32_eq = f32_ring_wire_bytes(n_elems, W)
    if mode == "int8_ring":
        compressed = int8_ring_wire_bytes(n_elems, W, block)
    elif mode == "bf16":
        compressed = int(round(2.0 * (W - 1) / W * n_elems * 2))
    else:
        compressed = f32_eq
    events.counter("comm.wire_bytes.compressed", compressed,
                   axis=_label(axis), mode=mode)
    events.counter("comm.wire_bytes.f32_equiv", f32_eq, axis=_label(axis),
                   mode=mode)


# ---------------------------------------------------------------------------
# unstaged torch.distributed calls over the group of `axis`
# ---------------------------------------------------------------------------

def _all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # torch 2.13 renames all_gather_into_tensor to all_gather_single and
    # deprecates the old name; 2.11 has only the old one
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def _reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)


def _gather(x: torch.Tensor, axis) -> torch.Tensor:
    """(W, *x.shape): every rank's x along `axis`, stacked in axis
    order."""
    W = axis_size(axis)
    x = x.contiguous()
    out = x.new_empty((W * x.numel(),))
    _all_gather_into(out, x.reshape(-1), _group(axis))
    return out.reshape((W,) + tuple(x.shape))


def _reduce(x: torch.Tensor, op, axis) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=_group(axis))
    return out


def _recip(n: int) -> float:
    """1/n rounded to f32: XLA compiles a division by the constant n as
    a product with this."""
    return float(np.float32(1.0 / n))


def _pmax(x: torch.Tensor, axis) -> torch.Tensor:
    return _reduce(x, dist.ReduceOp.MAX, axis)


def _pmean(x: torch.Tensor, axis) -> torch.Tensor:
    # the reference's pmean: psum, then a division by the axis size
    return _reduce(x, dist.ReduceOp.SUM, axis) * _recip(axis_size(axis))


def _ppermute(x, perm: Sequence[Tuple[int, int]], axis):
    """Send x (a tensor, or a tuple of tensors sent together in one
    batch) to each target of this rank in `perm` ((src, dst) pairs of
    positions along `axis`) and return what this rank receives; zeros
    where nothing arrives."""
    many = isinstance(x, (tuple, list))
    xs = [t.contiguous() for t in (x if many else (x,))]
    m = mesh_mod.current_mesh()
    line, group = m.line(axis), _group(axis)
    r = m.axis_index(axis)
    outs = [torch.zeros_like(t) for t in xs]
    ops = []
    for src, dst in perm:
        for t, out in zip(xs, outs):
            if src == r and dst == r:
                out.copy_(t)
            elif src == r:
                ops.append(dist.P2POp(dist.isend, t, line[dst], group))
            elif dst == r:
                ops.append(dist.P2POp(dist.irecv, out, line[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(outs) if many else outs[0]


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def allreduce(x: torch.Tensor, axis="data", op: str = "mean"):
    if not axis_bound(axis):
        return x
    if op != "mean" and op not in _OPS:
        raise ValueError(f"unknown reduce op {op}")
    _staged("allreduce", x, axis, op=op)
    if op == "mean":
        return _pmean(x, axis)
    return _reduce(x, getattr(dist.ReduceOp, _OPS[op]), axis)


def allgather(x: torch.Tensor, axis="data", tiled: bool = False):
    """Every rank's x: stacked on a new axis 0, or concatenated along
    axis 0 when `tiled`."""
    if not axis_bound(axis):
        return x
    _staged("allgather", x, axis)
    out = _gather(x, axis)
    return out.reshape((-1,) + tuple(x.shape[1:])) if tiled else out


def reduce_scatter(x: torch.Tensor, axis="data",
                   scatter_dimension: int = 0):
    """The sum over ranks, of which rank r keeps block r along
    `scatter_dimension` (the reference's tiled psum_scatter)."""
    if not axis_bound(axis):
        return x
    _staged("reduce_scatter", x, axis)
    W = axis_size(axis)
    d = scatter_dimension % x.ndim
    if x.shape[d] % W:
        raise ValueError(f"dimension {d} of {tuple(x.shape)} is not "
                         f"divisible by {W} ranks")
    xm = x.movedim(d, 0).contiguous()
    out = xm.new_empty((xm.shape[0] // W,) + tuple(xm.shape[1:]))
    _reduce_scatter_into(out, xm, _group(axis))
    return out.movedim(0, d)


def gather_batch(x: torch.Tensor, axis="data", dim: int = 0
                 ) -> torch.Tensor:
    """Every rank's blocks concatenated along `dim` (default the rows): a
    data-parallel step's output back at the global batch (the
    reference's ``out_specs=P(axis)``, which stages no collective, so
    neither does this)."""
    if not axis_bound(axis):
        return x
    g = _gather(x, axis)                        # (W, *x.shape)
    return torch.cat(g.unbind(0), dim=dim) if dim else \
        g.reshape((-1,) + tuple(x.shape[1:]))


def ppermute(x, axis, perm):
    """`x` (a tensor or a tuple of tensors, sent in one batch) moved
    along `perm`, (src, dst) positions along `axis`."""
    if not axis_bound(axis):
        return x
    _staged("ppermute", x, axis)
    return _ppermute(x, perm, axis)


def broadcast(x: torch.Tensor, axis="data", src: int = 0):
    """The value of the rank at position `src` along `axis` on every
    rank of it."""
    if not axis_bound(axis):
        return x
    if axis_size(axis) == 1:
        return x
    _staged("broadcast", x, axis)
    out = x.clone(memory_format=torch.contiguous_format)
    m = mesh_mod.current_mesh()
    dist.broadcast(out, m.line(axis)[src], group=_group(axis))
    return out


def barrier(axis="data") -> None:
    """An allreduce of one element: a barrier that a CUDA graph can
    hold (``dist.barrier`` syncs the host)."""
    if axis_bound(axis):
        dev = mesh_mod.local_devices()[0]
        dist.all_reduce(torch.ones((), device=dev), group=_group(axis))


# ---------------------------------------------------------------------------
# gradient allreduce with the reference Communicator's variants
# ---------------------------------------------------------------------------

def _is_int8(compress_dtype) -> bool:
    """"int8" and torch.int8 both route to the quantized path: a plain
    cast to an int dtype would truncate gradients to zero."""
    if compress_dtype is None:
        return False
    if isinstance(compress_dtype, str):
        return compress_dtype == "int8"
    return compress_dtype == torch.int8


def _as_dtype(compress_dtype) -> Optional[torch.dtype]:
    if isinstance(compress_dtype, torch.dtype):
        return compress_dtype
    if isinstance(compress_dtype, str):
        dt = getattr(torch, compress_dtype, None)
        if isinstance(dt, torch.dtype):
            return dt
    raise TypeError(f"compress_dtype {compress_dtype!r} is not a torch "
                    f"dtype, 'int8' or 'int8_ring'")


def allreduce_grads(grads: Dict[str, torch.Tensor], axis: str = "data",
                    compress_dtype=None,
                    topk_ratio: float = 0.0) -> Dict[str, torch.Tensor]:
    """Mean-allreduce a dict of gradients over `axis`.

    compress_dtype: a 2-byte float dtype (bf16) casts before the reduce
    and back after it (the reference's fp16 allreduce); "int8" (or
    torch.int8) takes `quantized_allreduce`'s int32 wire; "int8_ring"
    its int8 ring.  topk_ratio > 0: the fixed-K sparsified exchange for
    tensors of more than 1024 elements."""
    if not axis_bound(axis):
        return grads
    _staged("allreduce_grads", [g for g in grads.values() if g is not None],
            axis, tensors=len(grads),
            compress=None if compress_dtype is None else str(compress_dtype),
            topk_ratio=topk_ratio or 0.0)
    n_elems = sum(g.numel() for g in grads.values() if g is not None)
    mode = "f32"
    if compress_dtype == "int8_ring":
        mode = "int8_ring"
    elif compress_dtype is not None and not _is_int8(compress_dtype):
        compress_dtype = _as_dtype(compress_dtype)
        if compress_dtype.itemsize == 2:
            mode = "bf16"
    _emit_wire_counters(n_elems, axis, mode)
    out = {}
    for name, g in grads.items():
        if g is None:
            out[name] = None
        elif topk_ratio and topk_ratio > 0.0 and g.numel() > 1024:
            out[name] = _topk_allreduce(g, axis, topk_ratio)
        elif compress_dtype == "int8_ring":
            out[name] = quantized_allreduce(g, axis, wire="int8")
        elif _is_int8(compress_dtype):
            out[name] = quantized_allreduce(g, axis)
        elif compress_dtype is not None and g.dtype != compress_dtype:
            out[name] = _pmean(g.to(compress_dtype), axis).to(g.dtype)
        else:
            out[name] = _pmean(g, axis)
    return out


def _madd(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
          ) -> torch.Tensor:
    """a·b + c in f32 with one rounding: XLA contracts the reference's
    multiply-add into an FMA.  The f64 product of two f32 values is
    exact, and here the sum is too (q·grid lies within a few grid steps
    of c, or c is a chunk of like magnitude), so its rounding to f32 is
    the FMA's."""
    return (a.double() * b.double() + c.double()).float()


def _quantize(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Codes of x on `grid`, rounded half to even, clipped to ±127 (f32
    values)."""
    return torch.clamp(torch.round(x / grid), -127, 127)


def quantized_allreduce(x: torch.Tensor, axis: str = "data",
                        block: int = 256, wire: str = "int32"):
    """Int8 blockwise-quantized mean-allreduce.  Per-block scales are
    agreed by a MAX allreduce, so every rank quantizes onto the same grid
    s = absmax/127.

    wire="int32": quantize once, sum the codes in int32 (error at most
    s/2 an element at any world size; the wire carries int32).
    wire="int8": the ring reduce-scatter of int8 codes, requantized each
    hop onto a widened grid, then an int8 all-gather
    (`_ring_int8_allreduce`)."""
    if wire not in ("int32", "int8"):
        raise ValueError(f"wire must be 'int32' or 'int8', got {wire!r}")
    if not axis_bound(axis):
        return x
    _staged("quantized_allreduce", x, axis, wire=wire)
    if wire == "int8":
        return _ring_int8_allreduce(x, axis, block)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = _pmax(blocks.abs().amax(dim=1, keepdim=True), axis)
    scale = torch.where(absmax > 0, absmax * _recip(127),
                        torch.ones_like(absmax))
    q = _quantize(blocks, scale).to(torch.int8)
    total = _reduce(q.to(torch.int32), dist.ReduceOp.SUM, axis)
    out = total.float() * scale * _recip(axis_size(axis))
    out = out.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(orig_shape).to(orig_dtype)


def _ring_int8_allreduce(x: torch.Tensor, axis: str, block: int,
                         with_error: bool = False):
    """Ring reduce-scatter + all-gather with int8 payloads.

    Each of the W-1 hops requantizes the running partial sum onto grid
    s·(t+1) and sends the int8 codes one rank forward; the final chunk
    sums are requantized onto s·W and all-gathered as int8.  Every scale
    is a consensus value, so the decode is bitwise deterministic and the
    same on every rank.  ``with_error=True`` also returns this rank's
    quantization error on the hop-0 grid, x − dequant(quant(x, s)): the
    residual error feedback carries to the next step."""
    W = axis_size(axis)
    r = axis_index(axis)
    orig_shape, orig_dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    n = flat.numel()
    C = _ring_chunk(n, W, block)
    pad = W * C - n
    if pad:
        flat = F.pad(flat, (0, pad))
    chunks = flat.reshape(W, C)
    blocks = chunks.reshape(W, C // block, block)
    absmax = _pmax(blocks.abs().amax(dim=2), axis)          # (W, C/b)
    s = torch.where(absmax > 0, absmax * _recip(127),
                    torch.ones_like(absmax))

    def grid_for(c: int, mult: float) -> torch.Tensor:
        return torch.repeat_interleave(s[c] * mult, block)  # (C,)

    fwd = [(i, (i + 1) % W) for i in range(W)]
    partial = chunks[r]
    for t in range(W - 1):
        c_send = (r - t) % W
        q = _quantize(partial, grid_for(c_send, float(t + 1))).to(torch.int8)
        q_recv = _ppermute(q, fwd, axis)                    # int8 wire
        c_recv = (r - t - 1) % W
        partial = _madd(q_recv.float(), grid_for(c_recv, float(t + 1)),
                        chunks[c_recv])
    c_own = (r + 1) % W
    q_final = _quantize(partial, grid_for(c_own, float(W))).to(torch.int8)
    all_q = _gather(q_final, axis)                          # (W, C) int8
    # rank (c-1) % W owns chunk c after the ring: undo the rotation
    codes = torch.roll(all_q, 1, 0).float()
    # mean = sum/W = codes * (s*W)/W = codes * s
    out = (codes.reshape(W, C // block, block) * s[:, :, None]).reshape(-1)
    if pad:
        out = out[:-pad]
    out = out.reshape(orig_shape).to(orig_dtype)
    if not with_error:
        return out
    grid = torch.repeat_interleave(s.reshape(-1), block)    # (W*C,)
    err = _madd(-_quantize(flat, grid), grid, flat)
    if pad:
        err = err[:-pad]
    return out, err.reshape(orig_shape)


def ef_quantized_allreduce(x: torch.Tensor, residual: torch.Tensor,
                           axis: str = "data", block: int = 256):
    """The int8-ring mean-allreduce with error feedback, behind
    ``DistOpt(compression="int8_ring")``: returns ``(mean,
    new_residual)``.  The f32 residual is added to x before
    quantization and refilled with what the compensated payload lost on
    the hop-0 grid.  Outside a bound axis, ``(x, residual)``."""
    if not axis_bound(axis):
        return x, residual
    _staged("quantized_allreduce", x, axis, wire="int8", ef=True)
    _emit_wire_counters(x.numel(), axis, "int8_ring", block)
    comp = x.float() + residual
    out, err = _ring_int8_allreduce(comp, axis, block, with_error=True)
    return out.to(x.dtype), err.float()


def _topk_allreduce(g: torch.Tensor, axis: str, ratio: float):
    """Fixed-K sparsified allreduce: each rank contributes its K entries
    of largest magnitude, exchanged by all-gather and scatter-added into
    a dense mean.  Where magnitudes tie, ``torch.topk`` may pick other
    entries than ``jax.lax.top_k``, and the scatter-add sums duplicate
    indices in an order of its own."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    idx = torch.topk(flat.abs(), k).indices
    vals = flat[idx]
    w = axis_size(axis)
    all_vals = _gather(vals, axis)
    all_idx = _gather(idx, axis)
    dense = torch.zeros_like(flat).index_add_(
        0, all_idx.reshape(-1), all_vals.reshape(-1) * _recip(w))
    return dense.reshape(g.shape)
