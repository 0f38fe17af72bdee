"""The KV arena's memory hierarchy, ported from ``singa_tpu/serve/mem.py``:
int8 KV blocks and a host-RAM spill tier for cold prefix blocks.

Serve concurrency is bounded by device memory, and the paged arena's
unit of management, the block, is the unit to compress and to spill.
:class:`~singa_tpu_torch.serve.slots.BlockPool` consumes this module and
:class:`~singa_tpu_torch.serve.engine.ServeEngine` exposes the knobs
(``kv_dtype=``, ``draft_kv_dtype=``, ``spill_blocks=``).

**Tier 1 — int8 KV blocks** (``kv_dtype="int8"``): the per-layer block
pools are :class:`~singa_tpu_torch.ops.kv_cache.QuantKV` pairs — int8
codes plus a per-position f32 absmax scale.  Quantize-on-scatter and
dequantize-on-gather live inside the paged kv ops, so an int8 engine
captures the same programs as a full-precision one.  Quantized KV
breaks greedy identity by construction, so its quality is read through
the speculative referee: the quantized arena as the draft's against a
full-precision target, whose accept rate is the quality number.

**Tier 2 — host-RAM prefix spill** (``spill_blocks=N``): refcount-0
prefix blocks that the arena reclaims are copied, in their exact device
representation (codes and scales for an int8 arena), into pinned host
memory instead of dying.  On the next prefix hit the block is restored
into a free physical block by the **restore program**, a
:class:`~singa_tpu_torch.serve.program.Program` of its own beside
prefill, decode and verify: it scatters a static device staging buffer
of :data:`RESTORE_BATCH` blocks into the arena at a static index
vector, and is captured at its second dispatch.  A spilled and restored
block round-trips bitwise, so the spill tier never changes a stream: it
turns a re-prefill into a copy.

Ordering without host syncs: :func:`read_block` enqueues each leaf's
device-to-host copy on the current stream into a fresh pinned tensor
(never a view of the arena), before any later program that may
overwrite the block; a restore enqueues the host-to-device staging
copies on the same stream before the restore program and the prefill
that reads the blocks.  Stream order alone keeps both right, and a
restore may even read a payload whose spill copy is still in flight.
:meth:`SpillStore.settle` waits on the spill copies' events after the
engine's token fetch, when they are done, so the host may read the
payloads; nothing here syncs the host elsewhere.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.kv_cache import QuantKV, dequantize_kv, quantize_kv
from .program import Program

__all__ = ["QuantKV", "quantize_kv", "dequantize_kv", "KV_DTYPES",
           "normalize_kv_dtype", "quant_arena", "full_arena",
           "arena_block_bytes", "arena_bytes", "SpillStore", "read_block",
           "Restore", "write_block", "write_blocks",
           "restore_compiled_count", "RESTORE_BATCH"]

#: accepted ``kv_dtype=`` spellings -> canonical form (None = the
#: model's native full-precision arena)
KV_DTYPES = {None: None, "f32": None, "full": None, "int8": "int8"}

#: spilled blocks restored per restore dispatch: a restore is padded up
#: to this batch (by repeating its first block, so duplicate indices
#: carry identical rows) and chunked above it, so the restore program's
#: inputs keep fixed shapes and it is captured once
RESTORE_BATCH = 8


def normalize_kv_dtype(kv_dtype) -> Optional[str]:
    """Canonicalize a ``kv_dtype=`` knob value (``None`` | ``"int8"``),
    rejecting typos loudly at construction."""
    if kv_dtype in KV_DTYPES:
        return KV_DTYPES[kv_dtype]
    raise ValueError(
        f"kv_dtype must be one of {sorted(k for k in KV_DTYPES if k)} "
        f"or None, got {kv_dtype!r}")


def _layer_specs(model):
    """Per layer, (trailing shape, dtype, device) of its k and v, read
    off a one-position cache, so no full-size float arena is made."""
    return [tuple((tuple(t.shape[2:]), t.dtype, t.device) for t in kv)
            for kv in model.init_caches(1, 1)]


def full_arena(model, num_blocks: int, block_size: int,
               dtype=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer zero ``(num_blocks, block_size, K, D)`` block pools in
    ``dtype`` (default: the dtype ``model.init_caches`` gives)."""
    return [tuple(torch.zeros((num_blocks, block_size) + shape,
                              dtype=dtype or dt, device=dev)
                  for shape, dt, dev in layer)
            for layer in _layer_specs(model)]


def quant_arena(model, num_blocks: int, block_size: int
                ) -> List[Tuple[QuantKV, QuantKV]]:
    """Per-layer ``(QuantKV, QuantKV)`` block pools shaped like
    ``model.init_caches(num_blocks, block_size)``: int8 codes and f32
    scales of shape ``(num_blocks, block_size, 1, 1)``."""
    def pool(shape, dev):
        lead = (num_blocks, block_size)
        return QuantKV(torch.zeros(lead + shape, dtype=torch.int8,
                                   device=dev),
                       torch.zeros(lead + (1,) * len(shape),
                                   dtype=torch.float32, device=dev))
    return [tuple(pool(shape, dev) for shape, _, dev in layer)
            for layer in _layer_specs(model)]


def _leaves(caches) -> List[torch.Tensor]:
    """Every tensor of a per-layer (k, v) arena: a QuantKV gives its
    codes then its scales."""
    out = []
    for kv in caches or ():
        for c in kv:
            out.extend((c.q, c.scale) if isinstance(c, QuantKV) else (c,))
    return out


def _map(caches, fn):
    """``caches`` with every leaf replaced by ``fn(leaf)``, structure
    (layers, (k, v), QuantKV) kept."""
    def one(c):
        if isinstance(c, QuantKV):
            return QuantKV(fn(c.q), fn(c.scale))
        return fn(c)
    return [tuple(one(c) for c in kv) for kv in caches]


def arena_block_bytes(caches, draft_caches=None) -> int:
    """Bytes ONE physical block occupies across every arena leaf —
    target + draft pools, int8 codes AND f32 scales.
    ``blocks_in_use * arena_block_bytes`` is the device footprint the
    ``serve.blocks_in_use_bytes`` gauge reports."""
    return sum(t[0].numel() * t.element_size()
               for t in _leaves(caches) + _leaves(draft_caches))


def arena_bytes(caches, draft_caches=None) -> int:
    """Total bytes of the block pools (every leaf, all blocks)."""
    return sum(t.numel() * t.element_size()
               for t in _leaves(caches) + _leaves(draft_caches))


def read_block(caches, draft_caches, block: int) -> Dict[str, Any]:
    """Snapshot physical ``block``'s exact device representation (the
    spill payload): every leaf of the target (and draft) pools at the
    block index, copied into a FRESH host tensor (pinned on a card, the
    copy non-blocking on the current stream), never a view of the
    arena, whose next write would change it.  On a card the payload
    carries the CUDA event recorded after its copies under
    ``"event"``; :meth:`SpillStore.settle` waits on it.  The same-dtype
    round trip through :func:`write_blocks` is bitwise."""
    def host(c):
        if c.device.type != "cuda":
            return c[block].clone()
        out = torch.empty(c.shape[1:], dtype=c.dtype, pin_memory=True)
        out.copy_(c[block], non_blocking=True)
        return out
    payload = {"kv": _map(caches, host),
               "draft": (None if draft_caches is None
                         else _map(draft_caches, host)),
               "event": None}
    if _leaves(caches)[0].device.type == "cuda":
        payload["event"] = torch.cuda.Event()
        payload["event"].record()
    return payload


#: every Restore made, for restore_compiled_count()
_RESTORES: "weakref.WeakSet[Restore]" = weakref.WeakSet()


class Restore:
    """The restore program of one arena (target and draft pools
    together): static device staging tensors of :data:`RESTORE_BATCH`
    blocks for every leaf, a static index vector, and the
    :class:`~singa_tpu_torch.serve.program.Program` that scatters the
    staging into the arena at those indices.  Made at the first
    restore; the arena is zeroed in place on recovery, so the program
    outlives it."""

    def __init__(self, caches, draft_caches):
        self.arena = _leaves(caches) + _leaves(draft_caches)
        dev = self.device = self.arena[0].device
        self.staging = [torch.zeros((RESTORE_BATCH,) + tuple(t.shape[1:]),
                                    dtype=t.dtype, device=dev)
                        for t in self.arena]
        self.idx = torch.zeros((RESTORE_BATCH,), dtype=torch.int64,
                               device=dev)
        self.program = Program("restore", self._body, dev)
        _RESTORES.add(self)

    def _body(self) -> None:
        for leaf, stage in zip(self.arena, self.staging):
            leaf.index_copy_(0, self.idx, stage)

    def write(self, blocks: List[int], payloads: List[Dict[str, Any]]
              ) -> None:
        """Stage up to RESTORE_BATCH payloads (padded by repeating the
        first) and dispatch the restore program; the staging copies are
        enqueued on the current stream ahead of it."""
        pad = RESTORE_BATCH - len(blocks)
        blocks = list(blocks) + list(blocks[:1]) * pad
        payloads = list(payloads) + list(payloads[:1]) * pad
        cuda = self.device.type == "cuda"
        idx = torch.tensor(blocks, dtype=torch.int64)
        self.idx.copy_(idx.pin_memory() if cuda else idx, non_blocking=True)
        for j, p in enumerate(payloads):
            src = _leaves(p["kv"]) + _leaves(p["draft"])
            for stage, h in zip(self.staging, src, strict=True):
                stage[j].copy_(h, non_blocking=True)
        self.program()


def write_blocks(restore: Restore, blocks: List[int],
                 payloads: List[Dict[str, Any]]) -> None:
    """Write :func:`read_block` payloads back into physical ``blocks`` of
    ``restore``'s arena, in place — one restore dispatch per
    :data:`RESTORE_BATCH` chunk."""
    for i in range(0, len(blocks), RESTORE_BATCH):
        restore.write(blocks[i:i + RESTORE_BATCH],
                      payloads[i:i + RESTORE_BATCH])


def write_block(restore: Restore, block: int,
                payload: Dict[str, Any]) -> None:
    """Single-block :func:`write_blocks`."""
    write_blocks(restore, [block], [payload])


def restore_compiled_count(restore: Optional[Restore] = None) -> int:
    """Programs the restore has made for ``restore``'s arena: 0 before
    its first restore, then 1 (a card captures it at the second), never
    more.
    Without an argument, the most that any live arena's restore has
    made."""
    if restore is not None:
        return restore.program.count
    return max((r.program.count for r in list(_RESTORES)), default=0)


class SpillStore:
    """Bounded host-RAM LRU of spilled prefix blocks, keyed by the
    pool's content-addressed chain keys.  Because a chain key commits
    to every token of the whole prefix (and block content is a
    deterministic function of those tokens under the shared weights),
    entries stay valid across arena resets — recovery keeps the store,
    so a tenant's system prompt survives even an arena recovery.
    Capacity overflow drops the OLDEST entry (those blocks simply
    re-prefill on their next hit, the pre-spill behavior)."""

    def __init__(self, max_blocks: int = 256):
        if max_blocks < 1:
            raise ValueError(
                f"spill capacity must be >= 1 block, got {max_blocks}")
        self.max_blocks = int(max_blocks)
        self._data: "OrderedDict[bytes, Dict[str, Any]]" = OrderedDict()
        #: keys whose spill copies may still be in flight
        self._lazy: set = set()
        #: entries dropped for capacity (cumulative)
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: bytes) -> bool:
        return key in self._data

    @property
    def bytes(self) -> int:
        """Host bytes currently held (payload tensors only)."""
        return sum(t.numel() * t.element_size()
                   for p in self._data.values()
                   for t in _leaves(p["kv"]) + _leaves(p["draft"]))

    def settle(self) -> None:
        """Wait on every pending payload's copy event, so the host may
        read the payloads.  The engine calls this at the end of each
        step, right after the step's token fetch synchronised the
        stream, so the copies are done and this waits for nothing."""
        for key in self._lazy:
            event = self._data[key].get("event")
            if event is not None:
                event.synchronize()
                self._data[key]["event"] = None
        self._lazy.clear()

    def put(self, key: bytes, payload: Dict[str, Any]) -> None:
        self._data[key] = payload
        self._lazy.add(key)
        self._data.move_to_end(key)
        while len(self._data) > self.max_blocks:
            dropped, _ = self._data.popitem(last=False)
            self._lazy.discard(dropped)
            self.evictions += 1

    def get(self, key: bytes) -> Optional[Dict[str, Any]]:
        """The payload under ``key`` (now the hottest), or None.  Its
        copies may still be in flight: a restore reads it in stream
        order; a host reader calls :meth:`settle` first."""
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def pop(self, key: bytes) -> Optional[Dict[str, Any]]:
        """Remove and return the payload under ``key`` (or None)."""
        self._lazy.discard(key)
        return self._data.pop(key, None)
