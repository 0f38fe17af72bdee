"""Paged KV-cache arena for continuous-batching inference, ported from
``singa_tpu/serve/slots.py`` (``BlockPool``).

The per-layer cache is a pool of ``num_blocks`` fixed-size blocks of
``block_size`` tokens — ``(num_blocks, block_size, K, D)`` tensors —
and each request maps the blocks its length actually needs through a
device-resident ``(num_slots, max_blocks)`` **block table**.  The
engine's two programs never see physical block identities as shapes:
prefill and decode gather a request's dense view with
``ops.kv_cache.gather_block_kv`` and scatter written positions back
with ``scatter_block_kv`` / ``scatter_token_kv``, so admitting,
growing, evicting and re-mapping requests are index updates.

**Static storage.**  The engine captures its programs as CUDA graphs,
which read fixed addresses.  So every device tensor here — the arena,
``tables``, ``pos`` and ``active`` — is made once and only ever written
in place: a host-side update copies a row into the existing table
(from pinned memory, without a host sync) or fills one element, and
:meth:`reset` (arena recovery) zeroes the same storage instead of
building a new pool.  Rebinding one of these names would leave the next
replay reading the old tensor, silently.

**Prefix-cache sharing** rides the block pool: every FULL prompt block
gets a chain hash key (blake2b over the block's tokens and its
ancestor's key, so a key identifies the whole prefix up to and
including the block).  A new request whose leading prompt blocks are
already resident maps them copy-free (refcount bump, no prefill) and
prefills only the unshared suffix.  Refcounts govern the lifecycle:

* a mapped block has ``ref >= 1`` (one per slot mapping it);
* when the last mapping is released, a KEYED block parks in an LRU
  pool of evictable blocks (content intact — the next request with the
  same prefix reuses it) while an unkeyed block returns to the free
  list immediately;
* allocation takes from the free list first, then evicts the LRU
  evictable block — eviction *asserts* ``ref == 0``, so evicting a
  block while any request references it is impossible by construction.

Physical block 0 is the reserved **null block**: never allocated, it
is the redirect target for unmapped table entries and masked decode
writes.  Its contents are garbage by design — every reader masks cache
positions past its own validity window (``cached_sdpa``'s per-row
``limit``), so the null block (like any stale table entry) is
unreachable.

The memory hierarchy (``serve/mem.py``): ``kv_dtype="int8"`` stores
blocks as int8 codes plus per-position scales (``QuantKV``), and a
``spill`` store takes the exact bytes of every keyed block the arena
reclaims, to be restored on its next prefix hit.  Speculative decoding
adds the DRAFT arena: a second per-layer pool on the same block tables.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from . import mem

__all__ = ["BlockPool"]

#: chain-hash seed of the empty prefix (the reference's, so both
#: packages key a prefix alike)
_ROOT = b"singa-kv-prefix-root"


def _chain_keys(tokens: np.ndarray, n_blocks: int, block_size: int
                ) -> List[bytes]:
    """Keys of the first ``n_blocks`` FULL blocks of ``tokens``; key i
    commits to every token in blocks 0..i, so equal keys mean equal
    whole prefixes (not just equal block contents)."""
    keys, prev = [], _ROOT
    for i in range(n_blocks):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(tokens[i * block_size:(i + 1) * block_size]
                 .astype("<i4").tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class BlockPool:
    """Paged arena of ``num_blocks`` KV blocks behind ``num_slots``
    block-table rows.

    Host side: slot free list, block free list, per-block refcounts,
    the prefix cache (chain key -> block), the evictable LRU and the
    spill store.  Device side (static, written in place): the per-layer
    block pools (target and draft), the ``(num_slots, max_blocks)``
    block tables, and the per-slot ``pos``/``active`` vectors the decode
    and verify programs read.
    """

    def __init__(self, model, num_slots: int, max_len: int, *,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 dtype=None, draft_model=None, kv_dtype=None,
                 draft_kv_dtype=None,
                 spill: Optional[mem.SpillStore] = None):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)
        if num_blocks is None:
            # capacity parity with a fixed arena (+ null block): every
            # slot can hold a full-length request at once
            num_blocks = num_slots * self.max_blocks + 1
        if num_blocks < self.max_blocks + 1:
            raise ValueError(
                f"num_blocks ({num_blocks}) must cover the largest "
                f"request plus the null block (>= {self.max_blocks + 1} "
                f"for max_len {max_len} at block_size {block_size})")
        self.num_blocks = num_blocks
        # per-arena storage format (None = full precision, "int8" =
        # QuantKV codes + scales): the draft arena takes the target's
        # unless overridden, so the referee configuration (int8
        # proposer, full-precision target) is draft_kv_dtype="int8"
        self.kv_dtype = mem.normalize_kv_dtype(kv_dtype)
        self.draft_kv_dtype = (self.kv_dtype if draft_kv_dtype is None
                               else mem.normalize_kv_dtype(draft_kv_dtype))
        # `dtype` is the serving dtype (e.g. bf16 under a param_dtype
        # cast); an int8 arena's codes and scales have theirs by contract
        self.caches = self._arena(model, self.kv_dtype, dtype)
        # speculative decoding: the DRAFT model's KV blocks ride the
        # SAME block tables, a second per-layer pool with the same
        # (num_blocks, block_size) leading dims, so every mapping
        # decision covers both arenas with one index update.  The
        # serving dtype applies to both: under self-speculation a
        # full-precision draft arena would let the draft's and the
        # target's argmaxes diverge by reading different-precision KV
        self.draft_model = draft_model
        self.draft_caches = (None if draft_model is None else
                             self._arena(draft_model, self.draft_kv_dtype,
                                         dtype))
        dev = self.device = mem._leaves(self.caches)[0].device
        self.tables = torch.zeros((num_slots, self.max_blocks),
                                  dtype=torch.int64, device=dev)
        self.pos = torch.zeros((num_slots,), dtype=torch.int64, device=dev)
        self.active = torch.zeros((num_slots,), dtype=torch.bool,
                                  device=dev)
        #: bytes ONE physical block occupies across every arena leaf
        #: (target + draft, codes + scales)
        self.block_bytes = mem.arena_block_bytes(self.caches,
                                                 self.draft_caches)
        # spill tier: evicted keyed blocks land in the store instead of
        # dying; the engine wires the callbacks (metrics, incidents)
        self.spill = spill
        self.on_spill = None        # callable(n_blocks)
        self.on_prefetch = None     # callable(n_blocks, wait_ms)
        self.on_spill_fault = None  # callable(op, exc)
        self.restore: Optional[mem.Restore] = None   # made at first use
        self._reset_host()

    def _arena(self, model, kv_dtype, dtype):
        if kv_dtype == "int8":
            return mem.quant_arena(model, self.num_blocks, self.block_size)
        return mem.full_arena(model, self.num_blocks, self.block_size, dtype)

    def _reset_host(self) -> None:
        # LIFO reuse: the most recently freed slot/block is re-used
        # first (hottest in the cache hierarchy)
        self._free_slots: List[int] = list(range(self.num_slots - 1, -1, -1))
        self._free_blocks: List[int] = list(range(self.num_blocks - 1, 0,
                                                  -1))
        self._mapped: List[List[int]] = [[] for _ in range(self.num_slots)]
        self.ref = np.zeros((self.num_blocks,), np.int64)
        self._key_of: Dict[int, bytes] = {}     # block -> chain key
        self._block_of: Dict[bytes, int] = {}   # chain key -> block
        # refcount-0 keyed blocks, oldest first (eviction order)
        self._lru: "OrderedDict[int, None]" = OrderedDict()

    def reset(self) -> None:
        """Arena recovery: every slot free, every block free and
        unreferenced, the prefix cache empty, and the device storage —
        target and draft arenas, codes and scales — zeroed IN PLACE (the
        same tensors, so captured programs stay valid and nothing is
        recaptured).  The spill store is kept: its chain keys commit to
        prefix content, not to arena state."""
        for t in mem._leaves(self.caches) + mem._leaves(self.draft_caches):
            t.zero_()
        self.tables.zero_()
        self.pos.zero_()
        self.active.zero_()
        self._reset_host()

    # -- slot bookkeeping -------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free_slots)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free_slots)

    def alloc_slot(self) -> Optional[int]:
        """Claim a free block-table row, or None when every row is live
        (the scheduler's signal to keep the request queued)."""
        return self._free_slots.pop() if self._free_slots else None

    # -- block accounting -------------------------------------------------
    @property
    def available_blocks(self) -> int:
        """Blocks an allocation could obtain right now: the free list
        plus the evictable (refcount-0) prefix blocks."""
        return len(self._free_blocks) + len(self._lru)

    @property
    def blocks_in_use(self) -> int:
        """Blocks currently referenced by at least one mapped slot."""
        return int((self.ref > 0).sum())

    @property
    def blocks_in_use_bytes(self) -> int:
        """Device bytes those blocks pin across BOTH arenas (target +
        draft, int8 codes AND f32 scales)."""
        return self.blocks_in_use * self.block_bytes

    def mapped_count(self, slot: int) -> int:
        return len(self._mapped[slot])

    def _evict_lru(self) -> int:
        block, _ = self._lru.popitem(last=False)
        # the invariant the prefix cache stands on: only a block no
        # request references may ever be reclaimed
        assert self.ref[block] == 0, \
            f"evicting block {block} with refcount {self.ref[block]}"
        key = self._key_of.pop(block, None)
        if key is not None and self._block_of.get(key) == block:
            del self._block_of[key]
            if self.spill is not None:
                self._spill_block(key, block)
        return block

    # -- spill tier (serve/mem.py) ----------------------------------------
    def _spill_block(self, key: bytes, block: int) -> None:
        """Spill-write seam: enqueue the evicted keyed block's copy into
        the host store BEFORE the arena reclaims the physical block (on
        the current stream, ahead of any program that may overwrite
        it).  An injected ``serve.spill`` fault skips the spill: the
        block dies as it did before the spill tier (a prefix-cache miss
        later, never a changed stream)."""
        try:
            faults.fire("serve.spill", op="spill", block=block)
        except (RuntimeError, OSError) as e:
            if self.on_spill_fault is not None:
                self.on_spill_fault("spill", e)
            return
        self.spill.put(key, mem.read_block(self.caches, self.draft_caches,
                                           block))
        if self.on_spill is not None:
            self.on_spill(1)

    def _stage_restore(self, key: bytes) -> Optional[Tuple[int, dict]]:
        """Prefetch-read seam: claim an available physical block — a
        free one, else by evicting the coldest refcount-0 LRU block
        (which itself spills) — and pop the spilled payload for it.
        Returns ``(block, payload)``, or None on a store miss / no
        claimable block / injected fault (each degrades to a plain
        prefix miss: the suffix prefills normally).  The device write
        is deferred to :meth:`_commit_restores`, so an admission
        restoring several blocks pays one batched restore."""
        if self.spill is None or key not in self.spill \
                or not (self._free_blocks or self._lru):
            return None
        try:
            faults.fire("serve.spill", op="prefetch")
        except (RuntimeError, OSError) as e:
            if self.on_spill_fault is not None:
                self.on_spill_fault("prefetch", e)
            return None
        payload = self.spill.get(key)
        if (payload["draft"] is None) != (self.draft_caches is None):
            return None  # arena shape changed under the store
        self.spill.pop(key)
        block = (self._free_blocks.pop() if self._free_blocks
                 else self._evict_lru())
        return block, payload

    def _commit_restores(self, restores: List[Tuple[bytes, int, dict]]
                         ) -> None:
        """Land an admission's staged restores through the restore
        program (one dispatch per ``mem.RESTORE_BATCH`` blocks), then
        key the blocks resident.  ``wait_ms`` is the host time the
        admission spent enqueueing them."""
        t0 = time.perf_counter()
        if self.restore is None:
            self.restore = mem.Restore(self.caches, self.draft_caches)
        mem.write_blocks(self.restore, [b for _, b, _ in restores],
                         [p for _, _, p in restores])
        for key, block, _ in restores:
            self._key_of[block] = key
            self._block_of[key] = block
        if self.on_prefetch is not None:
            self.on_prefetch(len(restores),
                             (time.perf_counter() - t0) * 1e3)

    def alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` physical blocks (all-or-nothing), evicting LRU
        prefix blocks as needed.  None when fewer than ``n`` are
        obtainable — the caller's cue to defer admission or preempt."""
        if self.available_blocks < n:
            return None
        out = []
        for _ in range(n):
            out.append(self._free_blocks.pop() if self._free_blocks
                       else self._evict_lru())
        return out

    def free_blocks(self, blocks: List[int]) -> None:
        """Return unmapped, unkeyed blocks straight to the free list
        (the cleanup path of an admission that failed between
        allocation and mapping)."""
        for b in blocks:
            assert self.ref[b] == 0 and b not in self._key_of
            self._free_blocks.append(b)

    def unref_shared(self, blocks: List[int]) -> None:
        """Drop the references :meth:`match_prefix` took, without a
        slot mapping to release through (the cleanup path of an
        admission that failed before :meth:`map_slot`)."""
        for b in blocks:
            assert self.ref[b] > 0
            self.ref[b] -= 1
            if self.ref[b] == 0:
                self._lru[b] = None
                self._lru.move_to_end(b)

    def release_slot_row(self, slot: int) -> None:
        """Hand back an UNMAPPED slot row (failed admission) — the
        block-side cleanup happened through :meth:`unref_shared` /
        :meth:`free_blocks`."""
        assert not self._mapped[slot]
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} double-freed")
        self._free_slots.append(slot)

    # -- prefix cache -----------------------------------------------------
    def prefix_keys(self, prompt: np.ndarray, n_blocks: int
                    ) -> List[bytes]:
        """Chain keys of ``prompt``'s first ``n_blocks`` full blocks —
        exposed so the engine can memoize them per request (they depend
        only on the immutable prompt) and pass them back via ``keys=``
        instead of re-hashing on every admission probe."""
        return _chain_keys(prompt, n_blocks, self.block_size)

    def probe_prefix(self, prompt: np.ndarray, limit_blocks: int,
                     keys: Optional[List[bytes]] = None
                     ) -> Tuple[int, int]:
        """How many leading full blocks of ``prompt`` are resident, and
        how many of those currently sit in the evictable LRU
        (side-effect free — the admission-feasibility check).  The LRU
        count matters because claiming those shared blocks REMOVES them
        from :attr:`available_blocks`: an admission is feasible only
        when ``available_blocks - n_in_lru`` covers the fresh blocks it
        must still allocate."""
        if keys is None:
            keys = _chain_keys(prompt, limit_blocks, self.block_size)
        n = n_lru = 0
        for key in keys[:limit_blocks]:
            block = self._block_of.get(key)
            if block is None:
                break
            n += 1
            if self.ref[block] == 0:
                n_lru += 1
        return n, n_lru

    def match_prefix(self, prompt: np.ndarray, limit_blocks: int,
                     keys: Optional[List[bytes]] = None
                     ) -> Tuple[int, List[int]]:
        """Claim the longest resident chain of leading full prompt
        blocks: each matched block's refcount is bumped (reactivating
        it out of the evictable LRU).  A key that misses residency but
        hits the spill store is restored into a free physical block and
        the chain continues — the restored block consumes exactly the
        one free block the conservative :meth:`probe_prefix`
        feasibility math already budgeted for its fresh allocation, so
        admission accounting is unchanged.  Returns (n_shared, block
        ids)."""
        if keys is None:
            keys = _chain_keys(prompt, limit_blocks, self.block_size)
        ids: List[int] = []
        restores: List[Tuple[bytes, int, dict]] = []
        for key in keys[:limit_blocks]:
            block = self._block_of.get(key)
            if block is None:
                staged = self._stage_restore(key)
                if staged is None:
                    break
                block, payload = staged
                restores.append((key, block, payload))
            if self.ref[block] == 0:
                self._lru.pop(block, None)
            self.ref[block] += 1
            ids.append(block)
        if restores:
            self._commit_restores(restores)
        return len(ids), ids

    def register_prefix(self, prompt: np.ndarray, slot: int,
                        n_blocks: int,
                        keys: Optional[List[bytes]] = None) -> None:
        """Key the first ``n_blocks`` (full, just-prefilled prompt)
        blocks of ``slot`` so later requests with the same prefix can
        map them.  A key already mapping another resident block is
        re-pointed here (the old holder keeps serving its refs but
        loses shareability — content is identical either way)."""
        if keys is None:
            keys = _chain_keys(prompt, n_blocks, self.block_size)
        row = self._mapped[slot]
        for i, key in enumerate(keys[:n_blocks]):
            block = row[i]
            if self._key_of.get(block) == key:
                continue                     # matched share, already keyed
            old = self._block_of.get(key)
            if old is not None and old != block:
                del self._key_of[old]
                if old in self._lru:         # keyless + unreferenced:
                    self._lru.pop(old)       # nothing can find it again
                    self._free_blocks.append(old)
            self._block_of[key] = block
            self._key_of[block] = key

    def map_slot(self, slot: int, blocks: List[int]) -> None:
        """Install ``blocks`` (shared prefix + freshly allocated, in
        logical order) as the slot's block table.  Shared blocks arrive
        with their refcount already bumped by :meth:`match_prefix`;
        fresh ones are claimed here."""
        assert not self._mapped[slot], f"slot {slot} already mapped"
        if len(blocks) > self.max_blocks:
            raise ValueError(
                f"{len(blocks)} blocks exceed max_blocks "
                f"({self.max_blocks})")
        self._mapped[slot] = list(blocks)
        for b in blocks:
            if self.ref[b] == 0:
                self.ref[b] = 1
        self._sync_table_row(slot)

    def append_block(self, slot: int, block: int) -> None:
        """Decode-time growth: one more block for a slot whose next
        token crosses a block boundary."""
        if len(self._mapped[slot]) >= self.max_blocks:
            raise ValueError(f"slot {slot} already at max_blocks")
        self._mapped[slot].append(block)
        self.ref[block] = 1
        self._sync_table_row(slot)

    def _sync_table_row(self, slot: int) -> None:
        """Write the slot's mapping into its existing table row: a
        non-blocking copy from pinned host memory (the caching host
        allocator keeps the staging buffer alive until the copy ran),
        so the host never waits on the card here."""
        row = torch.zeros((self.max_blocks,), dtype=torch.int64)
        mapped = self._mapped[slot]
        row[:len(mapped)] = torch.as_tensor(mapped, dtype=torch.int64)
        if self.device.type == "cuda":
            row = row.pin_memory()
        self.tables[slot].copy_(row, non_blocking=True)

    def release(self, slot: int) -> None:
        """Return the slot row to the free list and drop one reference
        from every block it mapped: keyed blocks park in the evictable
        LRU (content intact for the next prefix hit), unkeyed ones are
        freed.  Device-side cache rows are never scrubbed — stale
        blocks are unreachable past every reader's validity window."""
        if slot in self._free_slots:
            raise ValueError(f"slot {slot} double-freed")
        for b in self._mapped[slot]:
            assert self.ref[b] > 0
            self.ref[b] -= 1
            if self.ref[b] == 0:
                if b in self._key_of:
                    self._lru[b] = None
                    self._lru.move_to_end(b)
                else:
                    self._free_blocks.append(b)
        self._mapped[slot] = []
        self.active[slot].fill_(False)
        self.pos[slot].fill_(0)
        self._free_slots.append(slot)

    # -- device-side state transitions -----------------------------------
    def activate(self, slot: int, length: int) -> None:
        """Mark ``slot`` live with ``length`` valid cache positions
        (called after its prompt chunks were prefilled into its
        blocks)."""
        self.pos[slot].fill_(length)
        self.active[slot].fill_(True)

    def positions(self) -> np.ndarray:
        """Host copy of per-slot positions."""
        return self.pos.cpu().numpy()
