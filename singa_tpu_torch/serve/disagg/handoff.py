"""KV block handoff between serving engines, ported from
``singa_tpu/serve/disagg/handoff.py``.

The paged arena makes a finished prefill cheap to move: it is KV blocks
plus a block-table row.  A handoff never reshapes a tensor —

* the SOURCE (a prefill worker) gathers the slot's dense per-layer
  views through its block-table row with ``ops.kv_cache.
  gather_block_kv``: the engine's handoff program, captured on a card
  like the others, which writes one static buffer per layer.  The next
  extract overwrites that buffer, and a router may hold several
  packages before it injects any, so the package COPIES the slot's
  ``n_blocks * block_size`` positions out of it before the slot is
  released;
* the DESTINATION (a decode worker) maps the same logical block
  sequence onto its own physical blocks: blocks whose prefix chain
  keys are already resident are matched COPY-FREE (``match_prefix`` —
  refcounts and prefix-cache keys transfer with the blocks, so a
  tenant's shared system prompt crosses once per decode worker, not
  once per request), the rest are written IN PLACE with
  ``scatter_block_kv``, one block write per (block, layer).  The
  destination's captured decode and verify programs read its arena and
  token vector by address, so nothing is rebound.

The request itself (prompt, tokens so far, deadline, handle, trace id)
is host state and travels inside the :class:`HandoffPackage`.  After
injection the destination continues the stream mid-flight: its slot's
position is the replay length minus one and its token entry is the
prefill's first token, the state a local prefill would have left — so
disaggregated greedy streams equal a single engine's bitwise.

Copy-free matching rests on the prefix cache's invariant: a chain key
commits to every token of the prefix, and a full prompt block's KV is
a deterministic function of those tokens under the shared weights.

These functions are the implementation behind
``ServeEngine.extract_handoff`` / ``inject_handoff`` /
``can_accept_handoff``; they reach into engine and pool internals by
design (same subsystem package).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ...model import _sync
from ...obs import attr as obs_attr
from ...ops import kv_cache as kv_ops
from ..scheduler import RUNNING, Request

__all__ = ["HandoffPackage", "extract", "inject", "can_accept"]


@dataclass
class HandoffPackage:
    """One prefilled request in flight between workers: the host-side
    request state plus its KV and the prefix keys that let the
    destination map shared blocks copy-free."""

    req: Request
    #: per layer (dense_k, dense_v), shape (1, n_blocks * block_size,
    #: K, D): the slot's valid blocks, owned by the package (on the
    #: source's device, or on the host after the wire codec)
    kv: list
    #: valid cache positions (== replay length - 1 == the per-slot
    #: ``pos`` the destination activates with)
    pos: int
    #: logical blocks the destination must map (shared + copied)
    n_blocks: int
    #: chain keys of the request's FULL prompt blocks ([] when the
    #: source pool has prefix sharing disabled)
    prompt_keys: List[bytes] = field(default_factory=list)
    #: source worker name (events and debugging only)
    src: str = ""
    #: speculative tier: the DRAFT model's dense per-layer views of the
    #: same blocks (None when the source carries no draft) — without
    #: them the destination's verify rounds would start from a cold
    #: draft cache and accept nothing
    draft_kv: Optional[list] = None


def _dense_buffers(engine) -> list:
    """The handoff program's static outputs: one (1, max_blocks *
    block_size, K, D) buffer per layer and k/v, target then draft, in
    the dtype the gather yields (an int8 arena dequantizes to f32)."""
    pool = engine.pool
    n = pool.max_blocks * pool.block_size
    out = []
    for ck, cv in pool.caches + (pool.draft_caches or []):
        out.append(tuple(
            torch.empty((1, n) + tuple(c.shape[2:]),
                        dtype=(torch.float32
                               if isinstance(c, kv_ops.QuantKV)
                               else c.dtype), device=pool.device)
            for c in (ck, cv)))
    return out


def _gather(engine, slot: int) -> None:
    """One handoff-program dispatch for ``slot``, timed for the runtime
    attribution ledger when one is installed (the device synchronised
    around it, as ``ServeEngine._dispatch`` does).  The gather bypasses
    ``_dispatch`` because it must not retry: a retried gather after a
    partial failure could ship a torn package."""
    if engine._hout is None:
        engine._hout = _dense_buffers(engine)
    host = torch.tensor([slot], dtype=torch.int64)
    if engine._device.type == "cuda":
        host = host.pin_memory()
    engine._hslot.copy_(host, non_blocking=True)
    led = obs_attr.get()
    if led is None:
        engine._handoff()
        return
    _sync(engine._device)
    t0 = time.perf_counter()
    engine._handoff()
    _sync(engine._device)
    led.note("handoff_gather", time.perf_counter() - t0)


def extract(engine, slot: int) -> HandoffPackage:
    """Pull the request in ``slot`` out of ``engine`` (see the module
    docstring).  The gather and the copy run BEFORE any bookkeeping
    changes and the gather writes nothing of the arena, so a failure at
    any point leaves the source arena and request map consistent — the
    request is still withdrawable for a re-route."""
    req = engine._running[slot]
    pool = engine.pool
    n_blocks = pool.mapped_count(slot)
    # the slot's device position == replay length - 1 by construction
    # (prefill activates at the replay length and delivers one token;
    # every decode tick advances both): no device fetch needed
    pos = req.replay_ids().size - 1
    _gather(engine, slot)
    n = n_blocks * pool.block_size
    owned = [(k[:, :n].clone(), v[:, :n].clone()) for k, v in engine._hout]
    nt = len(pool.caches)
    dense = owned[:nt]
    draft_kv = owned[nt:] if pool.draft_caches is not None else None
    keys = engine._req_keys(req)[:req.prompt.size // pool.block_size]
    # point of no return: only after the copy is enqueued (stream
    # order puts it before any later write to the released blocks)
    engine._running.pop(slot)
    pool.release(slot)
    req.slot = None
    engine.flight.note("counter", "serve.handoff_out", rid=req.rid,
                       blocks=n_blocks)
    return HandoffPackage(req=req, kv=dense, pos=pos, n_blocks=n_blocks,
                          prompt_keys=keys, draft_kv=draft_kv)


def _probe(engine, pkg: HandoffPackage):
    """(n_shared, n_lru) of the destination's resident-prefix coverage
    for this package (side-effect free)."""
    if not engine.share_prefix or not pkg.prompt_keys:
        return 0, 0
    return engine.pool.probe_prefix(
        pkg.req.prompt, len(pkg.prompt_keys), keys=pkg.prompt_keys)


def can_accept(engine, pkg: HandoffPackage) -> bool:
    """A free slot and coverable blocks on ``engine`` for ``pkg``,
    counting resident shared-prefix blocks (claiming LRU-parked ones
    consumes availability, as in admission)."""
    if engine.pool.free_count < 1:
        return False
    n_shared, n_lru = _probe(engine, pkg)
    return (engine.pool.available_blocks - n_lru
            >= pkg.n_blocks - n_shared)


def _on(pairs, device):
    """Per-layer (k, v) on ``device`` (one copy per tensor that is not
    there yet: a package decoded from the wire is on the host)."""
    return [(torch.as_tensor(k).to(device), torch.as_tensor(v).to(device))
            for k, v in pairs]


def inject(engine, pkg: HandoffPackage) -> bool:
    """Install ``pkg`` into ``engine`` mid-stream (see the module
    docstring).  False when capacity is lacking — the caller parks the
    package; the destination is untouched."""
    if not can_accept(engine, pkg):
        return False
    req = pkg.req
    if not req.tokens:
        raise ValueError(f"handoff of request {req.rid} with no prefill "
                         f"token")
    pool = engine.pool
    bs = pool.block_size
    n_shared = 0
    shared_ids: List[int] = []
    if engine.share_prefix and pkg.prompt_keys:
        n_shared, shared_ids = pool.match_prefix(
            req.prompt, len(pkg.prompt_keys), keys=pkg.prompt_keys)
    slot = pool.alloc_slot()
    owned = pool.alloc_blocks(pkg.n_blocks - n_shared) or []
    assert slot is not None and len(owned) == pkg.n_blocks - n_shared, \
        "capacity vanished between can_accept and inject"
    pool.map_slot(slot, shared_ids + owned)
    try:
        if owned:
            # the destination block ids go up in ONE copy; each block
            # write reads a 0-d slice of it on the device
            ids = torch.tensor(owned, dtype=torch.int64)
            if pool.device.type == "cuda":
                ids = ids.pin_memory()
            ids = ids.to(pool.device, non_blocking=True)
            arenas = [(pool.caches, _on(pkg.kv, pool.device))]
            if pool.draft_caches is not None and pkg.draft_kv is not None:
                # the draft arena maps the SAME physical block ids
                arenas.append((pool.draft_caches,
                               _on(pkg.draft_kv, pool.device)))
            for i in range(len(owned)):
                lo = (n_shared + i) * bs
                for caches, views in arenas:
                    for (ck, cv), (dk, dv) in zip(caches, views):
                        kv_ops.scatter_block_kv(ck, cv, ids[i],
                                                dk[0, lo:lo + bs],
                                                dv[0, lo:lo + bs])
        if engine.share_prefix and pkg.prompt_keys:
            pool.register_prefix(req.prompt, slot, len(pkg.prompt_keys),
                                 keys=pkg.prompt_keys)
        pool.activate(slot, pkg.pos)
        # decode reads the slot's LAST token as its next input
        engine._toks[slot].fill_(int(req.tokens[-1]))
    except BaseException:
        # unwind the claim so a mid-scatter failure cannot leak the
        # destination slot or blocks: release() drops the mapping
        # (partially written content is unreachable, as any stale
        # block).  The caller re-routes.
        pool.release(slot)
        raise
    req.slot = slot
    req.state = RUNNING
    engine._running[slot] = req
    engine.flight.note("counter", "serve.handoff_in", rid=req.rid,
                       blocks=pkg.n_blocks, shared=n_shared)
    return True
