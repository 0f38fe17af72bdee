"""Speculative decoding over the paged KV arena, ported from
``singa_tpu/serve/spec.py``.

Decode is memory-bound: every tick reads the whole weight and KV
working set to emit one token per slot.  Speculative decoding raises
the tokens per dispatch instead: a small DRAFT model proposes ``k``
tokens per slot, and the target scores all ``k + 1`` window positions
in ONE **verify** program — the third program, beside prefill and
decode, captured as a CUDA graph on a card.

One verify round (``k`` is a constant of the program):

1. **propose** — the draft runs ``k + 1`` single-token steps over its
   own dense view (gathered through the SAME block tables as the
   target's: the draft arena is a parallel pool in
   :class:`~singa_tpu_torch.serve.slots.BlockPool`), greedily picking
   ``d1..dk`` from the pending token ``t0``.  The extra (k+1)-th step
   only writes ``dk``'s draft KV, so a fully accepted round leaves no
   gap in the draft cache.
2. **verify** — the target scores the window ``[t0, d1..dk]`` at
   per-slot positions in one ``(num_slots, k+1)`` forward and both
   arenas take the window's KV (``ops.kv_cache.scatter_tokens_kv``).
3. **accept + commit/rollback** — the accepted run is the longest
   prefix of proposals equal to the target's own greedy picks; the
   delivered tokens are the TARGET's argmaxes (``cand[:, :a+1]``), so
   the draft can change only HOW MANY target picks one dispatch yields.
   Rejected positions roll back by TRUNCATING the slot's position
   (``pos + a + 1``): the stale KV past it is unreachable and is
   overwritten by the next round.

Everything the round writes is static storage written in place: the
token vector, the positions, both arenas, and one (num_slots, k + 2)
output tensor — per-slot accepted counts in column 0, the target's
k + 1 picks after them — which the host fetches in ONE sync per round.

The streams equal ``generate()``'s as far as the target's (S, k+1)
window forward picks the argmaxes its S-row decode step picks: on the
CPU in f32 the tests hold them bitwise, and ``chip_smoke.py`` holds the
bf16 streams on the card bitwise to the plain engine's.

Fault containment (site ``serve.verify``): a verify dispatch failing
past its retries raises :class:`VerifyDispatchFailed`, and the engine
runs a plain decode tick instead — nothing was committed, the stream is
unaffected, and only the draft cache takes a gap at that position.

``resume_on_row``/``scatter_chunk`` are the two halves of every
prefill-chunk program, plain and speculative, so their semantics cannot
drift apart.
"""

from __future__ import annotations

import time

import torch

from ..models._generate import _bound, decode_step, resume_step
from ..obs import events
from ..obs import trace as obs_trace
from ..ops import kv_cache as kv_ops

__all__ = ["make_spec_prefill", "make_verify", "verify_round",
           "VerifyDispatchFailed", "resume_on_row", "scatter_chunk"]


class VerifyDispatchFailed(RuntimeError):
    """The verify DISPATCH died past its retry budget (injection site
    ``serve.verify`` or a pre-launch transient).  The only exception
    the engine's ``_spec_tick`` turns into a plain-decode fallback: at
    that point nothing was committed, so a plain tick on the untouched
    arena is safe.  A failure AFTER the dispatch (result fetch,
    delivery) propagates unchanged — the round is half-committed and
    only the step-level arena recovery may touch it."""


def resume_on_row(resume, ids, pos, row, caches):
    """Gather ``row``'s dense per-layer view and run ``resume`` (a
    ``models._generate.resume_step`` closure) on it at the device
    offset ``pos``: (logits (1, C, V), dense views written at
    [pos, pos + C)).  The caller binds the serving weights."""
    dense = [kv_ops.gather_block_kv(ck, cv, row) for ck, cv in caches]
    return resume(ids, pos, dense)


def scatter_chunk(row, pos, caches, dense, block_size):
    """Scatter the ONE physical block a prefill chunk filled back into
    the paged arena, in place: block ``row[0, pos // block_size]``
    takes dense positions [pos, pos + block_size).  ``pos`` is a device
    scalar, block-aligned."""
    bs = block_size
    wb = row[0].index_select(0, (pos // bs).reshape(1))
    idx = pos.reshape(1) + torch.arange(bs, device=pos.device)
    for (ck, cv), (dk, dv) in zip(caches, dense):
        kv_ops.scatter_block_kv(ck, cv, wb, dk[0].index_select(0, idx),
                                dv[0].index_select(0, idx))
    return caches


def make_spec_prefill(model, draft, block_size: int):
    """The spec engine's prefill-chunk body: the plain engine's (gather
    the slot's dense view, run the cached forward at the device offset,
    pick the chunk's last token, scatter ONE block back) plus the same
    chunk through the DRAFT into the draft arena, so a prefilled slot
    has both caches warm.  The draft's logits are unused (the TARGET
    picks the token).  Writes ``toks`` and both arenas in place."""
    bs = block_size
    resume = resume_step(model)
    dresume = resume_step(draft)

    def prefill_chunk_spec(params, dparams, ids, pos, last_idx, slot,
                           tables, toks, caches, dcaches):
        row = tables.index_select(0, slot.reshape(1))           # (1, MB)
        with _bound(model, params):
            logits, dense = resume_on_row(resume, ids, pos, row, caches)
            tok = torch.argmax(
                logits.index_select(1, last_idx.reshape(1))[:, 0].float(),
                dim=-1)
            toks.index_copy_(0, slot.reshape(1), tok)
            scatter_chunk(row, pos, caches, dense, bs)
        with _bound(draft, dparams):
            _, ddense = resume_on_row(dresume, ids, pos, row, dcaches)
            scatter_chunk(row, pos, dcaches, ddense, bs)

    return prefill_chunk_spec


def make_verify(model, draft, spec_k: int, block_size: int):
    """Build the verify body (see the module docstring for the three
    phases).  ``verify(params, dparams, toks, pos, active, tables,
    caches, dcaches, out)`` writes, in place: both arenas' windows, the
    token vector (each slot's last accepted pick), the positions
    (``pos + accepted + 1``), and ``out`` (num_slots, k + 2) — column 0
    the per-slot count of accepted PROPOSALS (0..k), columns 1.. the
    target's greedy picks ``cand``; the host delivers
    ``cand[slot, :accepted + 1]``.  Inactive slots are masked as in
    plain decode: positions clamped to 0, every window write redirected
    to the null block, token entries and positions frozen."""
    k, bs = spec_k, block_size
    dec_d = decode_step(draft)
    res_t = resume_step(model)

    def verify(params, dparams, toks, pos, active, tables, caches, dcaches,
               out):
        posc = torch.where(active, pos, 0)

        # -- 1. draft propose: k+1 single-token greedy steps ------------
        with _bound(draft, dparams):
            ddense = [kv_ops.gather_block_kv(ck, cv, tables)
                      for ck, cv in dcaches]
            cur, dp, props = toks, posc, []
            for j in range(k + 1):
                dlogits, ddense = dec_d(cur[:, None], dp, ddense)
                cur = torch.argmax(dlogits.float(), dim=-1)
                if j < k:
                    props.append(cur)
                dp = dp + 1
        props = torch.stack(props, dim=1)                       # (S, k)

        # window scatter targets, shared by both arenas: position
        # pos+j lands at [table[slot, (pos+j)//bs], (pos+j)%bs]
        wpos = posc[:, None] + torch.arange(k + 1, device=pos.device)
        wblk = torch.where(active[:, None], tables.gather(1, wpos // bs), 0)
        woff = torch.where(active[:, None], wpos % bs, 0)
        rows = torch.arange(pos.shape[0], device=pos.device)[:, None]

        def scatter_window(cs, dense):
            for (ck, cv), (dk, dv) in zip(cs, dense):
                kv_ops.scatter_tokens_kv(ck, cv, wblk, woff, dk[rows, wpos],
                                         dv[rows, wpos])

        scatter_window(dcaches, ddense)

        # -- 2. target verify: one (S, k+1) forward ---------------------
        win = torch.cat([toks[:, None], props], dim=1)
        with _bound(model, params):
            dense = [kv_ops.gather_block_kv(ck, cv, tables)
                     for ck, cv in caches]
            logits, dense = res_t(win, posc, dense)
        cand = torch.argmax(logits.float(), dim=-1)             # (S, k+1)
        scatter_window(caches, dense)

        # -- 3. accept the longest matching greedy prefix ---------------
        match = (props == cand[:, :k]).long()
        acc = torch.cumprod(match, dim=1).sum(dim=1)            # (S,) 0..k
        new_tok = cand.gather(1, acc[:, None])[:, 0]
        toks.copy_(torch.where(active, new_tok, toks))
        # rollback IS this truncation: rejected positions stay written
        # but sit past the new position, unreachable
        pos.copy_(torch.where(active, posc + acc + 1, pos))
        out[:, 0].copy_(torch.where(active, acc, 0))
        out[:, 1:].copy_(cand)

    return verify


def verify_round(engine) -> int:
    """One speculative tick over the whole arena: dispatch the verify
    program, fetch its (accepted, picks) in one sync, then commit each
    slot's accepted run host-side — deliver ``accepted + 1`` tokens (the
    target's own picks) in stream order, stopping early at EOS/budget
    like any other delivery path.  The implementation behind
    ``ServeEngine._spec_tick``."""
    from ..utils import failure
    k = engine.spec_k
    t0 = time.perf_counter()
    with events.span("serve.verify", active=len(engine._running), k=k):
        try:
            engine._dispatch("serve.verify", engine._verify, (),
                             active=len(engine._running))
        except (RuntimeError, OSError) as e:
            if isinstance(e, failure.FailureDetected):
                raise
            # ONLY the un-committed dispatch failure is fallback-safe
            raise VerifyDispatchFailed(
                f"{type(e).__name__}: {e}") from e
        # the designed per-round sync: ONE (num_slots, k+2) fetch
        out = engine._spec_out.cpu().numpy()
    acc, cand = out[:, 0], out[:, 1:]
    dt = time.perf_counter() - t0
    delivered = 0
    for slot in list(engine._running):
        req = engine._running[slot]
        a = int(acc[slot])
        run = [int(t) for t in cand[slot, :a + 1]]
        done = False
        n = 0
        with obs_trace.activate(req.trace_id):
            engine.metrics.on_spec_round(k, a)
            for tok in run:
                done = req.deliver(tok)
                n += 1
                engine.metrics.on_deliver(req.rid, len(req.tokens))
                if done:
                    # budget/EOS mid-run: the leftover accepted tokens
                    # are discarded (generate() would never have
                    # produced them either) and the slot is released
                    break
            # per-token cost = this dispatch's latency amortized over
            # the tokens it yielded for this slot (a plain decode tick
            # is the n == 1 case of the same definition)
            for _ in range(n):
                engine.metrics.on_token(dt / n)
            engine.metrics.on_slot_dispatch(n)
        if req.on_token is not None:
            for tok in run[:n]:
                req.on_token(tok, req.handle)
        delivered += n
        if done:
            engine._finalize(slot)
    return delivered
