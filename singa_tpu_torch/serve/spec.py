"""The two halves of the paged engine's prefill-chunk program, ported
from ``singa_tpu/serve/spec.py`` (``resume_on_row``, ``scatter_chunk``).

In the reference these helpers are shared by the plain prefill-chunk
program and the speculative one, so the two prefill semantics cannot
drift apart.  The speculative verify program itself (draft propose-k,
target verify-k, accept and roll back, with ``scatter_tokens_kv``)
waits for the slice that ports speculative decoding; until then a
``ServeEngine`` given ``draft_model``/``spec_k`` raises.
"""

from __future__ import annotations

import torch

from ..ops import kv_cache as kv_ops

__all__ = ["resume_on_row", "scatter_chunk"]


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
