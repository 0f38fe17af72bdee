"""KV-cache primitives for autoregressive decoding, ported from
``singa_tpu/ops/kv_cache.py`` (``init_cache``, ``update_cache``,
``cached_sdpa``, and the paged arena's ``gather_block_kv``,
``scatter_block_kv`` and ``scatter_token_kv`` at full precision).

A static cache: preallocated (B, S_max, K, D) buffers plus an explicit
validity window.  Prefill attends within the prompt through the regular
attention stack (the flash kernel when the shape tiles); decode steps
(Tq = 1) run the masked reference math against the whole cache, as in
the JAX package.

Difference from the reference: ``update_cache`` and the two paged
scatters write into the given buffers in place (the reference is
functional) and return them, so a captured serving program writes the
arena it was captured over.  Indices are device tensors, read on the
card: none of these ops syncs the host.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

__all__ = ["init_cache", "update_cache", "cached_sdpa", "gather_block_kv",
           "scatter_block_kv", "scatter_token_kv"]


def init_cache(num_layers: int, batch: int, max_len: int, num_kv_heads: int,
               head_dim: int, dtype=torch.float32,
               device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer (k, v) zero buffers of shape (B, S_max, K, D)."""
    shape = (batch, max_len, num_kv_heads, head_dim)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(num_layers)]


def update_cache(ck, cv, k_new, v_new, pos):
    """Write k/v (B, T, K, D) for positions [pos, pos+T) into the cache,
    in place.  `pos` is an int (every row at one depth), a 0-d tensor
    (the same, read on the device: a captured decode step's position) or
    a (B,) tensor (row b writes at its own positions [pos[b], pos[b]+T)).
    A tensor position is written with index_put_, which does not sync
    the host."""
    T = k_new.shape[1]
    if isinstance(pos, int):
        ck[:, pos:pos + T] = k_new.to(ck.dtype)
        cv[:, pos:pos + T] = v_new.to(cv.dtype)
        return ck, cv
    B = ck.shape[0]
    idx = (pos.to(ck.device).reshape(-1, 1)
           + torch.arange(T, device=ck.device)).expand(B, T)
    rows = torch.arange(B, device=ck.device)[:, None].expand(B, T)
    ck[rows, idx] = k_new.to(ck.dtype)
    cv[rows, idx] = v_new.to(cv.dtype)
    return ck, cv


def cached_sdpa(q, ck, cv, limit, scale: float = None, mask=None,
                window: int = None):
    """Attention of q (B, T, H, D) against the whole cache (B, S, K, D),
    masked to cache positions < `limit` plus bottom-right-aligned
    causality inside the query block (query t attends cache positions
    <= limit - T + t).  `limit` is an int or a (B,) tensor of per-row
    limits.  `mask`: optional (B, 1|H, 1|T, S) boolean mask ANDed with
    the validity window.  `window`: sliding window — each query also
    ignores cache positions more than `window - 1` behind it."""
    from .attention import _sdpa_reference
    T = q.shape[1]
    S = ck.shape[1]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    kpos = torch.arange(S, device=q.device)[None, None, None, :]
    lim = torch.as_tensor(limit, device=q.device)
    lim = lim.reshape(-1, 1, 1, 1) if lim.ndim else lim
    qpos = lim - T + torch.arange(T, device=q.device)[None, None, :, None]
    valid = kpos <= qpos                                  # (B|1, 1, T, S)
    if window is not None:
        valid = valid & (kpos > qpos - window)
    if mask is not None:
        valid = valid & torch.as_tensor(mask, device=q.device)
    return _sdpa_reference(q, ck, cv, False, valid, scale)


def gather_block_kv(ck, cv, table):
    """Gather a contiguous per-request view out of a paged block arena.

    ``ck``/``cv``: (num_blocks, block_size, K, D) block pools.
    ``table``: (B, max_blocks) integer block table — row b's logical
    block i lives in physical block ``table[b, i]``.  Returns new dense
    (B, max_blocks * block_size, K, D) views.  The gather is a
    fixed-shape ``index_select`` on the leading axis, so the paged arena
    rides one captured program no matter which physical blocks a
    request holds (stale/unallocated table entries read garbage that
    the attention ``limit`` mask makes unreachable)."""
    B, M = table.shape
    idx = table.reshape(-1).long()

    def dense(c):
        return c.index_select(0, idx).reshape((B, M * c.shape[1])
                                              + tuple(c.shape[2:]))

    return dense(ck), dense(cv)


def scatter_block_kv(ck, cv, block, k_blk, v_blk):
    """Write one block's worth of k/v into the paged arena, in place.

    ``block`` is a physical block id: an int, or a 0-d or (1,) device
    tensor (a captured chunk's block, read on the card); ``k_blk`` /
    ``v_blk`` are (block_size, K, D).  The chunked-prefill counterpart
    of :func:`gather_block_kv`."""
    b = torch.as_tensor(block, device=ck.device).reshape(1).long()
    ck.index_copy_(0, b, k_blk[None].to(ck.dtype))
    cv.index_copy_(0, b, v_blk[None].to(cv.dtype))
    return ck, cv


def scatter_token_kv(ck, cv, block, offset, k_tok, v_tok):
    """Write ONE position's k/v per batch row into the paged arena, in
    place.

    ``block``/``offset``: (B,) integer device vectors — row b's token
    lands at ``[block[b], offset[b]]``.  ``k_tok``/``v_tok``: (B, K, D).
    The decode-over-block-tables counterpart of :func:`update_cache`'s
    per-row vector path; rows sharing a target (inactive slots
    redirected to the null block) resolve arbitrarily, which is safe
    because the null block is never inside any row's validity window."""
    b, o = block.long(), offset.long()
    ck[b, o] = k_tok.to(ck.dtype)
    cv[b, o] = v_tok.to(cv.dtype)
    return ck, cv
