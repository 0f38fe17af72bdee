"""KV-cache primitives for autoregressive decoding, ported from
``singa_tpu/ops/kv_cache.py`` (``init_cache``, ``update_cache``,
``cached_sdpa``, and the paged arena's ``gather_block_kv``,
``scatter_block_kv``, ``scatter_token_kv`` and ``scatter_tokens_kv``,
full precision and int8).

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
           "scatter_block_kv", "scatter_token_kv", "scatter_tokens_kv",
           "QuantKV", "quantize_kv", "dequantize_kv"]

#: int8 code range: symmetric, -127..127 (the -128 code is unused so
#: quantization commutes with negation and the scale maps amax -> 127)
_QMAX = 127.0
#: scale floor so an all-zero (K, D) slab quantizes to exact zeros
#: instead of dividing by zero (dequantized value stays exactly 0.0)
_SCALE_FLOOR = 1e-30


class QuantKV:
    """One int8-quantized KV pool: ``q`` int8 codes with the pool's
    layout ``(num_blocks, block_size, K, D)`` and ``scale`` f32 of shape
    ``(num_blocks, block_size, 1, 1)``; the value is ``q * scale``.
    ``.shape``/``.dtype`` mirror ``q`` so shape-reading call sites need
    no branch.  Both tensors are static storage, written in place."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device

    def __repr__(self):
        return f"QuantKV(q={tuple(self.q.shape)}, " \
            f"scale={tuple(self.scale.shape)})"


def quantize_kv(x):
    """Quantize ``x`` (..., K, D) to (int8 codes, f32 scales): one
    symmetric absmax scale per leading index (per position), shape
    (..., 1, 1).  ``torch.round`` rounds half to even, as ``jnp.round``
    does."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-2, -1), keepdim=True)
    # a tensor divisor: CUDA divides by a host scalar as a product with
    # its reciprocal, which rounds otherwise than the CPU's division
    scale = torch.clamp(amax / torch.full_like(amax, _QMAX),
                        min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale):
    """Inverse of :func:`quantize_kv` (f32 out)."""
    return q.float() * scale


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
    the attention ``limit`` mask makes unreachable).  A :class:`QuantKV`
    arena gathers codes and scales through the same index and
    dequantizes: its dense view is f32."""
    B, M = table.shape
    idx = table.reshape(-1).long()

    def dense(c):
        return c.index_select(0, idx).reshape((B, M * c.shape[1])
                                              + tuple(c.shape[2:]))

    if isinstance(ck, QuantKV):
        return (dense(ck.q).float() * dense(ck.scale),
                dense(cv.q).float() * dense(cv.scale))
    return dense(ck), dense(cv)


def scatter_block_kv(ck, cv, block, k_blk, v_blk):
    """Write one block's worth of k/v into the paged arena, in place.

    ``block`` is a physical block id: an int, or a 0-d or (1,) device
    tensor (a captured chunk's block, read on the card); ``k_blk`` /
    ``v_blk`` are (block_size, K, D).  The chunked-prefill counterpart
    of :func:`gather_block_kv`."""
    b = torch.as_tensor(block, device=ck.device).reshape(1).long()
    for c, x in ((ck, k_blk), (cv, v_blk)):
        if isinstance(c, QuantKV):
            q, s = quantize_kv(x[None])
            c.q.index_copy_(0, b, q)
            c.scale.index_copy_(0, b, s)
        else:
            c.index_copy_(0, b, x[None].to(c.dtype))
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
    return _scatter_at(ck, cv, block.long(), offset.long(), k_tok, v_tok)


def scatter_tokens_kv(ck, cv, blocks, offsets, k_toks, v_toks):
    """Write a per-row WINDOW of positions into the paged arena, in
    place.

    ``blocks``/``offsets``: (B, T) integer device tensors — row b's
    window token t lands at ``[blocks[b, t], offsets[b, t]]``.
    ``k_toks``/``v_toks``: (B, T, K, D).  The speculative verify
    counterpart of :func:`scatter_token_kv`: one verify round writes k+1
    positions per slot, and rejected positions are rolled back by
    truncating the slot's position (the stale entries past it are
    unreachable, like any stale block content).  Rows sharing a target
    (inactive slots redirected to the null block) resolve arbitrarily,
    which is safe for the same reason."""
    return _scatter_at(ck, cv, blocks.long(), offsets.long(), k_toks,
                       v_toks)


def _scatter_at(ck, cv, b, o, k, v):
    """``c[b, o] = x`` for k and v (index_put_), quantizing for an int8
    pool."""
    for c, x in ((ck, k), (cv, v)):
        if isinstance(c, QuantKV):
            q, s = quantize_kv(x)
            c.q[b, o] = q
            c.scale[b, o] = s
        else:
            c[b, o] = x.to(c.dtype)
    return ck, cv
