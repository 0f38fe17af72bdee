"""KV-cache primitives for autoregressive decoding, ported from
``singa_tpu/ops/kv_cache.py`` (``init_cache``, ``update_cache``,
``cached_sdpa``).

A static cache: preallocated (B, S_max, K, D) buffers plus an explicit
validity window.  Prefill attends within the prompt through the regular
attention stack (the flash kernel when the shape tiles); decode steps
(Tq = 1) run the masked reference math against the whole cache, as in
the JAX package.

Difference from the reference: ``update_cache`` writes into the given
buffers in place (the reference is functional) and returns them.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

__all__ = ["init_cache", "update_cache", "cached_sdpa"]


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
    in place.  `pos` is an int (every row at one depth) or a (B,) tensor
    (row b writes at its own positions [pos[b], pos[b]+T))."""
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
