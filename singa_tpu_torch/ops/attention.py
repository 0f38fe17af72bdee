"""Scaled-dot-product attention, ported from ``singa_tpu/ops/attention.py``.

Two lowerings behind one API:
  * `_sdpa_reference` — plain torch einsum/softmax, the oracle;
  * the hand-written Hopper flash kernel (``ops.flash_attention``) for
    long sequences on the card.
Selection is by sequence length, head grouping and the tensor's device.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

__all__ = ["attention", "sdpa", "SDPA"]

# sequences at least this long route to the flash kernel on the card
_FLASH_MIN_LEN = 512


def _sdpa_reference(q, k, v, causal: bool, mask, scale: float):
    """q: (B, Tq, H, D); k/v: (B, Tk, K, D) with K | H (grouped-query
    attention when K < H).  Masked logits take finfo(dtype).min; the
    softmax runs in f32 and its probabilities are cast to q's dtype.
    Mixed q/k dtypes promote as in the reference."""
    H, K = q.shape[2], k.shape[2]
    G = H // K
    ct = torch.promote_types(q.dtype, k.dtype)
    if K != H:
        qg = q.reshape(q.shape[:2] + (K, G, q.shape[-1]))
        logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(ct), k.to(ct)) * scale
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    extra = logits.ndim - 2  # leading axes before (Tq, Tk)
    fill = torch.finfo(logits.dtype).min
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        cm = torch.ones((Tq, Tk), dtype=torch.bool,
                        device=logits.device).tril(Tk - Tq)
        logits = logits.masked_fill(~cm[(None,) * extra], fill)
    if mask is not None:
        m = torch.as_tensor(mask, device=logits.device)
        if K != H and m.ndim == 4:
            # user masks address (B, H|1, Tq|1, Ts); grouped logits are
            # (B, K, G, Tq, Ts) — split the head axis
            if m.shape[1] == H:
                m = m.reshape(m.shape[0], K, G, *m.shape[2:])
            else:
                m = m[:, :, None]
        logits = torch.where(m, logits, torch.full_like(logits, fill))
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    ot = torch.promote_types(probs.dtype, v.dtype)
    if K != H:
        out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(ot), v.to(ot))
        return out.reshape(out.shape[:2] + (H, out.shape[-1]))
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(ot), v.to(ot))


def _use_flash(q, k=None) -> bool:
    if os.environ.get("SINGA_DISABLE_FLASH"):
        return False
    if q.shape[1] < _FLASH_MIN_LEN:
        return False
    if k is not None and q.shape[2] % k.shape[2] != 0:
        return False  # non-grouping head ratio: einsum reference path
    return q.is_cuda


class SDPA:
    """Attention with its options bound (the reference's autograd
    Operator, forward only)."""

    def __init__(self, causal: bool, mask, scale: Optional[float]):
        self.causal = causal
        self.mask = mask
        self.scale = scale

    def fwd(self, q, k, v):
        scale = self.scale or (1.0 / math.sqrt(q.shape[-1]))
        if self.mask is None and _use_flash(q, k):
            from .flash_attention import flash_attention
            return flash_attention(q, k, v, causal=self.causal, scale=scale)
        return _sdpa_reference(q, k, v, self.causal, self.mask, scale)

    __call__ = fwd


def attention(q, k, v, causal: bool = False, mask=None,
              scale: Optional[float] = None) -> torch.Tensor:
    """(B, T, H, D) attention with optional causal/explicit mask."""
    return SDPA(causal, mask, scale)(q, k, v)


def sdpa(q, k, v, causal=False, mask=None, scale=None):
    """Raw-tensor entry point (same routing as ``attention``)."""
    return attention(q, k, v, causal, mask, scale)


def _banded_reference(q, k, v, window: int, scale: float):
    """Oracle: full (Tq, Tk) band mask through _sdpa_reference
    (bottom-right aligned when Tk > Tq, matching the causal
    convention)."""
    Tq, Tk = q.shape[1], k.shape[1]
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    band = (kpos <= qpos) & (kpos > qpos - window)
    return _sdpa_reference(q, k, v, False, band[None, None], scale)
