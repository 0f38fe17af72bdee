"""Scaled-dot-product attention, ported from ``singa_tpu/ops/attention.py``.

Two lowerings behind one API:
  * `_sdpa_reference` — plain torch einsum/softmax, the oracle;
  * the hand-written Hopper flash kernels (``ops.flash_attention``,
    forward and backward) for long sequences on the card.
Selection is by sequence length, head grouping and the tensor's device;
both lowerings are differentiable (torch autograd through the reference,
the flash ``autograd.Function`` through the kernels).

Sliding-window (banded) attention routes the same way: the flash kernels
with a window on the card from T = 512, else `banded_sdpa` (query
chunks, O(T * W) memory), else the full band mask for chunkings that
degenerate.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .._unit import unit

__all__ = ["attention", "sdpa", "SDPA", "pick_band_chunk", "banded_sdpa",
           "BandedSDPA", "banded_attention"]

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
    Operator; its gradient is torch autograd's)."""

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


@unit("attention")
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


def pick_band_chunk(T: int, window: int) -> Optional[int]:
    """Largest divisor of T up to ~the window (capped at 512): the chunk
    size that keeps (C, C + W) score tiles small.  None when only a
    degenerate chunk (< 8) divides T."""
    cap = max(16, min(window, 512))
    c = next(c for c in range(min(cap, T), 0, -1) if T % c == 0)
    return c if c >= 8 else None


def banded_sdpa(q, k, v, window: int, scale: Optional[float] = None,
                chunk: Optional[int] = None):
    """Sliding-window attention (query t attends keys in (t - W, t]) in
    query chunks, so only (C, C + W) score tiles materialise.

    Chunk i's queries [iC, iC + C) need keys [iC - W + 1, iC + C): a
    width-(C + W) window of k/v left-padded by W zeros, the same for
    every chunk, whose padded keys fall outside the band mask."""
    B, T = q.shape[:2]
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    W = int(window)
    if chunk is None:
        chunk = pick_band_chunk(T, W)
        if chunk is None:
            raise ValueError(
                f"no usable chunk divides T={T} (all divisors < 8); "
                "use the masked path instead")
    C = int(chunk)
    if T % C:
        raise ValueError(f"seq len {T} must divide by chunk {C}")
    n = T // C
    span = C + W
    pad = (0, 0, 0, 0, W, 0)                 # W zeros before key 0

    def chunks(t):                            # (B, n, span, K, D)
        return torch.nn.functional.pad(t, pad).unfold(1, span, C) \
            .permute(0, 1, 4, 2, 3)
    kc, vc = chunks(k), chunks(v)
    qc = q.reshape(B, n, C, *q.shape[2:])
    # query c of a chunk sits at offset c, key j at offset j - W: the
    # band is c < j <= c + W; chunk i's padded keys (absolute position
    # iC + j - W < 0) are masked out as well
    cpos = torch.arange(C, device=q.device)[:, None]
    jpos = torch.arange(span, device=q.device)[None, :]
    band = (jpos <= cpos + W) & (jpos > cpos)
    starts = torch.arange(n, device=q.device) * C
    valid = jpos[None] >= (W - starts)[:, None, None]
    mask = (band[None] & valid)[None].expand(B, n, C, span)
    out = _sdpa_reference(
        qc.reshape(B * n, C, *q.shape[2:]),
        kc.reshape(B * n, span, *k.shape[2:]),
        vc.reshape(B * n, span, *v.shape[2:]), False,
        mask.reshape(B * n, 1, C, span), scale)
    return out.reshape(q.shape[:3] + (v.shape[-1],))


class BandedSDPA:
    """Sliding-window attention with its options bound.  Routing as
    SDPA's: the flash kernels with a window on the card (tiles below the
    band skipped), the chunked path elsewhere, the full band mask for
    degenerate chunkings."""

    def __init__(self, window: int, scale: Optional[float],
                 chunk: Optional[int]):
        self.window = window
        self.scale = scale
        self.chunk = chunk

    def fwd(self, q, k, v):
        scale = self.scale or (1.0 / math.sqrt(q.shape[-1]))
        W = self.window
        if self.chunk is None and _use_flash(q, k):
            from .flash_attention import flash_attention
            return flash_attention(q, k, v, causal=True, scale=scale,
                                   window=W)
        if self.chunk is None and pick_band_chunk(q.shape[1], W) is None:
            return _banded_reference(q, k, v, W, scale)
        return banded_sdpa(q, k, v, W, scale, self.chunk)

    __call__ = fwd


def banded_attention(q, k, v, window: int, scale: Optional[float] = None,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """(B, T, H, D) sliding-window attention."""
    return BandedSDPA(window, scale, chunk)(q, k, v)
