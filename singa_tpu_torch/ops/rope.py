"""Rotary position embeddings (RoPE), ported from ``singa_tpu/ops/rope.py``."""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["rope_frequencies", "apply_rope", "llama31_rope_scaling"]


def llama31_rope_scaling(inv_freq: torch.Tensor, scale_factor: float = 8.0,
                         low_freq_factor: float = 1.0,
                         high_freq_factor: float = 4.0,
                         original_max_position: int = 8192) -> torch.Tensor:
    """Llama-3.1-style frequency-dependent interpolation: long
    wavelengths (beyond the original context) are divided by
    `scale_factor`, short wavelengths pass through, and the band in
    between blends linearly."""
    wavelen = 2.0 * math.pi / inv_freq
    low_bound = original_max_position / low_freq_factor
    high_bound = original_max_position / high_freq_factor
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    blended = (1 - smooth) * inv_freq / scale_factor + smooth * inv_freq
    return torch.where(wavelen > low_bound, inv_freq / scale_factor,
                       torch.where(wavelen < high_bound, inv_freq, blended))


@functools.lru_cache(maxsize=32)
def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     rope_scaling: float = 0.0,
                     rope_original_max_position: int = 8192):
    """(cos, sin) f32 tables of shape (max_len, head_dim // 2), on the
    CPU; callers move them to their device once.  Cached so every layer
    of a model shares one pair."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv = 1.0 / (theta ** exps)
    if rope_scaling and rope_scaling > 0.0:
        inv = llama31_rope_scaling(
            inv, scale_factor=float(rope_scaling),
            original_max_position=int(rope_original_max_position))
    t = torch.arange(max_len, dtype=torch.float32)
    freqs = torch.outer(t, inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               offset=0) -> torch.Tensor:
    """Rotate-half RoPE of x (B, T, H, D) at positions [offset, offset+T).

    `offset` is an int (all rows at one depth), a 0-d tensor (the same,
    read on the device) or a (B,) tensor (row b rotates at its own
    positions, as continuous-batching decode needs).
    Rotation runs in f32; the result is cast back to x's dtype."""
    T = x.shape[1]
    if isinstance(offset, torch.Tensor):
        idx = offset.reshape(-1, 1).to(cos.device) + torch.arange(
            T, device=cos.device)                            # (B|1, T)
        c = cos[idx][:, :, None, :]                          # (B|1, T, 1, D/2)
        s = sin[idx][:, :, None, :]
    else:
        c = cos[offset:offset + T][None, :, None, :]
        s = sin[offset:offset + T][None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
