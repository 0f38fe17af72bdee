"""Forward math of the operators the Llama serving path uses, ported
from ``singa_tpu/autograd.py`` (Linear, Embedding, Cast, SiLU, RMSNorm).

Plain functions on ``torch.Tensor`` with the reference's dtype rules;
there is no tape yet (it comes with the training slice).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["linear", "embedding", "cast", "silu", "rmsnorm"]


def linear(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """y = x @ W (+ b), W of shape (in, out)."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup: out[i] = table[ids[i]]."""
    return F.embedding(ids.long(), table)


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6):
    """Statistics in f32, output in the input dtype (Llama style)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma).to(x.dtype)
