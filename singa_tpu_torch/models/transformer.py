"""Causal-LM losses, ported from ``singa_tpu/models/transformer.py``
(``next_token_loss``, ``next_token_loss_fused_w``,
``next_token_loss_fused``).  The GPT-2 and BERT models of that module
are not ported yet."""

from __future__ import annotations

import torch

from .. import autograd

__all__ = ["next_token_loss", "next_token_loss_fused_w",
           "next_token_loss_fused"]


def next_token_loss(logits: torch.Tensor, ids) -> torch.Tensor:
    """Causal-LM loss: predict ids[t+1] from logits[t]."""
    B, T, V = logits.shape
    ids = torch.as_tensor(ids, device=logits.device)
    return autograd.softmax_cross_entropy(
        logits[:, :-1, :].reshape(B * (T - 1), V), ids[:, 1:].reshape(-1))


def next_token_loss_fused_w(x: torch.Tensor, w: torch.Tensor, ids,
                            chunk_rows: int = 512) -> torch.Tensor:
    """Causal-LM loss straight from the final hidden states against an
    explicit (dim, V) head weight: the matmul and softmax-CE run fused
    and row-chunked, so the (B*T, V) logits are never materialised."""
    B, T, d = x.shape
    ids = torch.as_tensor(ids, device=x.device)
    return autograd.fused_linear_cross_entropy(
        x[:, :-1, :].reshape(B * (T - 1), d), w, ids[:, 1:].reshape(-1),
        chunk_rows)


def next_token_loss_fused(x: torch.Tensor, lm_head, ids,
                          chunk_rows: int = 512) -> torch.Tensor:
    """next_token_loss_fused_w against a Linear lm-head layer (its f32
    master W; the loss casts it to x's dtype)."""
    return next_token_loss_fused_w(x, lm_head.W, ids, chunk_rows)
