"""Ring attention, ported from ``singa_tpu/ops/ring_attention.py``:
sequence (context) parallelism over the ``seq`` mesh axis.

Each rank holds one block of the sequence; K/V blocks rotate around the
ring, one hop a step, while the rank's output accumulates over the
blocks it sees with a numerically stable online softmax.  A hop is
`_RingShift`, a ``torch.autograd.Function`` whose forward is one
``batch_isend_irecv`` to seq-rank + 1 and whose backward is the reverse
hop (ppermute's transpose, as JAX derives it): autograd then runs the
backward ring, each block through its own ``_FlashCore`` backward, as
``jax.grad`` does in the reference.

Two block paths, as the reference's:
  * the einsum path: (B, H, T, T) f32 logits a block, per-element
    causal masks (tiny shapes, the CPU);
  * the flash path (`_ring_local_flash`): each block through
    ``flash_attention_with_lse`` (the Hopper forward kernel and, in the
    backward, both backward kernels with the lse cotangent the merge
    produces), the blocks merged on their lse in f32.  Grouped-query K/V
    rotate without repetition.

Under causal masking the block a rank holds after s hops came from rank
(i − s) mod S: the diagonal (s = 0) runs the causal kernel, a block with
s ≤ i is wholly visible and one with s > i wholly masked.  The reference
computes a masked block and gives it weight 0; the port skips its flash
calls (rank i makes i + 1 forward calls, S(S+1)/2 over the ring, against
S² without the mask) while every rank still makes every hop, since the
blocks it forwards are the later ranks'.

Entry points:
  * ``ring_attention_local`` — the per-rank body on local blocks; its
    `hop` is an argument (the real one by default), so the genuine body
    also runs with an in-process hop over the shards of one card
    (``kernel_check.RING_CASES``);
  * ``ring_attention`` — what a model calls: the ring under a ``seq``
    axis above 1, ``ops.attention`` otherwise (the reference's routing).
    Its inputs are already this rank's: the executor cuts the batch
    (``data``) and the sequence (``seq``), the Megatron layers the heads
    (``model``).
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch

from ..parallel import communicator as comm

__all__ = ["ring_attention", "ring_attention_local", "seq_parallel",
           "RING_STEP"]

_NEG = float(torch.finfo(torch.float32).min)

#: the hop's direction: a rank sends its block to rank + RING_STEP.  Both
#: bodies take the block held after s hops to be rank (i − s)'s, which
#: holds for +1 only (a planted fault turns it; kernel_check.RING_FAULTS)
RING_STEP = 1


class _RingShift(torch.autograd.Function):
    """One hop of the ring over `axis`: the k and v blocks to rank +
    RING_STEP in one batch, rank − RING_STEP's back; the backward hop
    sends their gradients the other way.  k and v travel together, so
    every rank's backward makes its hops in one order, the reverse of
    the forward's."""

    @staticmethod
    def forward(ctx, k, v, axis):
        ctx.axis = axis
        return _shift((k, v), axis, RING_STEP)

    @staticmethod
    def backward(ctx, gk, gv):
        return (*_shift((gk, gv), ctx.axis, -RING_STEP), None)


def _shift(xs, axis, step):
    S = comm.axis_size(axis)
    return comm.ppermute(xs, axis, [(r, (r + step) % S) for r in range(S)])


class _Tie(torch.autograd.Function):
    """`o` unchanged, with `xs` tied into its backward at a zero
    gradient: a rank that skips its last held block still runs that
    hop's backward, which the other ranks wait for."""

    @staticmethod
    def forward(ctx, o, *xs):
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return o.view_as(o)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=d, device=dev)
                     for s, d, dev in ctx.like))


class Hop:
    """The real hop over a bound axis: `size` ranks, this one at
    `index`; called on a rank's (k, v) blocks it returns those of rank
    index − RING_STEP."""

    def __init__(self, axis: str = "seq"):
        self.axis = axis
        self.size = comm.axis_size(axis)
        self.index = comm.axis_index(axis)

    def __call__(self, k: torch.Tensor, v: torch.Tensor):
        return _RingShift.apply(k, v, self.axis)


def seq_parallel(axis: str = "seq"):
    """(S, i): the size of a bound `axis` and this rank's place on it;
    (1, 0) where it is not bound."""
    if not comm.axis_bound(axis):
        return 1, 0
    return comm.axis_size(axis), comm.axis_index(axis)


def _block_visible(s: int, index: int, causal: bool) -> bool:
    """Whether the block held after `s` hops is visible to rank
    `index`: every block without the causal mask; with it, blocks from
    ranks at or before this one (s ≤ index)."""
    return not causal or s <= index


def ring_attention_local(q, k, v, axis: str = "seq", causal: bool = True,
                         scale: Optional[float] = None,
                         use_flash: Optional[bool] = None, hop=None,
                         return_lse: bool = False):
    """Blockwise ring attention on this rank's blocks.

    q: (B, T_local, H, D); k/v: (B, T_local, K, D).  The einsum path
    needs K == H (repeat kv heads first); the flash path takes K < H
    natively.  `use_flash`: None = `_flash_ring_auto`.  `hop`: a `Hop`
    (the default, over `axis`) or any object with ``size``, ``index``
    and a call that returns the previous rank's (k, v) blocks.  With
    `return_lse`, also the rows' lse (B, H, T_local, 1) f32."""
    hop = hop if hop is not None else Hop(axis)
    gqa = k.shape[2] != q.shape[2]
    if gqa and (k.shape[2] == 0 or q.shape[2] % k.shape[2] != 0):
        raise ValueError(
            f"q heads ({q.shape[2]}) must be a multiple of kv heads "
            f"({k.shape[2]})")
    scale = scale or (1.0 / math.sqrt(q.shape[-1]))
    if use_flash is None:
        use_flash = _flash_ring_auto(q)
    if use_flash:
        return _ring_local_flash(q, k, v, hop, causal, scale, return_lse)
    if gqa:
        raise ValueError("the einsum ring needs matching q/kv heads; "
                         "repeat kv heads before the ring (the flash "
                         "path handles GQA natively)")
    return _ring_local_einsum(q, k, v, hop, causal, scale, return_lse)


def _ring_local_einsum(q, k, v, hop, causal, scale, return_lse):
    S, idx = hop.size, hop.index
    B, Tl, H, D = q.shape
    dev = q.device
    qf = q.float()
    o = torch.zeros((B, H, Tl, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    q_pos = idx * Tl + torch.arange(Tl, device=dev)

    def accumulate(o, m, l, k_blk, v_blk, src):
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        pmask = None
        if causal:
            k_pos = src * Tl + torch.arange(Tl, device=dev)
            keep = q_pos[:, None] >= k_pos[None, :]            # (Tq, Tk)
            logits = torch.where(keep[None, None], logits,
                                 torch.full_like(logits, _NEG))
            pmask = keep[None, None].float()
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        if pmask is not None:
            p = p * pmask        # the exp(0) = 1 of a fully masked row
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_blk.float())
        return o, m_new, l

    k_blk, v_blk = k, v
    for s in range(S - 1):
        k_next, v_next = hop(k_blk, v_blk)
        o, m, l = accumulate(o, m, l, k_blk, v_blk, (idx - s) % S)
        k_blk, v_blk = k_next, v_next
    # the last block held needs no further hop: S - 1 hops in all
    o, m, l = accumulate(o, m, l, k_blk, v_blk, (idx - (S - 1)) % S)
    out = (o / torch.clamp_min(l, 1e-30)[..., None]).transpose(1, 2)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., None]
    return out


def _flash_ring_auto(q) -> bool:
    """The flash path for CUDA tensors whose local blocks tile for the
    kernels, unless SINGA_DISABLE_FLASH (the ablation switch of
    ``ops.attention``) is set."""
    from .flash_attention import _tileable
    if os.environ.get("SINGA_DISABLE_FLASH"):
        return False
    return q.is_cuda and _tileable(q.shape[1], q.shape[1], q.shape[3])


def _ring_local_flash(q, k, v, hop, causal, scale, return_lse):
    """Each block's (o, lse) from ``flash_attention_with_lse``, merged
    across the ring on the lse in f32; the output cast once at the end.
    Blocks wholly in the future under the causal mask are skipped
    (`_block_visible`), their hops still made."""
    from .flash_attention import flash_attention_with_lse

    S, idx = hop.size, hop.index
    qh = q.transpose(1, 2)                              # (B, H, Tl, D)

    def block(k_blk, v_blk, block_causal):
        o_b, lse_b = flash_attention_with_lse(
            qh, k_blk.transpose(1, 2), v_blk.transpose(1, 2),
            causal=block_causal, scale=scale)
        return o_b.float(), lse_b[..., 0]         # (B, H, Tl, D), (B, H, Tl)

    if S > 1:
        # the first hop is issued before the diagonal's compute, so the
        # transfer can overlap it
        k_cur, v_cur = hop(k, v)
    o, m = block(k, v, causal)
    l = torch.ones_like(m)                          # Σ exp(s − lse) = 1
    for s in range(1, S):
        if s < S - 1:
            k_next, v_next = hop(k_cur, v_cur)
        if _block_visible(s, idx, causal):
            o_b, lse_b = block(k_cur, v_cur, False)
            m_new = torch.maximum(m, lse_b)
            alpha = torch.exp(m - m_new)
            w = torch.exp(lse_b - m_new)
            o = o * alpha[..., None] + o_b * w[..., None]
            l = l * alpha + w
            m = m_new
        if s < S - 1:
            k_cur, v_cur = k_next, v_next
    if S > 1 and not _block_visible(S - 1, idx, causal):
        o = _Tie.apply(o, k_cur, v_cur)
    out = (o / torch.clamp_min(l, 1e-30)[..., None]).transpose(1, 2)
    out = out.to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l))[..., None]
    return out


def ring_attention(q, k, v, causal: bool = True,
                   scale: Optional[float] = None, axis: str = "seq",
                   data_axis: Optional[str] = None,
                   model_axis: str = "model"):
    """Ring attention over the current mesh's `axis` on this rank's
    (B, T_local, H_local, D) q and (B, T_local, K_local, D) k, v.

    With no `axis` above 1 bound (no mesh, no group, a seq axis of 1) it
    is ``ops.attention`` (the flash kernels on the card from T = 512).
    Grouped-query K/V go to the flash path without repetition and are
    repeated for the einsum path.  `data_axis` and `model_axis` are the
    reference's arguments: the batch and the heads arrive cut (by the
    executor and by the Megatron layers, which keep each rank's heads
    with their kv heads even where the model axis does not divide K),
    so neither is read here."""
    from .attention import attention

    del data_axis, model_axis
    if seq_parallel(axis)[0] == 1:
        return attention(q, k, v, causal=causal, scale=scale)
    use_flash = _flash_ring_auto(q)
    if k.shape[2] != q.shape[2] and not use_flash:
        rep = q.shape[2] // k.shape[2]
        k, v = _repeat_heads(k, rep), _repeat_heads(v, rep)
    return ring_attention_local(q, k, v, axis, causal, scale,
                                use_flash=use_flash)


def _repeat_heads(x: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, T, K, D) -> (B, T, K·rep, D), each kv head repeated for its
    group of q heads (the grouped-query (K, G) layout)."""
    return torch.repeat_interleave(x, rep, dim=2)
