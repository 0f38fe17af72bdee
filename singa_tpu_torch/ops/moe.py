"""Mixture-of-experts FFN, ported from ``singa_tpu/ops/moe.py``.

GShard/Switch static-shape recipe: a router (N, D) -> (N, E) logits,
top-k gates with a static expert capacity C = ceil(cf * k * N / E),
token movement into (E, C, D) expert buffers, batched expert products,
and a gate-weighted combine back to (N, D).  Two token movements share
one router (`_route`): gather/scatter (O(k * N * D) memory ops) and the
one-hot einsums (O(cf * k * N^2 * D) MACs, the form an expert-parallel
mesh partitions into all-to-alls).  No shape depends on the data, no
value is read back to the host, so the whole layer runs inside a
captured CUDA graph.  Dropped assignments (over capacity) contribute
nothing.

``dispatch_mode="auto"`` resolves to ``"scatter"``: the port has no
device mesh yet, so there is no expert axis to partition over.

Plain torch ops: the reference computes all of this as jnp outside any
Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["moe_dispatch", "moe_forward", "load_balance_loss"]


def _route(logits, capacity: int, k: int):
    """Shared top-k routing state, rank-major (GShard priority: every
    token's first choice outranks any second choice for a slot).

    Returns (e_flat (k*N,) expert ids, gate_flat (k*N,) f32 gates,
    pos (k*N,) slot index within the expert, keep (k*N,) bool,
    probs (N, E), onehot (N, E) of the first choice)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)            # (N, k)
    gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
    e_flat = topi.T.reshape(-1)                          # rank-major
    oh = F.one_hot(e_flat, E).float()
    pos = (torch.cumsum(oh, 0) * oh - oh).sum(-1)        # (k*N,)
    keep = pos < capacity
    onehot = F.one_hot(topi[:, 0], E).float()
    return e_flat, gates.T.reshape(-1), pos, keep, probs, onehot


def moe_dispatch(logits, capacity: int, k: int = 1):
    """Top-k routing with static capacity (k=1: Switch; k=2: GShard).

    logits: (N, E).  Returns (combine (N, E, C) f32, probs (N, E),
    onehot (N, E) of the first choice).  combine[n, e, c] is token n's
    gate weight at slot c of expert e (0 elsewhere and for dropped
    assignments); gates renormalise over the k selected experts."""
    N, E = logits.shape
    e_flat, gate_flat, pos, keep, probs, onehot = _route(logits, capacity, k)
    oh = F.one_hot(e_flat, E).float()                    # (k*N, E)
    # a dropped assignment's slot (>= capacity) one-hots to no slot
    slot = (pos[:, None] == torch.arange(capacity, device=pos.device)) \
        .float()                                         # (k*N, C)
    contrib = (oh * (gate_flat * keep)[:, None])[:, :, None] \
        * slot[:, None, :]                               # (k*N, E, C)
    combine = contrib.reshape(k, N, E, capacity).sum(0)
    return combine, probs, onehot


def load_balance_loss(probs, onehot):
    """Switch aux loss: E * sum_e mean_n(frac_e) * mean_n(prob_e)."""
    E = probs.shape[-1]
    return E * torch.sum(onehot.mean(0) * probs.mean(0))


def _expert_ffn(buf, w_in, w_out, w_gate):
    """(E, C, D) expert buffers -> (E, C, D) outputs (relu or SwiGLU)."""
    up = torch.bmm(buf, w_in.to(buf.dtype))
    if w_gate is not None:
        h = F.silu(torch.bmm(buf, w_gate.to(buf.dtype))) * up
    else:
        h = F.relu(up)
    return torch.bmm(h, w_out.to(buf.dtype))


def moe_forward(x, router_w, w_in, w_out, capacity_factor: float = 1.25,
                return_aux: bool = False, top_k: int = 1, w_gate=None,
                dispatch_mode: str = "auto"):
    """Top-k MoE FFN over flattened tokens (k=1 Switch, k=2 GShard).

    x: (..., D); router_w: (D, E); w_in: (E, D, H); w_out: (E, H, D).
    Expert e computes relu(x @ w_in[e]) @ w_out[e], or with `w_gate`
    (E, D, H) the SwiGLU form silu(x @ w_gate[e]) * (x @ w_in[e]) @
    w_out[e] (Mixtral's experts).  Routing runs in f32.

    dispatch_mode: 'scatter' (gather/scatter token movement), 'einsum'
    (one-hot dispatch and combine products) or 'auto' (= 'scatter': no
    expert mesh axis in the port).  Both share `_route`.

    The scatter form is deterministic under capture: each token is
    tiled k times (its gradient a sum, not an atomic index_add), and
    dropped assignments go to a spare slot C of an (E, C + 1, D) buffer
    that is sliced away, so each kept slot takes exactly one row."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    E = router_w.shape[-1]
    capacity = max(1, math.ceil(capacity_factor * top_k * N / E))

    logits = xf.float() @ router_w.float()
    if dispatch_mode == "auto":
        dispatch_mode = "scatter"
    if dispatch_mode == "scatter":
        e_flat, gate_flat, pos, keep, probs, onehot = _route(
            logits, capacity, top_k)
        slot = torch.where(keep, pos, torch.full_like(pos, capacity)).long()
        xs = xf.repeat(top_k, 1)                             # (k*N, D)
        buf = xf.new_zeros(E, capacity + 1, D).index_put(
            (e_flat, slot), xs)[:, :capacity]
        y = _expert_ffn(buf, w_in, w_out, w_gate)            # (E, C, D)
        w = (gate_flat * keep).to(xf.dtype)
        out_a = F.pad(y, (0, 0, 0, 1))[e_flat, slot] * w[:, None]
        out = out_a.reshape(top_k, N, D).sum(0)
    elif dispatch_mode == "einsum":
        combine, probs, onehot = moe_dispatch(logits, capacity, top_k)
        dispatch = (combine > 0).to(xf.dtype)                # (N, E, C)
        buf = torch.einsum("nec,nd->ecd", dispatch, xf)
        y = _expert_ffn(buf, w_in, w_out, w_gate)
        out = torch.einsum("nec,ecd->nd", combine.to(xf.dtype), y)
    else:
        raise ValueError(f"dispatch_mode must be auto/scatter/einsum, "
                         f"got {dispatch_mode!r}")
    out = out.to(xf.dtype).reshape(orig_shape)
    if return_aux:
        return out, load_balance_loss(probs, onehot)
    return out
