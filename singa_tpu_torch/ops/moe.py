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

``dispatch_mode="auto"`` resolves to ``"einsum"`` under a mesh whose
``expert`` axis is above 1 and to ``"scatter"`` otherwise, as the
reference's does.

Expert parallelism: where ``w_in`` holds fewer experts than the router
routes to (``layer.MoE``'s weights cut over the ``expert`` axis by its
rules, E/ep experts a rank), every rank routes every token (the batch is
not cut over ``expert``), dispatches to its own experts only, runs their
FFN, and the partial outputs are summed over the axis
(``tensor_parallel.reduce_from_region``: an all-reduce of (N, D)).  The
reference's GSPMD partitions its einsums into all-to-alls instead; the
result is the same.  Two ``copy_to_region``s make the backward whole: the
dispatch input's gradient and the combine's share of the router's are
summed over the ranks, while the balance loss, which every rank computes
whole, reaches the router once.  The capacity uses the global E and the
whole token count, so the drops are the reference's.

Where the multi-axis step cut the token batch over ``data`` or ``seq``
(``spmd.current_token_cut``), the reference's GSPMD step still routes
the whole batch as one: the capacity counts every rank's tokens, each
assignment's slot is its place in the whole batch (every rank's expert
choices all-gathered, k·N ids), and the balance loss takes the whole
batch's means.

Plain torch ops: the reference computes all of this as jnp outside any
Pallas kernel.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from ..parallel import communicator as comm
from ..parallel import mesh as mesh_mod
from ..parallel import spmd
from ..parallel import tensor_parallel as tp

__all__ = ["moe_dispatch", "moe_forward", "moe_partial", "load_balance_loss",
           "resolve_dispatch", "EXPERT_AXIS"]

EXPERT_AXIS = mesh_mod.EXPERT_AXIS


def _token_cut():
    """The bound axes that cut the token batch ((dim, axis), ...; see
    ``spmd.current_token_cut``) and their total size."""
    cut = tuple((d, a) for d, a in spmd.current_token_cut()
                if comm.axis_size(a) > 1)
    return cut, math.prod(comm.axis_size(a) for _, a in cut)


def _slots(e_flat, E):
    """Each assignment's slot within its expert, in order (k-major)."""
    oh = F.one_hot(e_flat, E).float()
    return (torch.cumsum(oh, 0) * oh - oh).sum(-1)


def _global_slots(topi, E, grid, cut):
    """The slots of this rank's assignments (k*N,) among the whole
    batch's, which `cut` split over ranks: every rank's choices gathered
    onto the whole token grid, the slots taken there in the global token
    order, this rank's block read back."""
    k = topi.shape[1]
    names = mesh_mod.current_mesh().axis_names
    cut = sorted(cut, key=lambda da: names.index(da[1]))   # gather order
    sizes = [comm.axis_size(a) for _, a in cut]
    local = topi.reshape(tuple(grid) + (k,)).contiguous()
    g = comm.allgather(local, tuple(a for _, a in cut))   # (W, *grid, k)
    shape = list(grid)
    for (d, _), n in zip(cut, sizes):
        shape[d] *= n
    full = local.new_empty(tuple(shape) + (k,))
    for w, blocks in enumerate(itertools.product(*map(range, sizes))):
        idx = [slice(None)] * len(grid)
        for (d, _), i in zip(cut, blocks):
            idx[d] = slice(i * grid[d], (i + 1) * grid[d])
        full[tuple(idx)] = g[w]
    pos = _slots(full.reshape(-1, k).T.reshape(-1), E).reshape(
        (k,) + tuple(shape))
    mine = [slice(None)] * (1 + len(grid))
    for d, a in cut:
        i = comm.axis_index(a)
        mine[1 + d] = slice(i * grid[d], (i + 1) * grid[d])
    return pos[tuple(mine)].reshape(-1)


def _balance(probs, onehot):
    """The Switch balance loss over the whole batch under a token cut:
    each rank's token means averaged over the cut axes (equal blocks),
    the probabilities' mean with an identity backward, so that DistOpt's
    mean over the ranks gives the whole batch's gradient."""
    cut, _ = _token_cut()
    if not cut:
        return load_balance_loss(probs, onehot)
    axes = tuple(a for _, a in cut)
    f = comm.allreduce(onehot.mean(0), axes, "mean")
    pm = probs.mean(0)
    pm = pm + (comm.allreduce(pm.detach(), axes, "mean") - pm.detach())
    return probs.shape[-1] * torch.sum(f * pm)


def _route(logits, capacity: int, k: int, grid=None):
    """Shared top-k routing state, rank-major (GShard priority: every
    token's first choice outranks any second choice for a slot).  Under
    a token cut (`grid`: the local token grid) the slots are the whole
    batch's.

    Returns (e_flat (k*N,) expert ids, gate_flat (k*N,) f32 gates,
    pos (k*N,) slot index within the expert, keep (k*N,) bool,
    probs (N, E), onehot (N, E) of the first choice)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)            # (N, k)
    gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
    e_flat = topi.T.reshape(-1)                          # rank-major
    cut = _token_cut()[0] if grid is not None else ()
    pos = _global_slots(topi, E, grid, cut) if cut else _slots(e_flat, E)
    keep = pos < capacity
    onehot = F.one_hot(topi[:, 0], E).float()
    return e_flat, gates.T.reshape(-1), pos, keep, probs, onehot


def moe_dispatch(logits, capacity: int, k: int = 1, grid=None):
    """Top-k routing with static capacity (k=1: Switch; k=2: GShard).

    logits: (N, E).  Returns (combine (N, E, C) f32, probs (N, E),
    onehot (N, E) of the first choice).  combine[n, e, c] is token n's
    gate weight at slot c of expert e (0 elsewhere and for dropped
    assignments); gates renormalise over the k selected experts.
    `grid`: the tokens' local grid, for slots over a token cut."""
    N, E = logits.shape
    e_flat, gate_flat, pos, keep, probs, onehot = _route(logits, capacity, k,
                                                         grid)
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


def resolve_dispatch(dispatch_mode: str) -> str:
    """'auto' as the reference resolves it: 'einsum' under a mesh whose
    expert axis is above 1, else 'scatter'; other modes as they are."""
    if dispatch_mode != "auto":
        return dispatch_mode
    m = mesh_mod.current_mesh()
    ep = m is not None and m.shape.get(EXPERT_AXIS, 1) > 1
    return "einsum" if ep else "scatter"


def moe_partial(x, router_w, w_in, w_out, capacity_factor: float, top_k: int,
                w_gate, dispatch_mode: str, lo: int, grid=None):
    """One expert rank's share of the MoE FFN: the experts lo .. lo + El
    (``w_in`` (El, D, H) of E in the router), over every token of x
    (N, D).  Returns (this rank's partial output (N, D), the balance
    loss); the partial outputs of the ranks sum to the FFN's output.
    The copies to the expert region make the sum's backward whole (see
    the module docstring); without a bound expert axis, or with all E
    experts (El = E: nothing to sum), they are the identity, so the ranks
    may also run in one process.  `grid`: x's
    local token grid under a token cut (``spmd.current_token_cut``)."""
    N, D = x.shape
    E, El = router_w.shape[-1], w_in.shape[0]
    n_all = N * (_token_cut()[1] if grid is not None else 1)
    capacity = max(1, math.ceil(capacity_factor * top_k * n_all / E))
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)            # the balance loss's
    lc, xd = logits, x                               # the combine's and
    if El != E:                                      # the dispatch's
        lc = tp.copy_to_region(logits, EXPERT_AXIS)
        xd = tp.copy_to_region(x, EXPERT_AXIS)
    if dispatch_mode == "scatter":
        e_flat, gate_flat, pos, keep, _, onehot = _route(lc, capacity, top_k,
                                                         grid)
        mine = (e_flat >= lo) & (e_flat < lo + El) & keep
        e_loc = (e_flat - lo).clamp(0, El - 1)
        slot = torch.where(mine, pos, torch.full_like(pos, capacity)).long()
        buf = xd.new_zeros(El, capacity + 1, D).index_put(
            (e_loc, slot), xd.repeat(top_k, 1))[:, :capacity]
        y = _expert_ffn(buf, w_in, w_out, w_gate)
        w = (gate_flat * mine).to(x.dtype)
        out_a = F.pad(y, (0, 0, 0, 1))[e_loc, slot] * w[:, None]
        out = out_a.reshape(top_k, N, D).sum(0)
    elif dispatch_mode == "einsum":
        combine, _, onehot = moe_dispatch(lc, capacity, top_k, grid)
        combine = combine[:, lo:lo + El]
        dispatch = (combine > 0).to(x.dtype)
        buf = torch.einsum("nec,nd->ecd", dispatch, xd)
        y = _expert_ffn(buf, w_in, w_out, w_gate)
        out = torch.einsum("nec,ecd->nd", combine.to(x.dtype), y)
    else:
        raise ValueError(f"dispatch_mode must be auto/scatter/einsum, "
                         f"got {dispatch_mode!r}")
    aux = _balance(probs, onehot) if grid is not None else \
        load_balance_loss(probs, onehot)
    return out.to(x.dtype), aux


def moe_forward(x, router_w, w_in, w_out, capacity_factor: float = 1.25,
                return_aux: bool = False, top_k: int = 1, w_gate=None,
                dispatch_mode: str = "auto"):
    """Top-k MoE FFN over flattened tokens (k=1 Switch, k=2 GShard).

    x: (..., D); router_w: (D, E); w_in: (E, D, H); w_out: (E, H, D).
    Expert e computes relu(x @ w_in[e]) @ w_out[e], or with `w_gate`
    (E, D, H) the SwiGLU form silu(x @ w_gate[e]) * (x @ w_in[e]) @
    w_out[e] (Mixtral's experts).  Routing runs in f32.

    dispatch_mode: 'scatter' (gather/scatter token movement), 'einsum'
    (one-hot dispatch and combine products) or 'auto' (`resolve_dispatch`).
    Both share `_route`.  The body is `moe_partial` over all E experts,
    or, with fewer experts in `w_in` than the router's E, over this
    rank's share of them, summed over the expert axis.

    The scatter form is deterministic under capture: each token is
    tiled k times (its gradient a sum, not an atomic index_add), and
    dropped assignments go to a spare slot C of an (E, C + 1, D) buffer
    that is sliced away, so each kept slot takes exactly one row."""
    orig_shape = x.shape
    D = orig_shape[-1]
    xf = x.reshape(-1, D)
    E = router_w.shape[-1]
    # a multi-axis step that cut the tokens routes them as one batch
    grid = tuple(orig_shape[:-1]) or (1,)
    El = w_in.shape[0]
    share = El != E
    out, aux = moe_partial(xf, router_w, w_in, w_out, capacity_factor, top_k,
                           w_gate, resolve_dispatch(dispatch_mode),
                           comm.axis_index(EXPERT_AXIS) * El if share else 0,
                           grid)
    if share:
        out = tp.reduce_from_region(out, EXPERT_AXIS)
    out = out.reshape(orig_shape)
    return (out, aux) if return_aux else out
