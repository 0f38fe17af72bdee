"""Megatron tensor parallelism over the ``model`` mesh axis.

The reference has no module of this kind: GSPMD shards its global
arrays by the rules' specs and inserts the collectives.  The port's
ranks hold local blocks, so the collectives are written here, as
``torch.autograd.Function``s over the axis's subgroup (each one visible
to a CUDA-graph capture):

  * `copy_to_region`: identity forward, all-reduce backward — the input
    of a column-parallel layer, replicated across the model ranks;
  * `reduce_from_region`: all-reduce forward, identity backward — the
    output of a row-parallel layer;
  * `gather_from_region`: all-gather on the last dim forward, this
    rank's block backward — an embedding sharded on its hidden dim;
  * the vocab-parallel cross-entropy, plain and fused, of an lm head
    whose columns are cut: the rows' max and sum of exponentials
    all-reduced, the target's logit taken where it lies.

`shard_params` cuts each parameter to its rank's block of the spec that
``spmd.spec_for`` gives it, and records the spec on the parameter
(``tp_spec``, with ``tp_full_shape``); ``layer.Linear`` and
``layer.Embedding`` read it.  A layer may declare ``shard_units`` (a
parameter name to the unit of each dim): attention projections shard
by whole heads, and where the model axis would cut a head, the
projection stays whole (the reference's GSPMD may cut it; each rank
here then takes the kv heads its q heads read, ``select_kv_heads``).

Outside a bound ``model`` axis every operator is the identity.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple

import torch

from . import communicator as comm
from . import mesh as mesh_mod
from . import spmd

__all__ = ["copy_to_region", "reduce_from_region", "gather_from_region",
           "shard_params", "is_sharded", "sharded_dim", "full_tensor",
           "local_block", "to_local", "select_kv_heads", "vocab_parallel_cross_entropy",
           "fused_vocab_parallel_cross_entropy", "MODEL_AXIS"]

MODEL_AXIS = mesh_mod.MODEL_AXIS


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        return comm.allreduce(g, ctx.axis, "sum"), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return comm.allreduce(x, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.width = axis, x.shape[-1]
        return _gather_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        i = comm.axis_index(ctx.axis)
        return g[..., i * ctx.width:(i + 1) * ctx.width], None


def _gather_last(x: torch.Tensor, axis) -> torch.Tensor:
    g = comm.allgather(x, axis)                        # (M, *x.shape)
    return torch.cat(g.unbind(0), dim=-1)


def copy_to_region(x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
    if not comm.axis_bound(axis):
        return x
    return _CopyToRegion.apply(x, axis)


def reduce_from_region(x: torch.Tensor, axis: str = MODEL_AXIS
                       ) -> torch.Tensor:
    if not comm.axis_bound(axis):
        return x
    return _ReduceFromRegion.apply(x, axis)


def gather_from_region(x: torch.Tensor, axis: str = MODEL_AXIS
                       ) -> torch.Tensor:
    if not comm.axis_bound(axis):
        return x
    return _GatherFromRegion.apply(x, axis)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def is_sharded(p: Optional[torch.Tensor]) -> bool:
    return p is not None and any(a is not None
                                 for a in getattr(p, "tp_spec", ()))


def sharded_dim(p: Optional[torch.Tensor], axis: str = MODEL_AXIS
                ) -> Optional[int]:
    """The dim of `p` cut over `axis`, or None."""
    spec = getattr(p, "tp_spec", ()) if p is not None else ()
    return next((i for i, a in enumerate(spec) if a == axis), None)


def _units(model) -> Dict[str, Tuple[int, ...]]:
    """Parameter path -> the unit of each dim, from the layers'
    ``shard_units``."""
    out = {}
    for mod_name, mod in model.named_modules():
        for pname, unit in getattr(mod, "shard_units", {}).items():
            out[f"{mod_name}.{pname}" if mod_name else pname] = unit
    return out


def _prune(spec, shape, unit, mesh) -> mesh_mod.P:
    """Drop each axis whose block would cut a unit of its dim."""
    axes = []
    for i, ax in enumerate(spec):
        u = unit[i] if unit and i < len(unit) else 1
        axes.append(ax if ax is None or shape[i] % (mesh.shape[ax] * u) == 0
                    else None)
    while axes and axes[-1] is None:
        axes.pop()
    return mesh_mod.P(*axes)


def _block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        per = t.shape[d] // mesh.shape[ax]
        t = t.narrow(d, mesh.axis_index(ax) * per, per)
    return t


def shard_params(model, rules, mesh) -> Dict[str, mesh_mod.P]:
    """Cut each parameter of `model` to this rank's block of its spec
    under `rules` on `mesh`, in place (the Parameter object stays; its
    data becomes a copy of the block), and record ``tp_spec`` and
    ``tp_full_shape`` on it.  Parameters that already carry a spec are
    left as they are.  Returns every parameter's spec."""
    units = _units(model)
    specs = {}
    with torch.no_grad():
        for name, p in model.get_params().items():
            if hasattr(p, "tp_spec"):
                specs[name] = p.tp_spec
                continue
            full = tuple(p.shape)
            spec = _prune(spmd.spec_for(name, full, rules, mesh), full,
                          units.get(name), mesh)
            if any(a is not None for a in spec):
                p.data = _block(p.data, spec, mesh).clone()
            p.tp_spec, p.tp_full_shape, p.tp_mesh = spec, full, mesh
            specs[name] = spec
    _check_biases(model)
    model.tp_mesh = mesh
    return specs


def _check_biases(model) -> None:
    """A column-parallel weight needs its bias cut with its columns."""
    for name, mod in model.named_modules():
        w, b = getattr(mod, "W", None), getattr(mod, "b", None)
        if isinstance(w, torch.Tensor) and isinstance(b, torch.Tensor) \
                and sharded_dim(w) == 1 and sharded_dim(b) != 0:
            raise ValueError(
                f"{name}: W is column-parallel but its bias is not cut "
                f"with it; add a rule (None,) -> ('model',) for {name}.b")


@contextmanager
def _mesh_scope(mesh):
    saved = mesh_mod.current_mesh()
    mesh_mod.set_mesh(mesh)
    try:
        yield
    finally:
        mesh_mod.set_mesh(saved)


def full_tensor(p: torch.Tensor, like: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """`p` at its full shape: its blocks all-gathered over the axes of
    the spec of `like` (default `p` itself: a parameter, or a slot of
    the parameter `like`); a collective over those axes, which every
    rank calls.  `p` itself where there is no spec."""
    like = p if like is None else like
    spec = getattr(like, "tp_spec", ())
    if not any(a is not None for a in spec):
        return p
    mesh = like.tp_mesh
    t = p.detach()
    with _mesh_scope(mesh):
        for d, ax in enumerate(spec):
            if ax is None or not comm.axis_bound(ax):
                continue            # unbound: a world of 1, the block is whole
            g = comm.allgather(t.contiguous(), ax)
            t = torch.cat(g.unbind(0), dim=d)
    return t


def local_block(p: torch.Tensor, full) -> torch.Tensor:
    """This rank's block of `full`, an array at the full shape of the
    parameter `p`."""
    return _block(torch.as_tensor(full), p.tp_spec, p.tp_mesh)


def to_local(p: torch.Tensor, a):
    """`a` for a copy into `p`: its block where `a` has `p`'s full shape
    and `p` is cut, else `a` as it is."""
    if is_sharded(p) and tuple(a.shape) == tuple(p.tp_full_shape) \
            and tuple(a.shape) != tuple(p.shape):
        return local_block(p, a)
    return a


def select_kv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, num_kv_heads: int,
                    axis: str = MODEL_AXIS):
    """The kv heads this rank's q heads read, where the q projection is
    cut over `axis` and the kv projections are whole (q head h reads kv
    head h // G): a contiguous run of kv heads when the rank's q heads
    hold whole groups, else one kv head per q head.  k and v pass a
    `copy_to_region` first, so the ranks' gradients of the whole k and
    v are summed.  q, k, v: (B, T, heads, D)."""
    Hl, Kl = q.shape[2], k.shape[2]
    if Hl == num_heads or Kl != num_kv_heads:
        return k, v                     # nothing cut, or cut by heads
    G = num_heads // num_kv_heads
    lo = comm.axis_index(axis) * Hl
    k, v = copy_to_region(k, axis), copy_to_region(v, axis)
    if Hl % G == 0:
        sl = slice(lo // G, (lo + Hl) // G)
        return k[:, :, sl], v[:, :, sl]
    idx = torch.arange(lo, lo + Hl, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


# ---------------------------------------------------------------------------
# vocab-parallel cross-entropy (the lm head's columns cut over 'model')
# ---------------------------------------------------------------------------

def _vocab_lo(width: int, axis) -> int:
    """The first vocab id of this rank's `width` logit columns (0 where
    they are not cut: `axis` None)."""
    return 0 if axis is None else comm.axis_index(axis) * width


def _allreduce(x: torch.Tensor, axis, op: str) -> torch.Tensor:
    return x if axis is None else comm.allreduce(x, axis, op)


def vocab_parallel_cross_entropy(logits: torch.Tensor, target,
                                 vocab_size: int, denom=None,
                                 axis: str = MODEL_AXIS) -> torch.Tensor:
    """Softmax cross-entropy of (n, V_local) logits, this rank's columns
    of a vocabulary of `vocab_size` cut over `axis` (None: the logits
    are the whole vocabulary): the row max and the sum of exponentials
    all-reduced over `axis`, the target's logit taken on the rank that
    holds it.  The result is the same on every rank of `axis`: the sum
    over valid rows (targets in [0, vocab_size); others give zero loss)
    divided by `denom` (default n, the mean)."""
    n, Vl = logits.shape
    lg = logits.float()
    tgt = torch.as_tensor(target, device=lg.device).reshape(-1).long()
    valid = (tgt >= 0) & (tgt < vocab_size)
    local = tgt - _vocab_lo(Vl, axis)
    mine = (local >= 0) & (local < Vl)
    with torch.no_grad():
        m = _allreduce(lg.amax(dim=-1, keepdim=True), axis, "max")
    s = torch.exp(lg - m).sum(dim=-1)
    zt = lg.gather(1, local.clamp(0, Vl - 1)[:, None])[:, 0]
    zt = torch.where(mine, zt, torch.zeros_like(zt))
    if axis is not None:
        s, zt = reduce_from_region(s, axis), reduce_from_region(zt, axis)
    per_row = torch.log(s) + m[:, 0] - zt
    total = torch.where(valid, per_row, torch.zeros_like(per_row)).sum()
    return total / (n if denom is None else denom)


def fused_vocab_parallel_cross_entropy(h: torch.Tensor, w: torch.Tensor,
                                       target, vocab_size: int,
                                       chunk_rows: int = 512, denom=None,
                                       axis: str = MODEL_AXIS
                                       ) -> torch.Tensor:
    """``autograd.fused_linear_cross_entropy`` of h (n, dim) against this
    rank's head columns w (dim, V_local) of a `vocab_size` vocabulary
    cut over `axis` (None: w is the whole head), divided by `denom`
    (default n).  Under a cut, h should come through `copy_to_region`,
    as a column-parallel layer's input does."""
    from ..autograd import _FusedLinearCE
    target = torch.as_tensor(target, device=h.device)
    return _FusedLinearCE.apply(h, w, target, int(chunk_rows),
                                int(vocab_size), denom, axis)
