"""Pipeline parallelism over the ``pipe`` mesh axis (the GPipe schedule),
ported from ``singa_tpu/parallel/pipeline.py``.

The reference writes the schedule once, in global semantics: under
``shard_map`` every pipe rank applies its stage each tick, a
``lax.ppermute`` hop ships the activation to the next rank, ``lax.scan``
drives the M + S − 1 ticks, and ``jax.grad`` of that scan is the reverse
schedule.  Here each pipe rank is a process holding one stage, and the
schedule is this rank's part of it (`gpipe`'s body):

  * tick t: stage 0 takes microbatch t, stage r works on microbatch
    t − r (`_micro`); then one hop sends the stage's output to stage
    r + 1 and receives stage r − 1's, in one ``batch_isend_irecv``, so
    that a send and a receive of one tick cannot block each other;
  * the last stage records its finished microbatches and they are
    broadcast to every pipe rank (the reference's ``psum`` over a mask);
  * the backward is written out in `_GPipe`'s own backward: the ticks in
    reverse, each with the reverse hop (gradients to stage r − 1, from
    stage r + 1), then the stage's backward of that tick's microbatch
    through ``torch.autograd.grad``.  Every rank makes its hops in one
    fixed order, which autograd would not guarantee over independent
    microbatches.

Bubble ticks (a stage with no live microbatch) are skipped: the
reference computes them on zeros and masks the result, the port makes
no call, so each block runs M times a step, not M + S − 1.

The transport is an object with ``size``, ``index``, ``exchange(send,
recv_like, step)`` and ``replicate(x)``: `Hop` over the bound axis, or
``kernel_check.LocalPipe``'s in-process endpoints, which run the same
body for S stages in one process on one card.

``layer.PipelineStack`` builds on this: `shard_stages` keeps each rank's
own stage's blocks on its device and frees the others'.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from . import communicator as comm
from . import mesh as mesh_mod
from .mesh import PIPE_AXIS, pipeline_mesh

__all__ = ["gpipe", "stack_stage_params", "pipeline_mesh", "Hop",
           "shard_stages", "stage_of", "held_elsewhere", "PIPE_AXIS"]

#: the forward hop's direction: stage r sends to r + _PIPE_STEP (a planted
#: fault of kernel_check.PIPE_FAULTS turns it)
_PIPE_STEP = 1


def _micro(t: int, r: int, S: int, M: int) -> Optional[int]:
    """The microbatch stage `r` of `S` works on at tick `t`, or None on a
    bubble tick."""
    j = t - r
    return j if 0 <= j < M else None


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    axis."""
    flats, spec = zip(*(tree_flatten(t) for t in per_stage_params))
    return tree_unflatten([torch.stack(xs) for xs in zip(*flats)], spec[0])


class Hop:
    """The real hop over a bound `axis`: `size` stages, this one at
    `index`."""

    def __init__(self, axis: str = PIPE_AXIS):
        self.axis = axis
        self.size = comm.axis_size(axis)
        self.index = comm.axis_index(axis)

    def exchange(self, send: Optional[torch.Tensor],
                 recv_like: Optional[torch.Tensor], step: int):
        """Send `send` to stage index + step and receive, into a tensor
        like `recv_like`, stage index − step's, in one batch; None where
        nothing is received."""
        m = mesh_mod.current_mesh()
        line, group = m.line(self.axis), m.group(self.axis)
        S, i = self.size, self.index
        ops, out = [], None
        if send is not None:
            comm._staged("p2p", send, self.axis)
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  line[(i + step) % S], group))
        if recv_like is not None:
            out = torch.empty_like(recv_like, memory_format=torch.contiguous_format)
            ops.append(dist.P2POp(dist.irecv, out, line[(i - step) % S],
                                  group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def replicate(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's `x` on every stage."""
        return comm.broadcast(x, self.axis, src=self.size - 1)


class _Schedule:
    """One rank's part of the GPipe schedule over `n_micro` microbatches:
    `stage_fn(params, h, *extras)` applied at each live tick."""

    def __init__(self, stage_fn: Callable, hop, n_micro: int):
        self.stage_fn, self.hop, self.M = stage_fn, hop, n_micro
        self.S, self.r = hop.size, hop.index

    def forward(self, x_micro, extras, params, grad: bool):
        """The outputs (M, mb, ...) of the last stage, on every stage; with
        `grad`, each live tick's input and output kept for the backward
        (ticks -> (x_in, y))."""
        S, r, M = self.S, self.r, self.M
        T = M + S - 1
        last = r == S - 1
        like = x_micro[0]
        buf, saved, outs = None, {}, [None] * M
        for t in range(T):
            j = _micro(t, r, S, M)
            y = None
            if j is not None:
                x_in = x_micro[j] if r == 0 else (
                    buf if buf is not None else torch.zeros_like(like))
                ex = tuple(e[j] for e in extras)
                if grad:
                    x_in = x_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y = self.stage_fn(params, x_in, *ex)
                    saved[t] = (x_in, y)
                else:
                    y = self.stage_fn(params, x_in, *ex)
                if last:
                    outs[j] = y.detach()
            if t < T - 1:
                send = y.detach() if y is not None and r < S - 1 else None
                recv = r > 0 and _micro(t, r - 1, S, M) is not None
                buf = self.hop.exchange(send, like if recv else None,
                                        _PIPE_STEP)
        if last:
            res = torch.stack([o if o is not None else torch.zeros_like(like)
                               for o in outs])
        else:
            res = torch.zeros_like(x_micro)
        return self.hop.replicate(res), saved

    def backward(self, saved, g_outs, params, x_grad: bool):
        """The reverse schedule: (gradient of x_micro or None, gradients of
        `params`)."""
        S, r, M = self.S, self.r, self.M
        T = M + S - 1
        last = r == S - 1
        like = g_outs[0]
        gx = torch.zeros_like(g_outs) if x_grad else None
        wants = [p for p in params if p.requires_grad]
        gp: Dict[int, torch.Tensor] = {}
        g_recv = None        # gradient of the activation received at tick t
        for t in reversed(range(T)):
            g_y = None
            if t < T - 1:
                sent = _micro(t, r, S, M) is not None and r < S - 1
                recvd = r > 0 and _micro(t, r - 1, S, M) is not None
                send = None
                if recvd:
                    send = g_recv if g_recv is not None else \
                        torch.zeros_like(like)
                g_y = self.hop.exchange(send, like if sent else None,
                                        -_PIPE_STEP)
            g_recv = None
            j = _micro(t, r, S, M)
            if j is None:
                continue
            x_in, y = saved.pop(t)
            if last:
                g_y = g_outs[j]
            if g_y is None:
                g_y = torch.zeros_like(y)
            grads = torch.autograd.grad(y, [x_in] + wants, g_y.to(y.dtype),
                                        allow_unused=True)
            if r == 0:
                if gx is not None and grads[0] is not None:
                    gx[j] += grads[0].to(gx.dtype)
            else:
                g_recv = grads[0]
            for p, g in zip(wants, grads[1:]):
                if g is not None:
                    gp[id(p)] = g if id(p) not in gp else gp[id(p)] + g
        return gx, [gp.get(id(p)) if p.requires_grad else None
                    for p in params]


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: inputs x_micro, the extras'
    count, the extras and the stage's parameters."""

    @staticmethod
    def forward(ctx, sched, n_extras, x_micro, *rest):
        extras, params = rest[:n_extras], rest[n_extras:]
        out, saved = sched.forward(x_micro, extras, params, grad=True)
        ctx.sched, ctx.saved, ctx.n_extras = sched, saved, n_extras
        ctx.params = params
        return out

    @staticmethod
    def backward(ctx, g):
        gx, gp = ctx.sched.backward(ctx.saved, g.contiguous(), ctx.params,
                                    ctx.needs_input_grad[2])
        ctx.saved = ctx.params = None
        return (None, None, gx) + (None,) * ctx.n_extras + tuple(gp)


def run_schedule(stage_fn: Callable, params: Sequence[torch.Tensor],
                 x_micro: torch.Tensor, extras=(), n_micro: int = 1,
                 hop=None) -> torch.Tensor:
    """This rank's part of the schedule on x_micro (M, mb, ...) and the
    non-differentiable extras (M, mb, ...): the last stage's outputs
    (M, mb, ...) on every rank.  Differentiable in x_micro and `params`
    (the tensors `stage_fn` reads) when gradients are on."""
    hop = hop if hop is not None else Hop()
    sched = _Schedule(stage_fn, hop, n_micro)
    params = tuple(params)
    if torch.is_grad_enabled() and (x_micro.requires_grad or any(
            p.requires_grad for p in params)):
        return _GPipe.apply(sched, len(extras), x_micro, *extras, *params)
    return sched.forward(x_micro, extras, params, grad=False)[0]


def gpipe(stage_fn: Callable, n_micro: int, axis: str = PIPE_AXIS,
          hop=None):
    """Build this rank's body of a GPipe pipeline over `axis`.

    stage_fn(stage_params, x) -> y maps one microbatch through one stage,
    keeping its shape and dtype.  Returns body(stage_params, x_micro):
      * stage_params: a tree whose leaves carry a leading stage axis,
        either every stage's (length = the axis size; this rank takes
        its row) or this rank's alone (length 1);
      * x_micro: (n_micro, mb, ...), the same on every rank;
    and the result is (n_micro, mb, ...): the last stage's outputs, the
    same on every rank.  `hop`: the transport (default `Hop(axis)`)."""

    def body(stage_params, x_micro):
        h = hop if hop is not None else Hop(axis)
        leaves, spec = tree_flatten(stage_params)
        for leaf in leaves:
            if leaf.shape[0] not in (1, h.size):
                raise ValueError(
                    f"stacked stage count x pipe axis mismatch: the leading "
                    f"stage axis is {leaf.shape[0]}, expected {h.size} (the "
                    f"size of '{axis}') or 1 (this rank's stage): stack "
                    f"exactly one stage per rank")
        own = [leaf[h.index if leaf.shape[0] > 1 else 0] for leaf in leaves]

        def fn(ps, x):
            return stage_fn(tree_unflatten(list(ps), spec), x)
        return run_schedule(fn, own, x_micro, n_micro=n_micro, hop=h)

    return body


# ---------------------------------------------------------------------------
# per-rank stages of a layer.PipelineStack
# ---------------------------------------------------------------------------

def stage_of(p: torch.Tensor) -> Optional[int]:
    """The pipe stage that holds parameter `p` (None: every rank)."""
    return getattr(p, "pipe_stage", None)


def held_elsewhere(model) -> List[str]:
    """The parameter paths of blocks that another pipe rank holds."""
    return [n for n, p in model.named_parameters()
            if not getattr(p, "pipe_held", True)]


def shard_stages(model, mesh) -> None:
    """Cut every ``layer.PipelineStack`` of `model` whose ``stages`` equal
    the mesh's bound ``pipe`` axis: this rank keeps its stage's blocks
    and frees the others' parameters (each keeps its ``pipe_shape``).
    Block parameters record their stage (``pipe_stage``); those of
    other stages drop out of ``get_params()``.  A stack whose blocks the
    schedule cannot replay (``_structural_blocker``) stays whole on
    every rank and runs sequentially."""
    from ..layer import PipelineStack
    if mesh is None or mesh.shape.get(PIPE_AXIS, 1) < 2 or not mesh.bound:
        return
    S = mesh.shape[PIPE_AXIS]
    stage = mesh.axis_index(PIPE_AXIS)
    for mod in model.modules():
        if not isinstance(mod, PipelineStack) or mod.cut is not None:
            continue
        if mod.stages != S:
            warnings.warn(
                f"PipelineStack({mod.name}): mesh 'pipe' axis is {S} but "
                f"stages={mod.stages}; every rank keeps every block and "
                f"runs them sequentially (set pipeline_stages to the "
                f"mesh's pipe size)", stacklevel=3)
            continue
        why = mod._structural_blocker()
        if why:
            warnings.warn(f"PipelineStack({mod.name}) running "
                          f"sequentially: {why}", stacklevel=3)
            continue
        k = len(mod) // S
        with torch.no_grad():
            for i, blk in enumerate(mod):
                for p in blk.parameters():
                    p.pipe_stage = i // k
                    if i // k != stage:
                        p.pipe_shape = tuple(p.shape)
                        p.data = p.data.new_empty((0,))
                        p.pipe_held = False
        mod.cut = (mesh, stage)


def gather_stages(model, payload: Dict) -> List[Dict]:
    """Every pipe rank's `payload` (this rank's stage's host arrays), in
    stage order: a collective over the pipe axis of the mesh the stack
    was cut on; [payload] where nothing is cut."""
    from ..layer import PipelineStack
    cut = next((m.cut for m in model.modules()
                if isinstance(m, PipelineStack) and m.cut is not None), None)
    if cut is None:
        return [payload]
    mesh = cut[0]
    out: List = [None] * mesh.shape[PIPE_AXIS]
    dist.all_gather_object(out, payload, group=mesh.group(PIPE_AXIS))
    return out
