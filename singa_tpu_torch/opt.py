"""Optimizers and learning-rate schedules, ported from
``singa_tpu/opt.py`` (``Schedule`` and its subclasses, ``Optimizer``,
``SGD``, ``Adam``, ``AdamW``, ``RMSProp``, ``AdaGrad``, ``Adafactor``,
``GradAccum``).

The reference gives each optimizer a pure functional core, ``apply``,
that the graph executor compiles into the step.  Here ``apply`` updates
the f32 parameter in place under ``torch.no_grad()`` and returns the
slot (momentum buffer, Adam's (m, v), Adafactor's dict), which it also
updates in place: the port updates in place to keep one copy of the
masters and moments on the card, and so that a captured step (a CUDA
graph) reads and writes the same storage on every replay.
``Optimizer.update``'s per-name eager store (``_eager_state``) is the
slot store in every mode.  Slots are keyed by the parameter's attribute
path, which ``Layer.get_params`` records on each parameter
(``param_name``).

The step reaches ``apply`` as a 0-d int64 tensor on the parameters'
device (``Optimizer.step_tensor``), advanced on the device by ``step``:
a schedule, Adam's bias correction and GradAccum's choice of update are
computed from it by torch ops, as the reference computes them with jnp
from a traced step, so a captured step reads the step of each replay
and never the one it was captured at.  Schedules also take an int.
Step-dependent scalars are computed in float64 and rounded to f32 where
they enter the update (the reference computes its schedules in f32, and
its eager bias correction in Python floats).

``DistOpt`` wraps any of them with the data-parallel gradient sync of
``parallel.communicator`` (plain mean, bf16, top-K, int8, and the int8
ring with a per-rank error-feedback residual) and ZeRO-1
(``shard_weight_update``: each rank updates its 1/W shard of every
flattened parameter and keeps only that shard's slots).
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import autograd
from .obs import attr as obs_attr
from .obs import events as obs_events
from .parallel import communicator as comm
from .parallel import mesh as mesh_mod
from .parallel import pipeline
from .parallel import spmd

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "Adafactor", "GradAccum", "DistOpt", "Schedule", "Constant",
           "ExponentialDecay", "CosineDecay", "WarmupCosine", "MultiStepLR"]


def _f64(step) -> torch.Tensor:
    """`step` (an int or a 0-d tensor) as a float64 tensor on its
    device."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float64)
    return torch.tensor(float(step), dtype=torch.float64)


# ---------------------------------------------------------------------------
# learning-rate schedules (step -> lr, torch ops on the step's device)
# ---------------------------------------------------------------------------

class Schedule:
    def __call__(self, step):
        raise NotImplementedError


class Constant(Schedule):
    def __init__(self, lr: float):
        self.lr = lr

    def __call__(self, step):
        return self.lr


class ExponentialDecay(Schedule):
    def __init__(self, lr: float, decay_steps: int, decay_rate: float,
                 staircase: bool = False):
        self.lr, self.decay_steps = lr, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def __call__(self, step):
        p = _f64(step) / self.decay_steps
        if self.staircase:
            p = torch.floor(p)
        return self.lr * torch.pow(self.decay_rate, p)


class CosineDecay(Schedule):
    def __init__(self, lr: float, total_steps: int, alpha: float = 0.0):
        self.lr, self.total_steps, self.alpha = lr, total_steps, alpha

    def __call__(self, step):
        frac = torch.clamp(_f64(step) / self.total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return self.lr * ((1 - self.alpha) * cos + self.alpha)


class WarmupCosine(Schedule):
    def __init__(self, lr: float, warmup_steps: int, total_steps: int,
                 min_lr: float = 0.0):
        self.lr, self.warmup, self.total = lr, warmup_steps, total_steps
        self.min_lr = min_lr

    def __call__(self, step):
        s = _f64(step)
        warm = self.lr * s / max(1, self.warmup)
        frac = torch.clamp((s - self.warmup) / max(1, self.total - self.warmup),
                           0.0, 1.0)
        cos = self.min_lr + (self.lr - self.min_lr) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(s < self.warmup, warm, cos)


class MultiStepLR(Schedule):
    def __init__(self, lr: float, milestones: List[int], gamma: float = 0.1):
        self.lr, self.milestones, self.gamma = lr, sorted(milestones), gamma

    def __call__(self, step):
        s = _f64(step)
        n = torch.zeros_like(s)
        for m in self.milestones:
            n = n + (s >= m).to(s.dtype)
        return self.lr * torch.pow(self.gamma, n)


def _as_schedule(lr) -> Schedule:
    if isinstance(lr, Schedule):
        return lr
    return Constant(float(lr))


def param_name(p: torch.Tensor) -> str:
    """The slot key of a parameter: its attribute path where a layer
    recorded one, else its id (as the reference falls back to)."""
    return getattr(p, "param_name", None) or str(id(p))


def _leaves(slot) -> List[torch.Tensor]:
    """A slot's tensors in the reference's ``jax.tree.leaves`` order:
    tuples in order, dicts by sorted key, None holds none."""
    if slot is None:
        return []
    if isinstance(slot, torch.Tensor):
        return [slot]
    if isinstance(slot, dict):
        return [t for k in sorted(slot) for t in _leaves(slot[k])]
    return [t for s in slot for t in _leaves(s)]


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class Optimizer:
    def __init__(self, lr):
        self.sched = _as_schedule(lr)
        self.step_counter = 0
        self._eager_state: Dict = {}
        self._step_dev: Optional[torch.Tensor] = None

    # -- the step on the device -------------------------------------------------
    def step_tensor(self, device) -> torch.Tensor:
        """The step as a 0-d int64 tensor on `device`, made from
        `step_counter` at first use and advanced on the device by
        `step()`; `set_states` writes it.  A captured step must find it
        made: its first use writes host data to the device."""
        t = self._step_dev
        if t is None or t.device != torch.device(device):
            t = self._step_dev = torch.tensor(self.step_counter,
                                              dtype=torch.int64,
                                              device=device)
        return t

    # -- the update core ------------------------------------------------------
    def init_slot(self, p: torch.Tensor):
        """A fresh slot for parameter p (None when stateless)."""
        return None

    def apply(self, step, name: str, p: torch.Tensor, g: torch.Tensor,
              slot):
        """Update p in place from gradient g at `step` (an int or a 0-d
        tensor); returns the slot (updated in place)."""
        raise NotImplementedError

    # -- eager SINGA surface --------------------------------------------------
    @torch.no_grad()
    def update(self, param: torch.Tensor, grad: torch.Tensor) -> None:
        name = param_name(param)
        slot = self._eager_state.get(name)
        if slot is None:
            slot = self.init_slot(param)
        self._eager_state[name] = self.apply(
            self.step_tensor(param.device), name, param,
            grad.to(param.dtype), slot)

    def __call__(self, loss: torch.Tensor) -> None:
        """backward + update (reference `opt(loss)` convenience)."""
        for p, g in autograd.backward(loss):
            self.update(p, g)
        self.step()

    def backward_and_update(self, loss: torch.Tensor) -> None:
        """Reference surface: the same as __call__ for a single device."""
        self(loss)

    def step(self) -> None:
        self.step_counter += 1
        if self._step_dev is not None:
            self._step_dev.add_(1)

    def get_states(self) -> Dict:
        return {"step": self.step_counter}

    def set_states(self, s: Dict) -> None:
        self.step_counter = int(s.get("step", 0))
        if self._step_dev is not None:
            self._step_dev.fill_(self.step_counter)

    def state_signature(self) -> str:
        """Identifies the slot structure this optimizer produces, so a
        restore into a structurally different optimizer is refused."""
        return type(self).__name__

    # -- moment persistence ---------------------------------------------------
    def slot_arrays(self) -> Dict[str, List[torch.Tensor]]:
        """Per-param moment tensors as {name: [tensor, ...]} in the
        reference's leaf order; empty lists for stateless slots."""
        return {name: _leaves(slot)
                for name, slot in self._eager_state.items()}

    def load_slot_arrays(self, slots: Dict[str, List]) -> None:
        """Rebuild the slot store from `slot_arrays` output: 0 tensors ->
        None, 1 -> the tensor, N -> a tuple."""
        est = {}
        for name, leaves in slots.items():
            arrs = [torch.as_tensor(l) for l in leaves]
            est[name] = (None if not arrs else arrs[0] if len(arrs) == 1
                         else tuple(arrs))
        self._eager_state = est


class SGD(Optimizer):
    """SGD with momentum / nesterov / dampening / L2 weight decay."""

    def __init__(self, lr=0.1, momentum=0.0, weight_decay=0.0,
                 nesterov=False, dampening=0.0):
        super().__init__(lr)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.dampening = dampening

    def init_slot(self, p):
        return None if self.momentum == 0.0 else torch.zeros_like(p)

    def state_signature(self) -> str:
        return f"SGD(momentum={bool(self.momentum)})"

    def apply(self, step, name, p, g, slot):
        lr = self.sched(step)
        if self.weight_decay:
            g = g + self.weight_decay * p
        if self.momentum:
            slot.mul_(self.momentum).add_(g, alpha=1 - self.dampening)
            g = g + self.momentum * slot if self.nesterov else slot
            p.sub_(lr * g)
            return slot
        p.sub_(lr * g)
        return None


class Adam(Optimizer):
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(lr)
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.decoupled = False

    def init_slot(self, p):
        return (torch.zeros_like(p), torch.zeros_like(p))

    def apply(self, step, name, p, g, slot):
        lr = self.sched(step)
        m, v = slot
        if self.weight_decay and not self.decoupled:
            g = g + self.weight_decay * p
        t = _f64(step) + 1
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
        upd = (m / (1 - torch.pow(self.b1, t))) / (
            torch.sqrt(v / (1 - torch.pow(self.b2, t))) + self.eps)
        if self.weight_decay and self.decoupled:
            upd = upd + self.weight_decay * p
        p.sub_(lr * upd)
        return (m, v)


class AdamW(Adam):
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01):
        super().__init__(lr, betas, eps, weight_decay)
        self.decoupled = True


class RMSProp(Optimizer):
    def __init__(self, lr=1e-2, rho=0.9, eps=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.rho, self.eps, self.weight_decay = rho, eps, weight_decay

    def init_slot(self, p):
        return torch.zeros_like(p)

    def apply(self, step, name, p, g, slot):
        lr = self.sched(step)
        if self.weight_decay:
            g = g + self.weight_decay * p
        slot.mul_(self.rho).add_(g * g, alpha=1 - self.rho)
        p.sub_(lr * g / (torch.sqrt(slot) + self.eps))
        return slot


class AdaGrad(Optimizer):
    def __init__(self, lr=1e-2, eps=1e-8, weight_decay=0.0):
        super().__init__(lr)
        self.eps, self.weight_decay = eps, weight_decay

    def init_slot(self, p):
        return torch.zeros_like(p)

    def apply(self, step, name, p, g, slot):
        lr = self.sched(step)
        if self.weight_decay:
            g = g + self.weight_decay * p
        slot.add_(g * g)
        p.sub_(lr * g / (torch.sqrt(slot) + self.eps))
        return slot


class Adafactor(Optimizer):
    """Adafactor (Shazeer & Stern 2018): the second moment of a matrix
    parameter is kept as a row and a column factor (r + c floats for
    r·c), in f32 whatever the parameter's dtype.

    ``lr=None`` (the default) takes the relative step size
    min(relative_step_cap, 1/sqrt(t)), scaled by the parameter's rms
    (``multiply_by_parameter_scale``, on by default in that mode); an
    explicit ``lr`` is a fixed or scheduled step size.  ``momentum``
    adds back a full-size first moment.  Factorization covers the last
    two axes when both are >= min_dim_size_to_factor; smaller or 1-D
    parameters keep a full second moment.  Slots are dicts with the
    reference's keys (``vr``/``vc`` or ``v``, and ``m``)."""

    def __init__(self, lr=None, min_dim_size_to_factor=128,
                 decay_rate=0.8, multiply_by_parameter_scale=None,
                 clipping_threshold=1.0, momentum=None,
                 eps=(1e-30, 1e-3), weight_decay=0.0,
                 relative_step_cap=1e-2):
        super().__init__(0.0 if lr is None else lr)
        self.relative = lr is None
        if multiply_by_parameter_scale is None:
            multiply_by_parameter_scale = self.relative
        self.min_factor = int(min_dim_size_to_factor)
        self.decay_rate = float(decay_rate)
        self.param_scale = bool(multiply_by_parameter_scale)
        self.clip = clipping_threshold
        self.momentum = momentum
        self.eps1, self.eps2 = eps
        self.weight_decay = weight_decay
        self.relative_step_cap = relative_step_cap

    def _factored(self, p) -> bool:
        return (p.ndim >= 2
                and min(p.shape[-2], p.shape[-1]) >= self.min_factor)

    def init_slot(self, p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if self._factored(p):
            slot = {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        else:
            slot = {"v": torch.zeros(p.shape, **f32)}
        if self.momentum:
            slot["m"] = torch.zeros(p.shape, **f32)
        return slot

    def apply(self, step, name, p, g, slot):
        t = _f64(step) + 1
        decay = 1.0 - torch.pow(t, -self.decay_rate)
        g32 = g.float()
        gsq = g32 * g32 + self.eps1
        if "vr" in slot:
            vr, vc = slot["vr"], slot["vc"]
            vr.mul_(decay).add_((1 - decay) * gsq.mean(-1))
            vc.mul_(decay).add_((1 - decay) * gsq.mean(-2))
            reduced = vr.mean(-1, keepdim=True)
            y = (g32 * torch.rsqrt(vr / reduced)[..., None]
                 * torch.rsqrt(vc)[..., None, :])
        else:
            v = slot["v"]
            v.mul_(decay).add_((1 - decay) * gsq)
            y = g32 * torch.rsqrt(v)
        if self.clip:
            rms_y = torch.sqrt(torch.mean(y * y))
            y = y / torch.clamp(rms_y / self.clip, min=1.0)
        if self.relative:
            rho = torch.clamp(torch.rsqrt(t), max=self.relative_step_cap)
        else:
            rho = self.sched(step)
        p32 = p.float()
        if self.param_scale:
            rho = rho * torch.clamp(torch.sqrt(torch.mean(p32 * p32)),
                                    min=self.eps2)
        upd = rho * y
        if self.momentum:
            m = slot["m"]
            m.mul_(self.momentum).add_((1 - self.momentum) * upd)
            upd = m
        if self.weight_decay:
            upd = upd + rho * self.weight_decay * p32
        p.sub_(upd.to(p.dtype))
        return slot

    def state_signature(self) -> str:
        return (f"Adafactor(f{self.min_factor},"
                f"m{self.momentum or 0})")

    def load_slot_arrays(self, slots: Dict[str, List]) -> None:
        """Rebuild the dict slots from the checkpoint's flat leaf lists,
        which come in sorted-key order: ["m"?, "v"] or ["m"?, "vc",
        "vr"]."""
        est = {}
        for name, leaves in slots.items():
            arrs = [torch.as_tensor(l) for l in leaves]
            if not arrs:
                est[name] = None
                continue
            slot = {}
            if self.momentum:
                slot["m"] = arrs[0]
                arrs = arrs[1:]
            if len(arrs) == 1:
                slot["v"] = arrs[0]
            elif len(arrs) == 2:
                slot["vc"], slot["vr"] = arrs
            else:
                raise ValueError(
                    f"unexpected Adafactor slot leaf count for {name!r}: "
                    f"{len(arrs)}")
            est[name] = slot
        self._eager_state = est


def _select_(do: torch.Tensor, new, old) -> None:
    """old <- where(do, new, old), leaf by leaf, in place."""
    for n, o in zip(_leaves(new), _leaves(old)):
        o.copy_(torch.where(do, n, o))


class GradAccum(Optimizer):
    """Gradient accumulation over `every` microbatches.

    Each train step adds the microbatch gradient into an f32
    accumulator; every `every`-th step the wrapped optimizer applies the
    mean accumulated gradient and the accumulator resets.  As in the
    reference, both branches are computed and one is selected on the
    device (here with ``torch.where``), so a captured step has no
    data-dependent control flow: the wrapped optimizer updates copies of
    the parameter and its slot, which are kept only on update steps.
    The wrapped optimizer's schedule sees the number of applied updates
    (step // every)."""

    def __init__(self, opt: Optimizer, every: int):
        super().__init__(opt.sched)
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.opt = opt
        self.every = int(every)

    def init_slot(self, p):
        return {"acc": torch.zeros_like(p, dtype=torch.float32),
                "base": self.opt.init_slot(p)}

    def apply(self, step, name, p, g, slot):
        k = self.every
        step = torch.as_tensor(step, device=p.device)
        acc, base = slot["acc"], slot["base"]
        acc.add_(g.float())
        do = (step % k) == (k - 1)
        new_p = p.clone()
        new_base = _clone(base)
        new_base = self.opt.apply(step // k, name, new_p,
                                  (acc / k).to(p.dtype), new_base)
        _select_(do, new_p, p)
        _select_(do, new_base, base)
        acc.copy_(torch.where(do, torch.zeros_like(acc), acc))
        return slot

    def state_signature(self) -> str:
        return f"GradAccum({self.every})>{self.opt.state_signature()}"

    def load_slot_arrays(self, slots: Dict[str, List]) -> None:
        """Rebuild {"acc", "base"} slots from the checkpoint's flat leaf
        lists: leaf 0 is the accumulator; the rest rebuild the wrapped
        optimizer's slot through its own load_slot_arrays."""
        heads, rests = {}, {}
        for name, leaves in slots.items():
            arrs = [torch.as_tensor(l) for l in leaves]
            if not arrs:
                raise ValueError(
                    f"GradAccum slot for {name!r} is empty in checkpoint")
            heads[name] = arrs[0]
            rests[name] = arrs[1:]
        saved_inner = self.opt._eager_state
        self.opt.load_slot_arrays(rests)
        inner = self.opt._eager_state
        self.opt._eager_state = saved_inner
        self._eager_state = {n: {"acc": heads[n], "base": inner.get(n)}
                             for n in heads}


def _clone(slot):
    """A copy of a slot, structure and all."""
    if slot is None:
        return None
    if isinstance(slot, torch.Tensor):
        return slot.clone()
    if isinstance(slot, dict):
        return {k: _clone(v) for k, v in slot.items()}
    return type(slot)(_clone(s) for s in slot)


# ---------------------------------------------------------------------------
# DistOpt — the data-parallel wrapper (the reference Communicator's
# allreduce as explicit torch.distributed collectives over 'data')
# ---------------------------------------------------------------------------

#: DistOpt gradient-compression modes with optimizer state of their own
#: (the error-feedback residual); `compress_dtype` keeps covering the
#: stateless casts and quantizers
_COMPRESSION_MODES = ("int8_ring",)


def _elementwise(opt: Optimizer) -> bool:
    """True when opt's update reads each element of the parameter, its
    gradient and its slot alone, so it runs unchanged on a flat shard."""
    if isinstance(opt, GradAccum):
        return _elementwise(opt.opt)
    return isinstance(opt, (SGD, Adam, RMSProp, AdaGrad))


def _cuda_sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def replica_axes(mesh) -> Tuple[str, ...]:
    """The axes of `mesh` whose ranks hold different data: every axis but
    ``model``, ``pipe`` and ``expert`` (whose ranks see the same batch)."""
    same = (mesh_mod.MODEL_AXIS, mesh_mod.PIPE_AXIS, mesh_mod.EXPERT_AXIS)
    return tuple(a for a in mesh.axis_names if a not in same)


class DistOpt(Optimizer):
    """Wraps a base optimizer with the data-parallel gradient sync.

    Under a current ``data`` mesh with an initialized process group
    (``parallel.init_distributed``, ``parallel.set_mesh``), every
    ``backward_and_update`` mean-allreduces the gradients over the
    ranks before the wrapped optimizer updates; with no mesh or no group
    the sync is the identity.  The model's train step (``compile(...,
    use_graph=True)``, ``train_step``) feeds each rank its rows of the
    global batch and, on the card, captures the step, collectives
    included, as one CUDA graph.  Variants, as the reference's:

      * ``compress_dtype=torch.bfloat16``: cast, mean, cast back
        (`backward_and_update_half` for one step);
      * ``topk_ratio``: the fixed-K sparsified exchange
        (`backward_and_partial_update`);
      * ``compress_dtype="int8"``: blockwise int8 codes summed in int32;
      * ``compression="int8_ring"``: the int8 ring with error feedback.
        Every slot becomes ``{"base": <inner slot>, "ef": residual}``,
        the residual this rank's f32 quantization error, shape
        (1, *param.shape); a checkpoint gathers every rank's into the
        reference's (world, *param.shape) and each rank takes its row
        back on load;
      * ``shard_weight_update=True`` (ZeRO-1): the gradients are
        reduce-scattered over each flattened, padded parameter, each
        rank updates its 1/W shard and holds only that shard's slots,
        and the parameters are all-gathered.  It needs an elementwise
        base optimizer (SGD, Adam, AdamW, RMSProp, AdaGrad, GradAccum
        over one of them); checkpoints carry the slots at their natural
        shapes.

    `data_axis` may name any axis of the mesh (``DistOpt(...,
    data_axis='dp')`` under ``make_mesh({'dp': 2, 'seq': 2})``).  On a
    multi-axis mesh the gradients are averaged over the axes whose ranks
    hold different data: every axis but ``model``, ``pipe`` and
    ``expert`` (``data`` × ``seq``), each parameter being this rank's
    block of it (tensor parallelism), this rank's experts (expert
    parallelism) or its stage's blocks (pipeline stages).  Under a
    ``pipe`` axis every parameter outside the stages is then broadcast
    from stage 0, which holds its whole gradient: the embedding's comes
    only there, and the final norm's and the head's are the same on
    every stage (a sum would count them once per stage).  ZeRO-1 then
    shards the blocks over the data axis after a mean over the other
    axes; the compressed and sparsified modes warn and are ignored
    there, as the reference's."""

    def __init__(self, opt: Optimizer, nccl_id=None, local_rank: int = 0,
                 world_size: Optional[int] = None, data_axis: str = "data",
                 compress_dtype=None, topk_ratio: float = 0.0,
                 shard_weight_update: bool = False,
                 compression: Optional[str] = None,
                 error_feedback: bool = True,
                 compression_block: int = 256):
        super().__init__(opt.sched)
        if compression is not None and compression not in _COMPRESSION_MODES:
            raise ValueError(
                f"unknown compression mode {compression!r} "
                f"(known: {_COMPRESSION_MODES})")
        if compression is not None and (compress_dtype is not None
                                        or topk_ratio):
            raise ValueError(
                "compression= is exclusive with compress_dtype=/"
                "topk_ratio= — pick one gradient-sync variant")
        if shard_weight_update and not _elementwise(opt):
            raise NotImplementedError(
                f"shard_weight_update over {type(opt).__name__}: the port's "
                f"ZeRO-1 updates flat shards, which needs an elementwise "
                f"optimizer (SGD, Adam, AdamW, RMSProp, AdaGrad)")
        self.opt = opt
        self.data_axis = data_axis
        self.compress_dtype = compress_dtype
        self.topk_ratio = topk_ratio
        self.local_rank = local_rank
        self._world_size = world_size
        self.compression = compression
        self.error_feedback = bool(error_feedback)
        self.compression_block = int(compression_block)
        self.shard_weight_update = shard_weight_update
        #: natural shapes of the parameters whose slots are ZeRO-1 shards
        self._shapes: Dict[str, torch.Size] = {}
        del nccl_id  # reference-API compat; the group is torch.distributed's

    @property
    def world_size(self) -> int:
        if self._world_size is not None:
            return self._world_size
        m = mesh_mod.current_mesh()
        if m is not None and self.data_axis in m.shape:
            return m.shape[self.data_axis]
        return 1

    def _multi_axis(self) -> bool:
        """The current mesh has an axis other than the data axis."""
        m = mesh_mod.current_mesh()
        return m is not None and any(a != self.data_axis for a in m.shape)

    def _replica_axes(self) -> Tuple[str, ...]:
        """On a multi-axis mesh, the axes whose ranks hold different data
        (every axis but ``model``, ``pipe`` and ``expert``): the
        gradients' mean is over them."""
        return replica_axes(mesh_mod.current_mesh())

    @staticmethod
    def _pipe_sync(grads, staged) -> Dict[str, torch.Tensor]:
        """Every gradient of a parameter outside the pipeline stages
        (names not in `staged`), broadcast from stage 0, in name order."""
        if comm.axis_size(mesh_mod.PIPE_AXIS) < 2:
            return grads
        out = dict(grads)
        for name in sorted(n for n, g in grads.items()
                           if g is not None and n not in staged):
            out[name] = comm.broadcast(grads[name], mesh_mod.PIPE_AXIS, 0)
        return out

    def _zero1(self) -> bool:
        """ZeRO-1 runs now: eligible under the current mesh, and its axis
        bound to a process group."""
        return (spmd.zero1_axis_for(self, mesh_mod.current_mesh())
                is not None and comm.axis_bound(self.data_axis))

    # -- the update core --------------------------------------------------------
    def init_slot(self, p):
        if self._zero1():
            self._shapes[param_name(p)] = p.shape
            W = comm.axis_size(self.data_axis)
            shard = p.new_empty((-(-p.numel() // W),))
            return self.opt.init_slot(shard)
        inner = self.opt.init_slot(p)
        if self.compression is None:
            return inner
        return {"base": inner,
                "ef": torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                                  device=p.device)}

    def apply(self, step, name, p, g, slot):
        if self.compression is None:
            return self.opt.apply(step, name, p, g, slot)
        # g arrives synced (reduce_gradients wrote the new residual into
        # the slot); the inner update runs on the base half
        slot["base"] = self.opt.apply(step, name, p, g, slot["base"])
        return slot

    # -- the gradient sync --------------------------------------------------------
    def reduce_gradients(self, grads: Dict[str, torch.Tensor],
                         staged=frozenset()) -> Dict[str, torch.Tensor]:
        """Mean-allreduce gradients over the data axis; the identity
        when the axis is not bound.  Under ZeRO-1 each gradient is
        reduce-scattered instead: what comes back is this rank's mean
        shard of the flattened, padded gradient.  `staged`: the names of
        parameters a pipeline stage holds (see the class docstring).

        Telemetry: an ``opt.grad_sync`` span, the communicator's
        counters, and, with a ledger installed (``obs.attr``), the sync's
        seconds under ``grad_sync``, the device synchronised around it,
        on an eager step only (a step being captured runs nothing)."""
        led = obs_attr.get()
        if led is not None and _capturing():
            led = None
        some = next((g for g in grads.values() if g is not None), None)
        with obs_events.span("opt.grad_sync", axis=self.data_axis,
                             tensors=len(grads),
                             compression=self.compression or "none"):
            if led is not None and some is not None:
                _cuda_sync(some)
                t0 = time.perf_counter()
            if self._zero1():
                out = self._reduce_scatter(grads, staged)
            elif self._multi_axis():
                axes = self._replica_axes()
                out = comm.allreduce_grads(grads, axis=axes) if axes \
                    else grads
                out = self._pipe_sync(out, staged)
            elif self.compression == "int8_ring":
                out = self._reduce_int8_ring(grads)
            else:
                out = comm.allreduce_grads(
                    grads, axis=self.data_axis,
                    compress_dtype=self.compress_dtype,
                    topk_ratio=self.topk_ratio)
            if led is not None and some is not None:
                _cuda_sync(some)
                led.note("grad_sync", time.perf_counter() - t0)
            return out

    def _reduce_scatter(self, grads, staged=frozenset()):
        other = tuple(a for a in self._replica_axes()
                      if a != self.data_axis) if self._multi_axis() else ()
        if other:
            # the mean over the other ranks that hold other data (seq)
            grads = comm.allreduce_grads(grads, axis=other)
        grads = self._pipe_sync(grads, staged)
        W = comm.axis_size(self.data_axis)
        out = {}
        for name, g in grads.items():
            if g is None:
                out[name] = None
                continue
            flat = g.reshape(-1)
            flat = F.pad(flat, (0, (-flat.numel()) % W))
            out[name] = comm.reduce_scatter(flat, self.data_axis) \
                * comm._recip(W)
        return out

    def _reduce_int8_ring(self, grads):
        est = self._eager_state
        bound = comm.axis_bound(self.data_axis)
        out = {}
        for name, g in grads.items():
            if g is None:
                out[name] = None
                continue
            slot = est.get(name)
            has_ef = (isinstance(slot, dict) and "ef" in slot
                      and self.error_feedback)
            res = (slot["ef"][0] if has_ef
                   else torch.zeros((), dtype=torch.float32, device=g.device))
            synced, new_res = comm.ef_quantized_allreduce(
                g, res, axis=self.data_axis, block=self.compression_block)
            if has_ef and bound:
                slot["ef"][0].copy_(new_res)   # in place: a graph reads it
            out[name] = synced
        return out

    # -- reference API surface ----------------------------------------------------
    def __call__(self, loss: torch.Tensor) -> None:
        """`opt(loss)` syncs gradients exactly as backward_and_update."""
        self.backward_and_update(loss)

    def backward_and_update(self, loss: torch.Tensor) -> None:
        pg = autograd.backward(loss)
        if self.compression is not None:
            # the residual lives in the slot: make every slot before the
            # sync writes into it
            for p, _ in pg:
                if self._eager_state.get(param_name(p)) is None:
                    self._eager_state[param_name(p)] = self.init_slot(p)
        zero1 = self._zero1()
        staged = {param_name(p) for p, _ in pg
                  if pipeline.stage_of(p) is not None}
        grads = self.reduce_gradients({param_name(p): g for p, g in pg},
                                      staged)
        for p, _ in pg:
            g = grads[param_name(p)]
            if zero1:
                self._update_shard(p, g)
            else:
                self.update(p, g)
        self.step()

    @torch.no_grad()
    def _update_shard(self, p: torch.Tensor, g: torch.Tensor) -> None:
        """ZeRO-1: update this rank's shard of p from its gradient shard
        g, then all-gather the shards into p."""
        name = param_name(p)
        W, r = comm.axis_size(self.data_axis), comm.axis_index(self.data_axis)
        n, c = p.numel(), g.numel()
        shard = F.pad(p.reshape(-1), (0, W * c - n))[r * c:(r + 1) * c]
        shard = shard.clone()
        slot = self._eager_state.get(name)
        if slot is None:
            slot = self.init_slot(p)
        self._eager_state[name] = self.opt.apply(
            self.step_tensor(p.device), name, shard, g.to(p.dtype), slot)
        full = comm.allgather(shard, self.data_axis, tiled=True)
        p.view(-1).copy_(full[:n])

    def backward_and_update_half(self, loss: torch.Tensor) -> None:
        """One bf16-compressed sync; the previous compress_dtype is
        restored afterwards."""
        saved = self.compress_dtype
        self.compress_dtype = torch.bfloat16
        try:
            self.backward_and_update(loss)
        finally:
            self.compress_dtype = saved

    def backward_and_partial_update(self, loss: torch.Tensor,
                                    topk_ratio: float = 0.01) -> None:
        """One top-K sparsified sync; the previous topk_ratio is
        restored afterwards."""
        saved = self.topk_ratio
        self.topk_ratio = topk_ratio
        try:
            self.backward_and_update(loss)
        finally:
            self.topk_ratio = saved

    def step(self) -> None:
        super().step()
        self.opt.step()

    def set_states(self, s: Dict) -> None:
        super().set_states(s)
        self.opt.set_states(s)

    def state_signature(self) -> str:
        if self.compression is not None:
            # the {"base","ef"} wrapping is slot structure of its own: a
            # restore across compression on/off is refused
            return f"EF({self.compression})>{self.opt.state_signature()}"
        return self.opt.state_signature()

    # -- moment persistence ---------------------------------------------------
    def slot_arrays(self) -> Dict[str, List[torch.Tensor]]:
        """Slot leaves at the reference's shapes: ZeRO-1 shards
        all-gathered to their parameters' shapes, and the residual as
        every rank's, (world, *shape), its last leaf.  Under a bound
        axis this is a collective: every rank calls it."""
        out = super().slot_arrays()
        if not comm.axis_bound(self.data_axis):
            return out
        if self.compression is not None:
            for leaves in out.values():
                leaves[-1] = comm.allgather(leaves[-1], self.data_axis,
                                            tiled=True)
        elif self._zero1():
            for name, leaves in out.items():
                shape = self._shapes.get(name)
                out[name] = [comm.allgather(t, self.data_axis, tiled=True)
                             [:math.prod(shape)].reshape(shape)
                             for t in leaves]
        return out

    def load_slot_arrays(self, slots: Dict[str, List]) -> None:
        """Inverse of `slot_arrays`: each rank takes its row of a
        residual and its shard of a ZeRO-1 slot.  A residual saved at
        another world size is refused."""
        W, r = comm.axis_size(self.data_axis), comm.axis_index(self.data_axis)
        efs, rests = {}, {}
        for name, leaves in slots.items():
            arrs = [torch.as_tensor(t) for t in leaves]
            if self.compression is not None:
                if not arrs:
                    raise ValueError(
                        f"compressed DistOpt slot for {name!r} is empty in "
                        f"checkpoint (missing error-feedback residual)")
                ef = arrs.pop().float()
                if ef.shape[0] != W:
                    raise ValueError(
                        f"error-feedback residual of {name!r} was saved at "
                        f"world size {ef.shape[0]}; this run's is {W} — "
                        f"refusing to reassign per-rank residuals")
                efs[name] = ef[r:r + 1].clone()
            elif self._zero1():
                if arrs:
                    self._shapes[name] = arrs[0].shape
                arrs = [F.pad(t.reshape(-1), (0, (-t.numel()) % W))
                        .reshape(W, -1)[r].clone() for t in arrs]
            rests[name] = arrs
        saved_inner = self.opt._eager_state
        self.opt.load_slot_arrays(rests)
        inner = self.opt._eager_state
        self.opt._eager_state = saved_inner
        if self.compression is not None:
            inner = {n: {"base": inner.get(n), "ef": efs[n]} for n in efs}
        self._eager_state = inner
