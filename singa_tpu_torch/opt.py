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

DistOpt is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from . import autograd

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "RMSProp", "AdaGrad",
           "Adafactor", "GradAccum", "Schedule", "Constant",
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
