"""Optimizers and learning-rate schedules, ported from
``singa_tpu/opt.py`` (``Schedule`` and its subclasses, ``Optimizer``,
``SGD``, ``Adam``, ``AdamW``).

The reference gives each optimizer a pure functional core, ``apply``,
that the graph executor compiles into the step.  Here ``apply`` updates
the f32 parameter in place under ``torch.no_grad()`` and returns the
slot (momentum buffer, Adam's (m, v)), which it also updates in place:
the port updates in place to keep one copy of the masters and moments
on the card.  ``Optimizer.update``'s per-name eager store
(``_eager_state``) is the slot store in every mode.  Slots are keyed by
the parameter's attribute path, which ``Layer.get_params`` records on
each parameter (``param_name``).

RMSProp, AdaGrad, Adafactor, GradAccum and DistOpt are not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import autograd

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "Schedule", "Constant",
           "ExponentialDecay", "CosineDecay", "WarmupCosine", "MultiStepLR"]


# ---------------------------------------------------------------------------
# learning-rate schedules (int step -> lr)
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
        p = step / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.lr * self.decay_rate ** p


class CosineDecay(Schedule):
    def __init__(self, lr: float, total_steps: int, alpha: float = 0.0):
        self.lr, self.total_steps, self.alpha = lr, total_steps, alpha

    def __call__(self, step):
        frac = min(max(step / self.total_steps, 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return self.lr * ((1 - self.alpha) * cos + self.alpha)


class WarmupCosine(Schedule):
    def __init__(self, lr: float, warmup_steps: int, total_steps: int,
                 min_lr: float = 0.0):
        self.lr, self.warmup, self.total = lr, warmup_steps, total_steps
        self.min_lr = min_lr

    def __call__(self, step):
        if step < self.warmup:
            return self.lr * step / max(1, self.warmup)
        frac = min(max((step - self.warmup)
                       / max(1, self.total - self.warmup), 0.0), 1.0)
        return self.min_lr + (self.lr - self.min_lr) * 0.5 * (
            1 + math.cos(math.pi * frac))


class MultiStepLR(Schedule):
    def __init__(self, lr: float, milestones: List[int], gamma: float = 0.1):
        self.lr, self.milestones, self.gamma = lr, sorted(milestones), gamma

    def __call__(self, step):
        n = sum(1 for m in self.milestones if step >= m)
        return self.lr * self.gamma ** n


def _as_schedule(lr) -> Schedule:
    if isinstance(lr, Schedule):
        return lr
    return Constant(float(lr))


def param_name(p: torch.Tensor) -> str:
    """The slot key of a parameter: its attribute path where a layer
    recorded one, else its id (as the reference falls back to)."""
    return getattr(p, "param_name", None) or str(id(p))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class Optimizer:
    def __init__(self, lr):
        self.sched = _as_schedule(lr)
        self.step_counter = 0
        self._eager_state: Dict = {}

    # -- the update core ------------------------------------------------------
    def init_slot(self, p: torch.Tensor):
        """A fresh slot for parameter p (None when stateless)."""
        return None

    def apply(self, step: int, name: str, p: torch.Tensor, g: torch.Tensor,
              slot):
        """Update p in place from gradient g at `step`; returns the slot
        (updated in place)."""
        raise NotImplementedError

    # -- eager SINGA surface --------------------------------------------------
    @torch.no_grad()
    def update(self, param: torch.Tensor, grad: torch.Tensor) -> None:
        name = param_name(param)
        slot = self._eager_state.get(name)
        if slot is None:
            slot = self.init_slot(param)
        self._eager_state[name] = self.apply(self.step_counter, name, param,
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

    def get_states(self) -> Dict:
        return {"step": self.step_counter}

    def set_states(self, s: Dict) -> None:
        self.step_counter = int(s.get("step", 0))

    def state_signature(self) -> str:
        """Identifies the slot structure this optimizer produces, so a
        restore into a structurally different optimizer is refused."""
        return type(self).__name__

    # -- moment persistence ---------------------------------------------------
    def slot_arrays(self) -> Dict[str, List[torch.Tensor]]:
        """Per-param moment tensors as {name: [tensor, ...]}; empty lists
        for stateless slots."""
        out = {}
        for name, slot in self._eager_state.items():
            if slot is None:
                out[name] = []
            elif isinstance(slot, torch.Tensor):
                out[name] = [slot]
            else:
                out[name] = list(slot)
        return out

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
        t = step + 1
        m.mul_(self.b1).add_(g, alpha=1 - self.b1)
        v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
        upd = (m / (1 - self.b1 ** t)) / (
            torch.sqrt(v / (1 - self.b2 ** t)) + self.eps)
        if self.weight_decay and self.decoupled:
            upd = upd + self.weight_decay * p
        p.sub_(lr * upd)
        return (m, v)


class AdamW(Adam):
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.01):
        super().__init__(lr, betas, eps, weight_decay)
        self.decoupled = True
