"""The Model API and its step executor, ported from ``singa_tpu/model.py``.

The user writes an imperative subclass (``forward``, ``train_one_batch``
calling ``self.optimizer(loss)``), then ``set_optimizer``, ``compile``
and ``train_step``.  The reference traces the step into one jitted XLA
module; here `_StepExecutor` captures it as a CUDA graph on the card,
with the reference's bookkeeping: one executor per (input shapes,
dtypes, tag), made afresh when any of these changes; a separate eval
executor; the optimizer's step counter advanced once per step; the
optimizer's slots kept in its eager store.  ``Model.graph`` and
``get_graph`` return the executor's ``graph.CapturedGraph``;
``save_states``/``load_states`` go through ``utils.checkpoint``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from . import autograd
from .device import Device, get_default_device
from .graph import CapturedGraph, record
from .graph import epoch as graph_epoch
from .layer import Layer
from .opt import Optimizer

__all__ = ["Model", "Module", "model_device"]


class Model(Layer):
    """Base model (reference surface: forward / train_one_batch / loss /
    optimizer / compile / train_step)."""

    def __init__(self, device: Optional[Device] = None):
        super().__init__(device)
        self.optimizer: Optional[Optimizer] = None
        self.loss_fn: Optional[Callable] = None
        self.graph_mode = False
        self.sequential = False
        self._executors: Dict[Any, "_StepExecutor"] = {}
        self._compiled_init = False
        self._step_count = 0
        self._gen_sessions: Dict[Any, Any] = {}
        self._gen_params: Dict[Any, Any] = {}

    # -- reference API --------------------------------------------------------
    def set_optimizer(self, opt: Optimizer) -> None:
        self.optimizer = opt

    def set_loss(self, fn) -> None:
        self.loss_fn = fn

    def loss(self, out, ty):
        if self.loss_fn is not None:
            return self.loss_fn(out, ty)
        return autograd.softmax_cross_entropy(out, ty)

    def train(self, mode: bool = True) -> "Model":
        """nn.Module's train flag and the reference's global one."""
        super().train(mode)
        autograd.set_training(mode)
        return self

    def eval(self) -> "Model":
        return self.train(False)

    def compile(self, inputs: List, is_train: bool = True,
                use_graph: bool = True, sequential: bool = False) -> None:
        """Arm graph mode.  The port builds parameters at construction,
        so where the reference materialises them from `inputs`, this
        checks that they exist on the model's device.  `sequential` is
        accepted for reference compatibility."""
        dev = self.device.torch_device
        params = self.get_params()
        if not params:
            raise ValueError(f"{type(self).__name__} has no parameters to "
                             f"compile")
        off = [n for n, p in params.items() if p.device.type != dev.type]
        if off:
            raise ValueError(f"parameters not on {dev}: {off[:4]}")
        self.graph_mode = use_graph
        self.sequential = sequential
        self.train(is_train)
        self._compiled_init = True
        self._executors.clear()

    def train_one_batch(self, x, y, *args):
        """Default train step; override for custom behavior."""
        if self.optimizer is None:
            raise RuntimeError(
                "no optimizer: call model.set_optimizer(...) before training")
        out = self.forward(x)
        ls = self.loss(out, y)
        self.optimizer.backward_and_update(ls)
        return out, ls

    # -- execution entry points ----------------------------------------------
    def __call__(self, *xs):
        if self.graph_mode and self._compiled_init and \
                not autograd.is_training():
            return self._run_graph("eval", self._eval_body, xs)
        return super().__call__(*xs)

    def train_step(self, *batch):
        """Run train_one_batch (through the step executor in graph
        mode)."""
        self.train(True)
        if self.graph_mode:
            return self._run_graph("train", self._train_body, batch)
        out = self.train_one_batch(*batch)
        self._step_count += 1
        return out

    def _train_body(self, batch):
        return self.train_one_batch(*batch)

    def _eval_body(self, batch):
        return self.forward(*batch)

    @property
    def graph(self) -> Optional[CapturedGraph]:
        """The most recently made executor's step graph."""
        return self.get_graph()

    def get_graph(self, tag: Optional[str] = None) -> Optional[CapturedGraph]:
        """A step graph, optionally of one kind of step ('train' |
        'eval'): a model that ran both has one of each."""
        for ex in reversed(list(self._executors.values())):
            if ex.captured is not None and ex.epoch == graph_epoch() \
                    and (tag is None or ex.tag == tag):
                return ex.captured
        return None

    # -- state I/O ------------------------------------------------------------
    def save_states(self, fpath: str, aux_states: Optional[Dict] = None) -> None:
        from .utils import checkpoint
        checkpoint.save_states(self, fpath, aux_states)

    def load_states(self, fpath: str) -> Dict:
        from .utils import checkpoint
        return checkpoint.load_states(self, fpath)

    def _run_graph(self, tag: str, body, batch):
        dev = self.device.torch_device
        tensors = tuple(torch.as_tensor(b, device=dev) for b in batch)
        key = tuple((tuple(t.shape), t.dtype) for t in tensors) + (tag,)
        if any(e.epoch != graph_epoch() for e in self._executors.values()):
            self._executors.clear()          # reset_graph() made them stale
        ex = self._executors.get(key)
        if ex is None:
            ex = _StepExecutor(self, tag, body)
            self._executors[key] = ex
        return ex(tensors)


# the reference exposes the same class as Module in places
Module = Model


def _slot_compatible(restored, fresh) -> bool:
    """True when a restored slot has the same structure and shapes as a
    freshly made one."""
    if fresh is None:
        return restored is None
    if isinstance(fresh, torch.Tensor):
        return (isinstance(restored, torch.Tensor)
                and restored.shape == fresh.shape)
    if isinstance(fresh, dict):
        return (isinstance(restored, dict) and restored.keys() == fresh.keys()
                and all(_slot_compatible(restored[k], fresh[k])
                        for k in fresh))
    return (isinstance(restored, tuple) and len(restored) == len(fresh)
            and all(_slot_compatible(r, f) for r, f in zip(restored, fresh)))


class _StepExecutor:
    """Runs one kind of step ('train' or 'eval') of a model at one set
    of input shapes and dtypes.

    On a CUDA device the step is captured as a CUDA graph: the first
    call runs the body eagerly and records its ops (`graph.record`), the
    second runs it eagerly on a side stream (the warm-up capture needs),
    the third captures it over static copies of the inputs and replays
    it once (capture runs nothing), and every later call copies its
    inputs into the static ones and replays.  Each call makes exactly
    one real step.  What a step reads that changes between steps is on
    the device: the batch (static inputs), the optimizer's step
    (`Optimizer.step_tensor`, advanced inside the graph), the
    parameters and slots (updated in place).  Outputs are cloned out of
    the graph's pool, so a result held from one step is not overwritten
    by the next.  A capture that fails raises; nothing falls back to
    eager.  On the CPU device every call runs the body eagerly.

    A train executor owns the optimizer's slots: at construction it
    makes a fresh slot for each parameter, or takes one restored into
    the optimizer's eager store when it fits (refusing one that does
    not), and after each step it mirrors the store and advances the
    optimizer's step counter once."""

    def __init__(self, model: Model, tag: str, body):
        self.model = model
        self.tag = tag
        self.body = body
        self.is_train = tag == "train"
        self.param_tensors = dict(model.get_params())
        self.opt = model.optimizer if self.is_train else None
        self.device = model.device.torch_device
        self.epoch = graph_epoch()
        self.calls = 0
        self.captured: Optional[CapturedGraph] = None
        self._stream = None
        self._static_in = None
        self._static_out = None
        self.slots: Dict = {}
        if self.opt is not None:
            est = self.opt._eager_state
            with torch.no_grad():
                for n, p in self.param_tensors.items():
                    fresh = self.opt.init_slot(p)
                    if n in est:
                        if not _slot_compatible(est[n], fresh):
                            raise ValueError(
                                f"restored optimizer state for {n!r} does "
                                f"not fit this optimizer/model (structure "
                                f"or shape mismatch) — refusing to "
                                f"silently reinitialize moments")
                        fresh = est[n]
                    self.slots[n] = fresh
            self.opt._eager_state = dict(self.slots)

    def _run(self, batch):
        saved_training = autograd.is_training()
        autograd.set_training(self.is_train)
        try:
            with torch.set_grad_enabled(self.is_train):
                return _detach(self.body(batch))
        finally:
            autograd.set_training(saved_training)

    def __call__(self, batch):
        m, opt = self.model, self.opt
        step_host = opt.step_counter if opt is not None else m._step_count
        if self.calls == 0:
            outs, self.captured = record(self.tag, lambda: self._run(batch))
        elif self.device.type != "cuda":
            outs = self._run(batch)
        elif self.calls == 1:
            outs = self._warm_up(batch)
        elif self.calls == 2:
            outs = self._capture(batch)
        else:
            for s, t in zip(self._static_in, batch):
                s.copy_(t)
            self.captured.replay()
            outs = _clone(self._static_out)
        self.calls += 1
        m._step_count += 1
        if opt is not None:
            opt.step_counter = step_host + 1
            self.slots = dict(opt._eager_state)
        return outs

    def _warm_up(self, batch):
        self._stream = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            outs = self._run(batch)
        current.wait_stream(self._stream)
        return outs

    def _capture(self, batch):
        self._static_in = tuple(t.clone() for t in batch)
        self._static_out = self.captured.capture(
            lambda: self._run(self._static_in), self._stream)
        self.captured.replay()
        return _clone(self._static_out)


def _detach(outs):
    if isinstance(outs, torch.Tensor):
        return outs.detach()
    if isinstance(outs, (tuple, list)):
        return type(outs)(_detach(o) for o in outs)
    return outs


def _clone(outs):
    if isinstance(outs, torch.Tensor):
        return outs.clone()
    if isinstance(outs, (tuple, list)):
        return type(outs)(_clone(o) for o in outs)
    return outs


def model_device(model) -> Device:
    """The port ``Device`` a model's parameters live on."""
    dev = getattr(model, "device", None)
    if isinstance(dev, Device):
        return dev
    return get_default_device()
