"""The Model API and its step executor, ported from ``singa_tpu/model.py``.

The user writes an imperative subclass (``forward``, ``train_one_batch``
calling ``self.optimizer(loss)``), then ``set_optimizer``, ``compile``
and ``train_step``.  The reference traces the step into one jitted XLA
module; here `_StepExecutor` captures it as a CUDA graph on the card,
with the reference's bookkeeping: one executor per (input shapes,
dtypes, tag), made afresh when any of these changes; a separate eval
executor; the optimizer's step counter advanced once per step; the
optimizer's slots kept in its eager store.  ``Model.graph`` and
``get_graph`` return the executor's ``graph.CapturedGraph``, whose
``schedule()`` traces the executor's step on demand (`_StepExecutor.
step_inputs` gives its inputs in order);
``save_states``/``load_states`` go through ``utils.checkpoint``.

With a ``DistOpt`` optimizer and a current ``data`` mesh, a train
executor runs the reference's data-parallel step (its ``shard_map``
path): every rank feeds the same global batch and the step takes rank
r's rows [r·B/W, (r+1)·B/W); DistOpt syncs the gradients; afterwards
float buffers (BatchNorm's running statistics) are mean-allreduced,
scalar outputs (the loss) mean-allreduced and other outputs gathered
back to the global batch.  The executor keeps the mesh it was made
under, so ``set_mesh(None)`` leaves it data-parallel while new
executors run single-process.

Under a mesh with an axis other than the data axis (``model``, ``seq``,
``pipe``, ``expert``), or with ZeRO-1, an executor takes the reference's
multi-axis path (its GSPMD step; ``gspmd`` is True): the model's rules
(``spmd.collect_shard_rules``) cut its parameters to this rank's blocks
(``tensor_parallel.shard_params``, at ``compile`` and here; ``_param_sh``
holds the specs) and a ``pipe`` axis cuts its ``layer.PipelineStack``s
into stages (``pipeline.shard_stages``); each rank takes its block of
the global batch (``spmd.batch_spec``: rows over the data axis, token
ids' positions over ``seq``; the ranks of ``model``, ``pipe`` and
``expert`` see the same batch), DistOpt averages the gradients over the
axes whose ranks hold different data (``opt.replica_axes``), the scalar
outputs are averaged over the same ranks and the others gathered to the
global batch and sequence.  On the card the step, collectives included,
is captured as one CUDA graph.
"""

from __future__ import annotations

import time
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import torch

from . import autograd, faults
from .device import Device, get_default_device
from .graph import CapturedGraph, record
from .graph import epoch as graph_epoch
from .layer import Dropout, Layer
from .obs import attr as obs_attr
from .obs import events as obs_events
from .opt import DistOpt, Optimizer, _leaves, replica_axes
from .parallel import communicator as comm
from .parallel import mesh as mesh_mod
from .parallel import pipeline
from .parallel import spmd
from .parallel import tensor_parallel as tp
from .parallel.distributed import local_batch

__all__ = ["Model", "Module", "model_device"]


class Model(Layer):
    """Base model (reference surface: forward / train_one_batch / loss /
    optimizer / compile / train_step)."""

    def __init__(self, name: Optional[str] = None,
                 device: Optional[Device] = None):
        super().__init__(name, device)
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
        mesh = mesh_mod.current_mesh()
        if _multi_axis(mesh, self.optimizer):
            tp.shard_params(self, spmd.collect_shard_rules(self), mesh)
            pipeline.shard_stages(self, mesh)

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
        mode).  Each call is a ``model.train_step`` span (obs.events;
        host wall clock)."""
        self.train(True)
        with obs_events.span("model.train_step", model=self.name,
                             step=self._step_count,
                             compiled=self.graph_mode):
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


def _data_axis(opt) -> str:
    return opt.data_axis if isinstance(opt, DistOpt) else mesh_mod.DATA_AXIS


def _multi_axis(mesh, opt) -> bool:
    """The reference's GSPMD condition: a mesh with an axis other than
    the data axis (of any size: at a world of 1 the model and seq forms
    run over groups of one), or ZeRO-1."""
    if mesh is None:
        return False
    extra = [a for a in mesh.shape if a != _data_axis(opt)]
    zero1 = (isinstance(opt, DistOpt)
             and spmd.zero1_axis_for(opt, mesh) is not None)
    return bool(extra) or zero1


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
    parameters, slots and buffers such as BatchNorm's running
    statistics (updated in place, and read by address by an eval
    step), the dropout generators (registered with the graph).  Outputs
    are cloned out of the graph's pool, so a result held from one step
    is not overwritten by the next.  A capture that fails raises;
    nothing falls back to eager.  On the CPU device every call runs the
    body eagerly.

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
        self._batch_spec = None
        self._static_in = None
        self._static_out = None
        self.slots: Dict = {}
        mesh = mesh_mod.current_mesh()
        self.data_axis = _data_axis(model.optimizer)
        # the multi-axis step (the reference's GSPMD path), else the
        # data-parallel step: DistOpt under a mesh with its axis
        self.gspmd = _multi_axis(mesh, model.optimizer)
        dp = (isinstance(self.opt, DistOpt) and mesh is not None
              and self.data_axis in mesh.shape)
        self.mesh = mesh if self.gspmd or dp else None
        self._rules = None
        self._seq_cut = False
        with self._mesh_scope():
            if self.gspmd:
                self._build_gspmd(mesh)
                self.axis = replica_axes(mesh) or None
                self.dist = mesh.bound
            else:
                self.axis = self.data_axis if self.mesh is not None else None
                self.dist = self.axis is not None and comm.axis_bound(
                    self.axis)
            self._init_slots()

    def _build_gspmd(self, mesh) -> None:
        """Cut the parameters by the model's rules and keep their specs
        (``_param_sh``, as the reference's executor exposes them)."""
        if isinstance(self.opt, DistOpt) and (
                self.opt.compress_dtype is not None or self.opt.topk_ratio
                or self.opt.compression is not None):
            warnings.warn(
                "DistOpt compressed/sparsified allreduce applies only on "
                "1-D data-parallel meshes; on a multi-axis mesh the "
                "gradients are averaged in f32 and these options are "
                "ignored", stacklevel=3)
        replicas = [a for a in mesh.axis_names if a != mesh_mod.MODEL_AXIS
                    and mesh.shape[a] > 1]
        if self.is_train and replicas and not isinstance(self.opt, DistOpt):
            raise ValueError(
                f"training under {mesh!r} needs opt.DistOpt: the ranks of "
                f"{replicas} hold different data or parts of the model "
                f"and only DistOpt syncs their gradients")
        self._rules = spmd.collect_shard_rules(self.model)
        specs = tp.shard_params(self.model, self._rules, mesh)
        pipeline.shard_stages(self.model, mesh)
        self._param_sh = {n: mesh_mod.NamedSharding(mesh, sp)
                          for n, sp in specs.items()}
        self.param_tensors = dict(self.model.get_params())

    @contextmanager
    def _mesh_scope(self):
        """The mesh this executor was made under is current while it
        runs (None for a single-process executor), with, on the
        multi-axis path, its data axis and the model's rules
        installed."""
        saved = mesh_mod.current_mesh()
        saved_axis = mesh_mod.current_data_axis()
        saved_rules = spmd.current_trace_rules()
        saved_cut = spmd.current_token_cut()
        mesh_mod.set_mesh(self.mesh)
        try:
            if self.gspmd:
                if self.data_axis in self.mesh.shape:
                    mesh_mod.set_data_axis(self.data_axis)
                spmd.set_trace_rules(self._rules)
                spmd.set_token_cut(self._token_cut())
            yield
        finally:
            mesh_mod.set_mesh(saved)
            mesh_mod._data_axis = saved_axis
            spmd.set_trace_rules(saved_rules)
            spmd.set_token_cut(saved_cut)

    def _token_cut(self):
        """((dim, axis), ...): the axes that cut this step's token batch
        (rows over the data axis, positions over ``seq``) on a bound
        multi-axis mesh."""
        if not getattr(self, "dist", False):
            return ()
        cut = []
        if self.mesh.shape.get(self.data_axis, 1) > 1:
            cut.append((0, self.data_axis))
        if self._seq_cut:
            cut.append((1, mesh_mod.SEQ_AXIS))
        return cut

    def _init_slots(self) -> None:
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
            with self._mesh_scope(), torch.set_grad_enabled(self.is_train):
                outs = _detach(self.body(batch))
                if self.dist:
                    outs = self._sync_after(outs)
                return outs
        finally:
            autograd.set_training(saved_training)

    @torch.no_grad()
    def _sync_after(self, outs):
        """Mean-allreduce the float buffers, then replicate the outputs:
        scalars mean-allreduced, the rest gathered to the global batch
        (over the data axis; on the multi-axis path also their positions
        over ``seq``).  `self.axis`: the ranks that hold different data
        (the multi-axis path: ``opt.replica_axes``)."""
        if self.axis is None:
            return outs
        for b in self.model._get_buffers().values():
            if b.is_floating_point():
                b.copy_(comm.allreduce(b, self.axis, "mean"))
        seq = self.gspmd and self._seq_cut

        def out(t):
            if t.ndim == 0:
                return comm.allreduce(t, self.axis, "mean")
            if self.data_axis in self.mesh.shape:
                t = comm.gather_batch(t, self.data_axis)
            if seq and t.ndim >= 2:
                t = comm.gather_batch(t, mesh_mod.SEQ_AXIS, dim=1)
            return t
        return _map_tensors(out, outs)

    def __call__(self, batch):
        m, opt = self.model, self.opt
        step_host = opt.step_counter if opt is not None else m._step_count
        name = f"{m.name}.{self.tag}"
        # "device.execute" injection site: error/hang fire on the host
        # before anything of the step runs (the static buffers are
        # intact, so the caller may retry this same step); nan corrupts
        # the step's outputs after a clean run
        faults.fire("device.execute", graph=name, step=step_host)
        # a replay returns before the card has run it: a ledger times
        # the step with the device synchronised around it, and only a
        # ledger does (no ledger, no sync)
        led = obs_attr.get()
        if led is not None:
            _sync(self.device)
            t0 = time.perf_counter()
        if self.dist:
            with self._mesh_scope():
                local = tuple(local_batch(t, data_axis=self.data_axis)
                              for t in batch)
            # a block of the sequence: outputs gather their positions
            self._seq_cut = any(a.ndim == 2 and b.shape[1] != a.shape[1]
                                for a, b in zip(local, batch))
            batch = local
        with obs_events.span("graph.execute", graph=name, step=step_host):
            outs = self._dispatch(batch, name)
        if led is not None:
            _sync(self.device)
            led.note("train_step" if self.is_train else f"{self.tag}_step",
                     time.perf_counter() - t0)
        outs = faults.corrupt("device.execute", outs)
        self.calls += 1
        m._step_count += 1
        if opt is not None:
            opt.step_counter = step_host + 1
            if isinstance(opt, DistOpt):
                opt.opt.step_counter = step_host + 1
            self.slots = dict(opt._eager_state)
        return outs

    def _dispatch(self, batch, name):
        if self.is_train and not (self.device.type == "cuda"
                                  and self.calls > 2):
            # the last step's gradients (``param.grad``) go before the
            # body makes new ones, and before a capture empties the
            # cache: a step would otherwise hold two gradient sets at its
            # peak.  A replay allocates nothing and keeps its pool's.
            for p in self.param_tensors.values():
                p.grad = None
        if self.calls == 0:
            outs, self.captured = record(name, lambda: self._run(batch))
            self._batch_spec = [(t.shape, t.dtype, t.device) for t in batch]
            self.captured.fx_thunk = self._trace
        elif self.device.type != "cuda":
            outs = self._run(batch)
        elif self.calls == 1:
            outs = self._warm_up(batch)
        elif self.calls == 2:
            with obs_events.span("graph.compile", graph=name):
                outs = self._capture(batch)
        else:
            for s, t in zip(self._static_in, batch):
                s.copy_(t)
            self.captured.replay()
            outs = _clone(self._static_out)
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
        gens = _dropout_generators(self.model) if self.is_train else ()
        # NCCL's watchdog thread queries events while the step is
        # captured: a global capture mode would forbid that
        self._static_out = self.captured.capture(
            lambda: self._run(self._static_in), self._stream, gens,
            error_mode="thread_local" if self.dist else "global")
        self.captured.replay()
        return _clone(self._static_out)

    # -- the traced step (CapturedGraph.schedule) ---------------------------
    def _state(self):
        """(names, tensors) of what the step reads and updates besides
        its batch: the parameters, the buffers, the optimizer's slot
        leaves (``opt._leaves`` order) and its step tensor."""
        names = [f"param:{n}" for n in self.param_tensors]
        tensors = list(self.param_tensors.values())
        for n, b in self.model._get_buffers().items():
            names.append(f"buffer:{n}")
            tensors.append(b)
        if self.opt is not None:
            for n in self.param_tensors:
                leaves = _leaves(self.slots.get(n))
                names += [f"slot:{n}:{i}" for i in range(len(leaves))]
                tensors += leaves
            names.append("step")
            tensors.append(self.opt.step_tensor(self.device))
        return names, tensors

    def step_inputs(self, batch) -> List[torch.Tensor]:
        """The inputs of this step's traced graph, in its order: copies
        of the state (`_state`) as it is now, then the batch."""
        return [t.detach().clone() for t in self._state()[1]] + list(batch)

    def _trace(self):
        """The step's SSA graph (`graph.trace`) over fake tensors of its
        inputs (`step_inputs` order): nothing runs, nothing of the model
        changes.  Its outputs: the step's, then the updated parameters,
        buffers, slot leaves and step."""
        if self.mesh is not None:
            raise NotImplementedError("schedule() traces a single-process "
                                      "step")
        from torch._subclasses.fake_tensor import FakeTensorMode
        from .graph import trace
        fake = FakeTensorMode()
        ins = [fake.from_tensor(t) for t in self._state()[1]]
        with fake:
            ins += [torch.empty(shape, dtype=dt, device=dev)
                    for shape, dt, dev in self._batch_spec]
        return trace(self._functional_step, *ins)

    def _functional_step(self, *flat):
        """One step over `flat` (`step_inputs` order) in place of the
        model's state, the optimizer's store swapped for the given slots
        and step while it runs."""
        from torch.nn.utils.stateless import _reparametrize_module
        pnames = list(self.param_tensors)
        bnames = list(self.model._get_buffers())
        it = iter(flat)
        params = [next(it) for _ in pnames]
        bufs = [next(it) for _ in bnames]
        for n, p in zip(pnames, params):
            p.param_name = n
        swap = {**dict(zip(pnames, params)), **dict(zip(bnames, bufs))}
        o = self.opt
        if o is None:
            with _reparametrize_module(self.model, swap):
                return self._run(tuple(it)), params, bufs
        saved = o._eager_state, o._step_dev, o.step_counter
        o._eager_state = {n: _rebuild(self.slots.get(n), it) for n in pnames}
        step = o._step_dev = next(it)
        try:
            with _reparametrize_module(self.model, swap):
                outs = self._run(tuple(it))
            slots = [t for n in pnames for t in _leaves(o._eager_state[n])]
        finally:
            o._eager_state, o._step_dev, o.step_counter = saved
        return outs, params, bufs, slots, step


def _rebuild(template, leaves):
    """A slot of `template`'s structure over the next tensors of
    `leaves` (``opt._leaves`` order)."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    return tuple(_rebuild(t, leaves) for t in template)


def _dropout_generators(model) -> tuple:
    """The generators a training step draws dropout masks from: a
    captured step registers them, so each replay draws new masks."""
    gens = {id(m.generator): m.generator for m in model.modules()
            if isinstance(m, Dropout) and m.p > 0}
    return tuple(gens.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _map_tensors(fn, outs):
    if isinstance(outs, torch.Tensor):
        return fn(outs)
    if isinstance(outs, (tuple, list)):
        return type(outs)(_map_tensors(fn, o) for o in outs)
    return outs


def _detach(outs):
    return _map_tensors(torch.Tensor.detach, outs)


def _clone(outs):
    return _map_tensors(torch.Tensor.clone, outs)


def model_device(model) -> Device:
    """The port ``Device`` a model's parameters live on."""
    dev = getattr(model, "device", None)
    if isinstance(dev, Device):
        return dev
    return get_default_device()
