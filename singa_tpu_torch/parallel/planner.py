"""Shape-only memory planner, ported from ``singa_tpu/parallel/planner.py``.

Nothing is allocated: the model is made on torch's ``meta`` device
(`abstract_init`), its optimizer slots too, and each parameter's block
on a target mesh comes from the model's SHARD_RULES as the port cuts it
(``tensor_parallel`` with its head units, ``pipeline.shard_stages``).
The result reports per-device parameter, optimizer and gradient bytes,
so "does this model fit a card under this mesh?" is answered before
any card is touched.

Differences from the reference, stated:
  * the mesh is a shape (``Mesh({...})`` or a dict), larger than any
    process group, as the reference plans for virtual devices;
  * a projection whose cut would split a head stays whole, as
    ``tensor_parallel`` keeps it (the reference's GSPMD may cut it);
  * under a ``pipe`` axis equal to a ``layer.PipelineStack``'s stages
    a rank holds one stage's blocks, so the plan counts one stage
    (the reference counts every block on every rank);
  * ZeRO-1 shards every flattened parameter block over the data axis,
    as ``opt.DistOpt`` does (the reference shards only replicated slots
    whose first dim divides);
  * ``lower=True`` runs the step's forward, backward and update once on
    meta tensors at a world of 1 (no mesh: whole shapes, no collectives)
    and keeps its record (``graph.CapturedGraph``: aten ops and FLOPs),
    where the reference lowers the sharded step with ``jit.lower``;
  * `HBM_BYTES` holds the cards the port runs on, not TPU generations;
  * the reference's ``_reset_lazy`` (re-arming lazy init after its plan
    consumed the model) has no counterpart: the port plans a twin and
    never touches the model.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Dict, Union

import torch

from ..device import Device
from . import spmd
from .mesh import PIPE_AXIS, Mesh, NamedSharding

__all__ = ["abstract_init", "plan_train_step", "MemoryPlan", "HBM_BYTES"]

# device memory of each card: the H100 SXM's is what
# torch.cuda.get_device_properties(0).total_memory reads on an "NVIDIA
# H100 80GB HBM3" (chip_smoke.py phase pipe prints it); the H200's is its
# published 141 GB, not measured here
HBM_BYTES = {
    "h100": 85_017_493_504,
    "h200": 141_000_000_000,
}


class _MetaDevice(Device):
    """A port device whose tensors live on ``meta``: shapes and dtypes,
    no storage.  Activations take `default_dtype` (the card's bf16)."""

    def __init__(self, default_dtype=torch.bfloat16):
        self.name = "meta"
        self.torch_device = torch.device("meta")
        self.default_dtype = default_dtype
        # init draws a value from a generator; on meta none is kept
        self.generator = torch.Generator()


def abstract_init(model, example=None):
    """The model's parameters as shapes: a twin of `model` on the meta
    device (its parameters and buffers replaced, nothing copied; the
    model itself is untouched and stays usable), or, for a builder
    ``build(device) -> model``, the model built there.  `example` is
    accepted for the reference's signature: the port's layers know
    their widths at construction."""
    del example
    dev = _MetaDevice()
    if not isinstance(model, torch.nn.Module):
        return model(dev)
    memo = {}
    for t in list(model.parameters()) + list(model.buffers()):
        meta = torch.empty_like(t, device="meta")
        memo[id(t)] = torch.nn.Parameter(meta, t.requires_grad) \
            if isinstance(t, torch.nn.Parameter) else meta
    for mod in model.modules():
        for v in vars(mod).values():
            if isinstance(v, Device):
                memo[id(v)] = dev
            elif isinstance(v, torch.Generator):
                memo[id(v)] = dev.generator
    saved = {k: getattr(model, k) for k in ("optimizer", "_executors")
             if hasattr(model, k)}
    for k in saved:
        memo[id(saved[k])] = None if k == "optimizer" else {}
    return copy.deepcopy(model, memo)


@dataclass
class MemoryPlan:
    """Per-device memory accounting for one train step.

    Gradient accounting: `grad_bytes_per_device` is the BACKWARD PEAK —
    one full gradient set at the params' shardings (gradients
    materialize at param shardings before the update consumes them,
    ZeRO-1 or not).  Under ZeRO-1 (`DistOpt(shard_weight_update=True)`)
    the update itself only holds the reduce-scattered 1/W shard —
    reported separately as `grad_bytes_update_per_device` — and the
    durable saving shows up in `slot_bytes_per_device`, whose moments
    are sharded over the data axis.  A GradAccum wrapper's f32
    accumulator is part of the optimizer state (its slots), so it is
    counted in `slot_bytes_per_device`, not here.
    """

    mesh_shape: Dict[str, int]
    param_bytes_global: int
    param_bytes_per_device: int
    slot_bytes_per_device: int
    grad_bytes_per_device: int
    # gradient residency during the (possibly ZeRO-1-sharded) update
    grad_bytes_update_per_device: int = 0
    per_device_state_bytes: int = field(init=False)
    lowered: object = None

    def __post_init__(self):
        if not self.grad_bytes_update_per_device:
            self.grad_bytes_update_per_device = self.grad_bytes_per_device
        self.per_device_state_bytes = (self.param_bytes_per_device
                                       + self.slot_bytes_per_device
                                       + self.grad_bytes_per_device)

    def fits(self, chip: str = "h100", headroom: float = 0.75) -> bool:
        """True when params + moments + one peak gradient set leave
        `1-headroom` of the card's memory for activations/workspace."""
        return self.per_device_state_bytes <= HBM_BYTES[chip] * headroom


def _sharded_bytes(shape, dtype, sharding: NamedSharding) -> int:
    """Exact per-device bytes of an array under a NamedSharding."""
    mesh = sharding.mesh
    elems = math.prod(shape) if shape else 1
    denom = 1
    for ax in sharding.spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            denom *= mesh.shape[a]
    return math.ceil(elems / denom) * torch.empty((), dtype=dtype,
                                                  device="meta").element_size()


def _leaves(slot):
    if slot is None:
        return []
    if isinstance(slot, torch.Tensor):
        return [slot]
    if isinstance(slot, dict):
        return [t for k in sorted(slot) for t in _leaves(slot[k])]
    return [t for v in slot for t in _leaves(v)]


def _other_stages(model, mesh) -> set:
    """Ids of the block parameters that rank 0 of `mesh`'s pipe axis
    would not hold (see ``pipeline.shard_stages``)."""
    from ..layer import PipelineStack
    S = mesh.shape.get(PIPE_AXIS, 1)
    out = set()
    if S < 2:
        return out
    for mod in model.modules():
        if isinstance(mod, PipelineStack) and mod.stages == S \
                and mod._structural_blocker() is None:
            k = len(mod) // S
            for blk in list(mod)[k:]:
                out.update(id(p) for p in blk.parameters())
    return out


def plan_train_step(model, optimizer, batch_shapes,
                    mesh: Union[Mesh, Dict[str, int], None] = None,
                    lower: bool = True) -> MemoryPlan:
    """Plan `model` (or a builder ``build(device)``) under `optimizer` on
    `mesh` (a shape; default the current mesh), without allocating:
    per-device bytes of parameters, optimizer slots and gradients.
    `batch_shapes`: the train step's inputs, as shapes with dtypes
    (``(torch.Size, dtype)`` pairs, or tensors, meta ones included).
    With `lower`, also the step run once on meta tensors (see the module
    docstring): the plan's ``lowered``."""
    from . import mesh as mesh_mod
    from . import tensor_parallel as tp
    from ..opt import DistOpt

    mesh = mesh if mesh is not None else mesh_mod.current_mesh()
    if mesh is None:
        raise ValueError("plan_train_step needs a mesh")
    if isinstance(mesh, dict):
        mesh = Mesh(mesh)
    twin = abstract_init(model)
    params = twin.get_params()
    rules = spmd.collect_shard_rules(twin)
    units = tp._units(twin)
    specs = {n: tp._prune(spmd.spec_for(n, tuple(p.shape), rules, mesh),
                          tuple(p.shape), units.get(n), mesh)
             for n, p in params.items()}
    elsewhere = _other_stages(twin, mesh)
    live = {n: p for n, p in params.items() if id(p) not in elsewhere}

    def local(n, p):
        return _sharded_bytes(tuple(p.shape), p.dtype,
                              NamedSharding(mesh, specs[n]))
    pb_global = sum(p.numel() * p.element_size() for p in params.values())
    pb_dev = sum(local(n, p) for n, p in live.items())

    zero1_ax = spmd.zero1_axis_for(optimizer, mesh)
    W = mesh.shape.get(zero1_ax, 1) if zero1_ax else 1
    base = optimizer.opt if isinstance(optimizer, DistOpt) else optimizer
    sb_dev = gb_upd = 0
    for n, p in live.items():
        block = torch.empty(tuple(s // _cut(specs[n], i, mesh)
                                  for i, s in enumerate(p.shape)),
                            dtype=p.dtype, device="meta")
        if zero1_ax:
            shard = torch.empty((math.ceil(block.numel() / W),),
                                dtype=p.dtype, device="meta")
            slot = base.init_slot(shard)
            gb_upd += shard.numel() * shard.element_size()
        else:
            slot = base.init_slot(block)
        sb_dev += sum(t.numel() * t.element_size() for t in _leaves(slot))

    lowered = None
    if lower:
        lowered = _lower(twin, optimizer, batch_shapes)
    return MemoryPlan(mesh_shape=dict(mesh.shape),
                      param_bytes_global=pb_global,
                      param_bytes_per_device=pb_dev,
                      slot_bytes_per_device=sb_dev,
                      grad_bytes_per_device=pb_dev,
                      grad_bytes_update_per_device=gb_upd if zero1_ax
                      else 0,
                      lowered=lowered)


def _cut(spec, i: int, mesh) -> int:
    ax = spec[i] if i < len(spec) else None
    return 1 if ax is None else mesh.shape[ax]


def _fresh(optimizer):
    """A shallow copy of `optimizer` (and of the one a wrapper holds)
    with no slots and no step tensor: the plan's step leaves the
    caller's optimizer as it was."""
    from ..opt import Optimizer
    opt = copy.copy(optimizer)
    opt._eager_state = {}
    opt._step_dev = None
    if isinstance(getattr(opt, "opt", None), Optimizer):
        opt.opt = _fresh(opt.opt)
    return opt


def _lower(twin, optimizer, batch_shapes):
    """The twin's train step once on meta tensors: forward, backward and
    the optimizer's update, with no mesh (a world of 1), recorded by
    ``graph.record``."""
    from .. import autograd
    from ..graph import record
    from . import mesh as mesh_mod

    batch = tuple(b if isinstance(b, torch.Tensor) else
                  torch.empty(tuple(b[0]), dtype=b[1], device="meta")
                  for b in batch_shapes)
    batch = tuple(b.to("meta") for b in batch)
    opt = _fresh(optimizer)
    saved_mesh, saved_train = mesh_mod.current_mesh(), autograd.is_training()
    mesh_mod.set_mesh(None)
    autograd.set_training(True)
    twin.set_optimizer(opt)
    try:
        with torch.enable_grad():
            _, captured = record("plan", lambda: twin.train_one_batch(*batch))
    finally:
        mesh_mod.set_mesh(saved_mesh)
        autograd.set_training(saved_train)
    return captured
