"""The device mesh, ported from ``singa_tpu/parallel/mesh.py``.

The reference names its parallelism by the axes of a
``jax.sharding.Mesh`` over PJRT devices.  Here one process drives one
device and the devices of a mesh are the ranks of the default
``torch.distributed`` process group: NCCL between cards, gloo on the
CPU.  Rank r sits at the row-major coordinates of r in the axes' order,
as the reference's ``np.array(devices).reshape(...)`` places devices.

A `Mesh` is the small object the rest of the port reads: its axis names
and sizes (``.shape``, as the reference's ``Mesh.shape``), each rank's
coordinates, and one ``torch.distributed`` subgroup per line of every
set of axes (a line: the ranks that differ only in those axes), made by
`make_mesh` on every rank in one order.  A set of axes that spans the
whole group uses the default group.

    'data'   — data parallel (DistOpt's gradient sync)
    'model'  — tensor parallel (Megatron layers from the models' SHARD_RULES)
    'seq'    — sequence parallel (ring attention)
    'pipe'   — pipeline stages (``parallel.pipeline``, ``layer.PipelineStack``)
    'expert' — expert parallelism (``layer.MoE``'s experts cut by its rules)

Any other axis name is a data axis only where DistOpt names it
(``data_axis``); `set_data_axis` accepts any axis of the mesh.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "P", "NamedSharding", "named_sharding", "make_mesh",
           "set_mesh", "current_mesh", "data_parallel_mesh", "mesh_shape",
           "process_index", "process_count", "local_devices",
           "set_data_axis", "current_data_axis", "pipeline_mesh", "DATA_AXIS",
           "MODEL_AXIS", "SEQ_AXIS", "PIPE_AXIS", "EXPERT_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

_current_mesh: Optional["Mesh"] = None
_data_axis: str = DATA_AXIS

Axes = Union[str, Sequence[str]]


class P(tuple):
    """A partition spec: one mesh axis (or None) per dimension, as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class NamedSharding:
    """A spec over a mesh (the reference's ``NamedSharding``)."""

    def __init__(self, mesh: "Mesh", spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class Mesh:
    """Axis names to sizes over the ranks of the default process group.

    Built directly (``Mesh({'data': 2, 'model': 4})``) it is a shape for
    the sharding rules and has no groups; `make_mesh` binds it to the
    process group."""

    def __init__(self, axes: Dict[str, int]):
        self.shape: Dict[str, int] = {a: int(n) for a, n in axes.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.devices = np.arange(self.size).reshape(
            tuple(self.shape.values()) or ())
        self.bound = False
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """`axes` as a tuple in the mesh's order; raises on an axis the
        mesh lacks."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        missing = [a for a in names if a not in self.shape]
        if missing:
            raise ValueError(f"{self!r} has no axis {missing}")
        return tuple(a for a in self.axis_names if a in names)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank `rank`'s coordinate on each axis."""
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def axis_index(self, axes: Axes, rank: Optional[int] = None) -> int:
        """The row-major index of `rank` (default: this process) along
        `axes` (one axis or several)."""
        c = self.coords(process_index() if rank is None else rank)
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def line(self, axes: Axes, rank: Optional[int] = None) -> List[int]:
        """The global ranks that share `rank`'s coordinates off `axes`,
        in the order of their index along `axes`."""
        names = self._axes(axes)
        c = self.coords(process_index() if rank is None else rank)
        sel = tuple(slice(None) if a in names else c[a]
                    for a in self.axis_names)
        return [int(r) for r in self.devices[sel].reshape(-1)]

    def group(self, axes: Axes):
        """This process's subgroup over `axes` (None: the default group,
        when the line spans the world)."""
        names = self._axes(axes)
        if not self.bound:
            raise RuntimeError(f"{self!r} is not bound to a process group "
                               f"(make it with make_mesh after "
                               f"init_distributed)")
        return self._groups.get(names)

    def _bind(self) -> None:
        """Make one subgroup per line of every non-empty set of axes, on
        every rank in the same order (``dist.new_group`` is collective
        over the whole group); keep the ones holding this rank."""
        me = dist.get_rank()
        world = dist.get_world_size()
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for sub in itertools.combinations(names, k):
                lines = {tuple(self.line(sub, r)) for r in range(self.size)}
                for ranks in sorted(lines):
                    if len(ranks) == world:
                        self._groups[sub] = None        # the default group
                        continue
                    g = dist.new_group(list(ranks))
                    if me in ranks:
                        self._groups[sub] = g
        self.bound = True


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A mesh such as ``make_mesh({'data': 2, 'model': 2, 'seq': 2})``
    over the default process group (the ranks are its devices; without
    a group, a world of 1).  The axes must span every rank.  With a
    group, every rank must call this, in the same order as the others:
    it makes the mesh's subgroups."""
    world = process_count() if devices is None else len(list(devices))
    mesh = Mesh(axes)
    if mesh.size > world:
        raise ValueError(f"mesh needs {mesh.size} devices, have {world}")
    if mesh.size != world:
        raise ValueError(
            f"a mesh of {mesh.size} over a group of {world} ranks: the "
            f"port's mesh spans the whole default process group")
    if dist.is_initialized():
        mesh._bind()
    return mesh


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """The 1-D data mesh over the group's world (1 without a group)."""
    return make_mesh({DATA_AXIS: n or process_count()})


def pipeline_mesh(n_stages: int, data: int = 1) -> Mesh:
    """``{'data': data, 'pipe': n_stages}`` (the data axis only when
    above 1), over the default process group."""
    axes = {}
    if data > 1:
        axes[DATA_AXIS] = data
    axes[PIPE_AXIS] = n_stages
    return make_mesh(axes)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


def mesh_shape() -> Dict[str, int]:
    m = current_mesh()
    return dict(m.shape) if m is not None else {}


def named_sharding(*spec) -> Optional[NamedSharding]:
    m = current_mesh()
    if m is None:
        return None
    return NamedSharding(m, P(*spec))


def set_data_axis(name: str) -> None:
    """Install the batch-sharding axis name (the executor sets DistOpt's
    ``data_axis`` so that ring attention and the batch cut agree with
    it).  Any axis the current mesh has; with no mesh, any name."""
    global _data_axis
    m = current_mesh()
    if m is not None and name not in m.shape:
        raise ValueError(f"data axis {name!r} is not an axis of {m!r}")
    _data_axis = name


def current_data_axis() -> str:
    return _data_axis


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    """The device this process drives: its card under NCCL, else the
    CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cpu")]
