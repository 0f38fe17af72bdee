"""The device mesh, ported from ``singa_tpu/parallel/mesh.py``.

The reference names its parallelism by the axes of a
``jax.sharding.Mesh`` over PJRT devices.  Here one process drives one
device and the devices of a mesh are the ranks of the default
``torch.distributed`` process group: NCCL between cards, gloo on the
CPU.  A `Mesh` is the small object the rest of the port reads: its
axis names and sizes (``.shape``, as the reference's ``Mesh.shape``),
over that group.

Only a 1-D ``data`` axis exists in the port: DistOpt's data-parallel
step, with its gradient sync written as explicit collectives.  Tensor,
sequence, expert and pipeline axes (the reference's GSPMD path) come
with the next distribution slice, and asking for one raises
``NotImplementedError`` rather than treating it as data.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "set_mesh", "current_mesh",
           "data_parallel_mesh", "mesh_shape", "process_index",
           "process_count", "local_devices", "set_data_axis",
           "current_data_axis", "DATA_AXIS"]

#: the one axis the port's meshes have
DATA_AXIS = "data"

_current_mesh: Optional["Mesh"] = None
_data_axis: str = DATA_AXIS


class Mesh:
    """Axis names to sizes over the ranks of the default process group
    (rank r is the r-th device of the ``data`` axis)."""

    def __init__(self, axes: Dict[str, int]):
        self.shape: Dict[str, int] = dict(axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _check_axes(axes: Dict[str, int]) -> None:
    other = [a for a in axes if a != DATA_AXIS]
    if other:
        raise NotImplementedError(
            f"mesh axes {other}: the port has only the 1-D data-parallel "
            f"mesh ({DATA_AXIS!r}); tensor, sequence, expert and pipeline "
            f"axes come with the next distribution slice (the reference's "
            f"GSPMD path)")


def make_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """A mesh such as ``make_mesh({'data': 4})``.  `devices` defaults to
    the group's ranks; the data axis must span all of them (a subgroup
    mesh is not supported)."""
    _check_axes(axes)
    world = process_count() if devices is None else len(list(devices))
    n = int(axes.get(DATA_AXIS, 1))
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if n != world:
        raise ValueError(
            f"a data mesh of {n} over a group of {world} ranks: the port's "
            f"mesh spans the whole default process group")
    return Mesh({DATA_AXIS: n})


def data_parallel_mesh(n: Optional[int] = None) -> Mesh:
    """The 1-D data mesh over the group's world (1 without a group)."""
    return make_mesh({DATA_AXIS: n or process_count()})


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    if mesh is not None:
        _check_axes(mesh.shape)
    _current_mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


def mesh_shape() -> Dict[str, int]:
    m = current_mesh()
    return dict(m.shape) if m is not None else {}


def set_data_axis(name: str) -> None:
    """Install the batch-sharding axis name (kept for the reference's
    surface; the port's only data axis is ``data``)."""
    global _data_axis
    _check_axes({name: 1})
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
