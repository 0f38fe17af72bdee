"""The multi-process bootstrap, ported from
``singa_tpu/parallel/distributed.py``.

One process drives one device.  `init_distributed` joins this process
to the default ``torch.distributed`` process group: NCCL when the
process drives a card (card ``cuda:LOCAL_RANK``), gloo when the caller
asked for the CPU, so the same N-process path runs on a host with no
card (the tests launch N local processes).

Configured from the environment, explicit arguments first:

    SINGA_COORDINATOR   host:port of process 0   (else MASTER_ADDR:MASTER_PORT)
    SINGA_NUM_PROCS     world size               (else WORLD_SIZE)
    SINGA_PROC_ID       this process's rank      (else RANK)
    LOCAL_RANK          this process's card      (default: the rank)

so ``torchrun --nproc_per_node=N`` and the reference's ``SINGA_*``
variables both work.  With nothing configured it is the reference's
single-process no-op: it returns 0 and makes no group, so a script may
call it unconditionally.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import device as device_mod
from . import mesh as mesh_mod
from . import spmd

__all__ = ["init_distributed", "finalize_distributed", "is_initialized",
           "global_mesh", "local_batch", "assert_same_across_processes"]

#: how long a collective may wait for the other ranks before it fails
_TIMEOUT_S = 600.0


def _env(*names: str) -> Optional[str]:
    for k in names:
        v = os.environ.get(k)
        if v:
            return v
    return None


def _coordinator() -> Optional[str]:
    c = _env("SINGA_COORDINATOR", "COORDINATOR_ADDRESS")
    if c:
        return c
    addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def _int_env(*names: str) -> Optional[int]:
    v = _env(*names)
    return int(v) if v else None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device=None) -> int:
    """Join the default process group; returns this process's rank.

    Returns the current rank when a group already exists, and 0 (making
    no group) when no coordinator and no world size are configured.
    `device` ('cpu', 'cuda' or a port Device; default: the default
    device, the card unless the caller set the CPU) picks the backend.
    `local_device_ids` names this process's card (default LOCAL_RANK,
    else the rank).  A failed init raises."""
    if dist.is_initialized():
        return dist.get_rank()
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        num_processes = _int_env("SINGA_NUM_PROCS", "NUM_PROCESSES",
                                 "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("SINGA_PROC_ID", "PROCESS_ID", "RANK")
    if coordinator_address is None and num_processes is None:
        return 0                       # single-process mode
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"incomplete distributed configuration: coordinator "
            f"{coordinator_address!r}, world {num_processes}, rank "
            f"{process_id}")
    if isinstance(device, str):
        device = device_mod.create_device(device)
    if device is None:
        device = getattr(device_mod, "_default_device", None)
    on_card = device is None or device.torch_device.type == "cuda"
    kw = {}
    if on_card:
        local = (local_device_ids[0] if local_device_ids
                 else _int_env("LOCAL_RANK"))
        card = torch.device("cuda", process_id if local is None else local)
        torch.cuda.set_device(card)
        if device is None or device.torch_device != card:
            device_mod.set_default_device(
                device_mod.create_device("cuda", card.index))
        kw["device_id"] = card
    dist.init_process_group(
        backend="nccl" if on_card else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=_TIMEOUT_S), **kw)
    return dist.get_rank()


def finalize_distributed() -> None:
    """Leave and destroy the default process group (reference:
    MPI_Finalize), and drop the current mesh, which was over it."""
    if not dist.is_initialized():
        return
    dist.destroy_process_group()
    mesh_mod.set_mesh(None)


def is_initialized() -> bool:
    return dist.is_initialized()


def global_mesh(axes: Dict[str, int]) -> mesh_mod.Mesh:
    """A mesh over every process of the group (`make_mesh`)."""
    return mesh_mod.make_mesh(axes)


def local_batch(global_batch, axis_size: Optional[int] = None,
                data_axis: Optional[str] = None):
    """This process's block of a host-global batch.

    Under a current mesh bound to the process group: the block that
    ``spmd.batch_spec`` gives it, dim 0 over `data_axis` (default the
    installed one) and, for 2-D integer arrays (token ids), dim 1 over
    ``seq``; a dimension that an axis of the mesh does not divide
    raises.  Otherwise (or given `axis_size`): rows [r·B/W, (r+1)·B/W)
    of rank r of W processes."""
    b = global_batch if isinstance(global_batch, torch.Tensor) \
        else np.asarray(global_batch)
    m = mesh_mod.current_mesh()
    if axis_size is not None or m is None or not m.bound:
        n = axis_size or mesh_mod.process_count()
        if b.shape[0] % n:
            raise ValueError(f"batch {b.shape[0]} not divisible by {n} "
                             f"processes")
        per = b.shape[0] // n
        i = mesh_mod.process_index()
        return b[i * per:(i + 1) * per]
    data_axis = data_axis or mesh_mod.current_data_axis()
    cuts = [(0, data_axis)]
    if b.ndim == 2 and spmd._is_integer(b.dtype):
        cuts.append((1, mesh_mod.SEQ_AXIS))
    for dim, axis in cuts:
        if axis not in m.shape:
            continue
        n = m.shape[axis]
        if b.shape[dim] % n:
            raise ValueError(f"batch dimension {dim} of {tuple(b.shape)} "
                             f"not divisible by {n} ranks of axis {axis!r}")
        per = b.shape[dim] // n
        i = m.axis_index(axis)
        b = b[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]
    return b


def assert_same_across_processes(value: float, tol: float = 0.0) -> None:
    """Debug guard: every process must hold the same scalar (the
    replicated loss, say); raises AssertionError otherwise."""
    if mesh_mod.process_count() == 1:
        return
    dev = mesh_mod.local_devices()[0]
    t = torch.tensor([float(value), -float(value)], dtype=torch.float64,
                     device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    mx, mn = float(t[0]), -float(t[1])
    if mx - mn > tol:
        raise AssertionError(
            f"cross-process divergence: max={mx} min={mn}")
