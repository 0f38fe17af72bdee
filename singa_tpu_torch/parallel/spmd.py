"""ZeRO-1 eligibility, ported from ``singa_tpu/parallel/spmd.py``
(``zero1_axis_for``).

The rest of the reference's module (sharding rules, ``param_shardings``,
``tree_shardings``, the trace-scoped rules) drives its GSPMD path over
multi-axis meshes and comes with the next distribution slice.
"""

from __future__ import annotations

import warnings
from typing import Optional

from .mesh import Mesh

__all__ = ["zero1_axis_for"]


def zero1_axis_for(optimizer, mesh: Optional[Mesh]) -> Optional[str]:
    """The data axis to shard optimizer slots over (ZeRO-1), or None.

    Eligible: a DistOpt-style optimizer with ``shard_weight_update``, a
    mesh that has its data axis, and no compressed or sparsified sync
    (those warn and keep whole slots).  The reference also requires more
    than one device on the axis; the port keeps ZeRO-1 at a world of 1,
    where each rank's shard is the whole flattened parameter, so that a
    host with one card runs its reduce-scatter and all-gather."""
    if not getattr(optimizer, "shard_weight_update", False):
        return None
    axis = getattr(optimizer, "data_axis", None)
    if axis is None or mesh is None or mesh.shape.get(axis, 0) < 1:
        return None
    if getattr(optimizer, "compress_dtype", None) is not None \
            or getattr(optimizer, "topk_ratio", 0.0) \
            or getattr(optimizer, "compression", None) is not None:
        warnings.warn(
            "shard_weight_update is ignored when compressed/sparsified "
            "allreduce is configured: those variants keep whole "
            "optimizer slots on every rank", stacklevel=3)
        return None
    return axis
