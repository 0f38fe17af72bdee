"""The sharding rules, ported from ``singa_tpu/parallel/spmd.py``.

Parameters get partition specs from per-model rules: regexes over the
parameter path, first match wins (``models.llama.LLAMA_SHARD_RULES``,
``models.transformer.TRANSFORMER_SHARD_RULES``, ``layer.MoE``'s).  An
axis that the mesh lacks, or that does not divide its dimension, is
dropped (replicated), so one rule set serves 1-D DP, 2-D DP×TP and 3-D
DP×TP×SP meshes unchanged.

The reference hands these specs to GSPMD, which inserts the
collectives.  The port reads them in ``parallel.tensor_parallel``
(``shard_params`` cuts each parameter to its rank's block and records
the spec; the Megatron layers of ``layer.py`` run the collectives), in
``distributed.local_batch`` (``batch_spec``) and in DistOpt
(``zero1_axis_for``).  ``param_shardings`` and ``tree_shardings`` give
the reference's shardings of parameters and optimizer slots;
``planner.plan_train_step`` reads ``spec_for``.
"""

from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, NamedSharding, P

__all__ = ["spec_for", "param_shardings", "batch_spec", "tree_shardings",
           "set_trace_rules", "current_trace_rules", "collect_shard_rules",
           "zero1_axis_for", "set_token_cut", "current_token_cut"]


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


# the model's merged rules while its step is traced (the reference's
# executor installs them for layer.PipelineStack, which derives its
# stacked weights' specs from them); the port's executor installs them
# around its step in the same way
_trace_rules: Optional[list] = None


def set_trace_rules(rules) -> None:
    global _trace_rules
    _trace_rules = rules


def current_trace_rules() -> Optional[list]:
    return _trace_rules


# how the multi-axis step cut its token batch: ((dim, axis), ...) over the
# (B, T) token grid, while the executor runs it (the reference's GSPMD
# step computes in global semantics, so what is global over the batch,
# such as MoE's capacity and balance loss, reads it)
_token_cut: Tuple[Tuple[int, str], ...] = ()


def set_token_cut(cut) -> None:
    global _token_cut
    _token_cut = tuple(cut or ())


def current_token_cut() -> Tuple[Tuple[int, str], ...]:
    return _token_cut


def collect_shard_rules(model) -> Optional[list]:
    """Model-level SHARD_RULES followed by any sublayer-declared rules
    (layer.MoE's expert sharding): first match wins, so model rules
    override layer defaults.  None when there are none."""
    rules = list(getattr(model, "SHARD_RULES", None) or [])
    seen = {id(r) for r in rules}
    for sub in model.modules():
        lr = getattr(type(sub), "SHARD_RULES", None)
        if lr and sub is not model:
            for r in lr:
                if id(r) not in seen:
                    rules.append(r)
                    seen.add(id(r))
    return rules or None


def spec_for(name: str, shape: Sequence[int], rules, mesh: Mesh) -> P:
    """The partition spec of a parameter path under `rules`, pruned to
    `mesh`."""
    if not rules:
        return P()
    for pat, spec in rules:
        if re.search(pat, name):
            axes: List[Optional[str]] = []
            for i, ax in enumerate(spec):
                if (ax is not None and ax in mesh.shape and i < len(shape)
                        and shape[i] % mesh.shape[ax] == 0
                        and shape[i] >= mesh.shape[ax]):
                    axes.append(ax)
                else:
                    axes.append(None)
            while axes and axes[-1] is None:
                axes.pop()
            return P(*axes)
    return P()


def param_shardings(params: Dict[str, torch.Tensor], rules,
                    mesh: Mesh) -> Dict[str, NamedSharding]:
    return {n: NamedSharding(mesh, spec_for(n, p.shape, rules, mesh))
            for n, p in params.items()}


def batch_spec(shape: Sequence[int], dtype, mesh: Mesh,
               data_axis: str = "data", seq_axis: str = "seq") -> P:
    """Input-batch spec: dim 0 over the data axis; for token-id arrays
    (2-D integer), dim 1 also over the seq axis."""
    axes: List[Optional[str]] = []
    if (shape and data_axis in mesh.shape
            and shape[0] % mesh.shape[data_axis] == 0):
        axes.append(data_axis)
    else:
        axes.append(None)
    if (len(shape) == 2 and _is_integer(dtype) and seq_axis in mesh.shape
            and shape[1] % mesh.shape[seq_axis] == 0):
        axes.append(seq_axis)
    while axes and axes[-1] is None:
        axes.pop()
    return P(*axes)


def _is_integer(dtype) -> bool:
    if isinstance(dtype, torch.dtype):
        return not (dtype.is_floating_point or dtype.is_complex
                    or dtype == torch.bool)
    return np.issubdtype(np.dtype(dtype), np.integer)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_shardings(tree, name_to_sharding: Dict[str, NamedSharding],
                   mesh: Mesh, param_shapes: Optional[Dict[str, Tuple]] = None,
                   zero1_axis: Optional[str] = None):
    """Map a {name: slot-tree} dict (optimizer state) to shardings:
    every leaf under `name` shares the parameter's sharding when shapes
    match, else is replicated.  With `zero1_axis`, leaves that would
    otherwise be fully replicated are sharded over that (data) axis on
    dim 0 where it divides (ZeRO-1)."""
    rep = NamedSharding(mesh, P())
    nshard = mesh.shape.get(zero1_axis, 0) if zero1_axis else 0
    out = {}
    for name, sub in tree.items():
        sh = name_to_sharding.get(name, rep)
        pshape = param_shapes.get(name) if param_shapes else None

        def pick(leaf, sh=sh, pshape=pshape):
            shape = tuple(getattr(leaf, "shape", ()))
            if pshape is not None and shape != tuple(pshape):
                return rep
            if (nshard > 1 and all(ax is None for ax in sh.spec)
                    and shape and shape[0] % nshard == 0
                    and shape[0] >= nshard):
                return NamedSharding(mesh, P(zero1_axis))
            return sh

        out[name] = _tree_map(pick, sub)
    return out
