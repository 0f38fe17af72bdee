"""The autotuner's knob registry, ported from
``singa_tpu/autotune/knobs.py``: the one catalogue of tunable
configuration the port exposes.

Every knob here is a constructor argument or config field somewhere in
the package; the registry makes the set closed and checkable.  A sweep
record naming a knob that is not in :data:`KNOBS` is refused — a typo'd
knob name would otherwise fit a predictor on a column of noise and
commit a best-config table nothing consumes.

Two domains, the two entry points the sweep driver
(:mod:`singa_tpu_torch.autotune.sweep`) drives:

* ``train`` — ``batch`` (global batch size through the captured train
  step), ``ce_chunk`` (``LlamaConfig.fused_loss_chunk``, the fused
  lm-head + cross-entropy chunk), ``int8_ring`` (``DistOpt(compression=
  "int8_ring")``, 0/1).
* ``serve`` — ``num_slots`` / ``block_size`` (the paged-arena shape
  every ``ServeEngine`` captures against), ``spec_k`` (the speculative
  verify-k window; 0 = plain decode), ``spill_blocks`` (the host-RAM
  KV spill store capacity; 0 = off), ``pool_ratio`` (the decode share
  of the process tier's worker budget the elastic policy steers
  toward).

Knob values are stored as NUMBERS in records and in the best-config
table (booleans as 0/1), so the predictor's feature vector needs no
per-knob encoding rules.  Names, defaults and objectives are the
reference's.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List, Tuple

__all__ = ["KNOBS", "DEFAULTS", "OBJECTIVES", "validate_knobs",
           "grid_points", "KnobError"]

#: domain -> knob name -> one-line description.  Kept a module-level
#: literal so tooling can enumerate it without importing torch.
KNOBS: Dict[str, Dict[str, str]] = {
    "train": {
        "batch": "global batch size through the compiled train step",
        "ce_chunk": "fused lm-head+CE chunk rows "
                    "(LlamaConfig.fused_loss_chunk)",
        "int8_ring": "DistOpt gradient-sync compression on the DP mesh "
                     "(0 = f32 ring, 1 = error-feedback int8_ring)",
    },
    "serve": {
        "num_slots": "ServeEngine decode-batch slot count (arena rows)",
        "block_size": "paged-KV block size in tokens (arena granularity)",
        "spec_k": "speculative verify-k window (0 = plain decode)",
        "spill_blocks": "host-RAM KV spill store capacity in blocks "
                        "(ServeEngine spill_blocks; 0 = spill off)",
        "pool_ratio": "decode share of the disaggregated worker budget "
                      "(serve.net elastic target; 0.5 = even split)",
    },
}

#: the hand-carried constants each consumer falls back to when no
#: best-config table entry decides — the reference's constants.
DEFAULTS: Dict[str, Dict[str, float]] = {
    "train": {"batch": 4, "ce_chunk": 512, "int8_ring": 0},
    "serve": {"num_slots": 8, "block_size": 8, "spec_k": 0,
              "spill_blocks": 0, "pool_ratio": 0.5},
}

#: domain -> (objective payload field, direction).  The sweep driver
#: measures it, the fit picks the argbest, the table commits it.
OBJECTIVES: Dict[str, Tuple[str, str]] = {
    "train": ("step_ms", "min"),
    "serve": ("tokens_per_s", "max"),
}


class KnobError(ValueError):
    """An unknown domain or knob name — always loud, never coerced."""


def validate_knobs(domain: str, knobs: Any,
                   ctx: str = "knobs") -> List[str]:
    """Error strings ([] = valid): ``domain`` must be registered,
    ``knobs`` a non-empty dict whose keys are registered knob names for
    that domain and whose values are numeric (bools rejected — a knob
    accidentally recorded as ``True`` must not fit as a measurement)."""
    errors: List[str] = []
    if domain not in KNOBS:
        return [f"{ctx}: unknown autotune domain {domain!r} "
                f"(registered: {sorted(KNOBS)})"]
    if not isinstance(knobs, dict) or not knobs:
        return [f"{ctx}: knobs must be a non-empty object, got "
                f"{knobs!r}"]
    for name, value in knobs.items():
        if name not in KNOBS[domain]:
            errors.append(
                f"{ctx}: unknown {domain} knob {name!r} (registered: "
                f"{sorted(KNOBS[domain])})")
        elif not isinstance(value, (int, float)) or isinstance(value, bool):
            errors.append(f"{ctx}: knob {name!r} must be numeric, got "
                          f"{value!r}")
    return errors


def require_knobs(domain: str, knobs: Any, ctx: str = "knobs") -> None:
    """:func:`validate_knobs`, raising :class:`KnobError` on the first
    problem — the fail-loudly entry the sweep driver and predictor use."""
    errors = validate_knobs(domain, knobs, ctx)
    if errors:
        raise KnobError(errors[0])


def grid_points(domain: str,
                grid: Dict[str, Iterable[Any]]) -> List[Dict[str, Any]]:
    """The cartesian product of ``grid`` as a list of knob dicts, in
    deterministic (sorted-knob, given-value) order.  Every knob name is
    validated up front."""
    if not grid:
        raise KnobError(f"{domain} sweep: empty knob grid")
    names = sorted(grid)
    for name in names:
        require_knobs(domain, {name: 0}, ctx=f"{domain} sweep grid")
    value_lists = [list(grid[name]) for name in names]
    for name, values in zip(names, value_lists):
        if not values:
            raise KnobError(f"{domain} sweep grid: knob {name!r} has no "
                            f"values")
    return [dict(zip(names, combo))
            for combo in itertools.product(*value_lists)]
