"""singa_tpu_torch.autotune — the record-driven autotuner, ported from
``singa_tpu/autotune`` (host-only: numpy and the port's ``obs``).

* :mod:`~singa_tpu_torch.autotune.knobs` — the closed registry of
  tunable knobs per domain (train: batch / ce_chunk / int8_ring; serve:
  num_slots / block_size / spec_k / spill_blocks / pool_ratio) and
  their defaults;
* :mod:`~singa_tpu_torch.autotune.sweep` — knob points ->
  ``autotune_sweep`` records under one ``sweep_id`` (+ the
  ``point = -1`` fit record);
* :mod:`~singa_tpu_torch.autotune.predictor` — deterministic ridge /
  nearest-neighbor fit with an exact leave-one-out error report;
* :mod:`~singa_tpu_torch.autotune.table` — the port's committed
  best-config table (``singa_tpu_torch/autotune/data/best.json``,
  measured on the card) that ``ServeEngine``, the elastic policy and
  the load driver consult by default (explicit values always win; a
  missing entry falls back to the shipped constants, loudly once).

Front door: ``python -m singa_tpu_torch.tools.autotune`` (sweep / fit /
best / check / smoke).
"""

from . import knobs, predictor, sweep, table  # noqa: F401
from .knobs import DEFAULTS, KNOBS, OBJECTIVES, KnobError  # noqa: F401
from .predictor import Predictor, best_point, fit_points  # noqa: F401
from .table import (best_knobs, load_table, model_key,  # noqa: F401
                    pick_spec_k, resolve, resolve_spec_k)

__all__ = ["knobs", "predictor", "sweep", "table", "KNOBS", "DEFAULTS",
           "OBJECTIVES", "KnobError", "Predictor", "fit_points",
           "best_point", "model_key", "best_knobs", "resolve",
           "resolve_spec_k", "pick_spec_k", "load_table"]
