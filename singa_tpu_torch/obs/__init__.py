"""singa_tpu_torch.obs — durable run records and structured telemetry,
ported from ``singa_tpu/obs``.

* :mod:`~singa_tpu_torch.obs.schema` — versioned field contracts for
  every telemetry record; ``require()`` gives consumers named-field
  errors instead of KeyError.
* :mod:`~singa_tpu_torch.obs.record` — :class:`RunRecord`, the
  append-only JSONL store of runs keyed by ``(run_id, platform,
  smoke)``.  The port's records go to a store of their own
  (``record.DEFAULT_STORE``), never the JAX package's.
* :mod:`~singa_tpu_torch.obs.events` — ``trace_span`` / ``counter`` /
  ``gauge`` / ``histogram`` with a JSONL sink and optional
  ``torch.profiler.record_function`` annotation of spans.
* :mod:`~singa_tpu_torch.obs.trace` — contextvar-carried request/step
  trace contexts.
* :mod:`~singa_tpu_torch.obs.flight` — :class:`FlightRecorder`, the
  bounded in-memory incident ring dumped next to the record store when
  a fault runs through to quarantine or recovery.
* :mod:`~singa_tpu_torch.obs.attr` — the per-program dispatch-time
  ledger.

Everything here is host-side Python: nothing of it runs inside a
captured CUDA graph.
"""

from . import attr, events, flight, record, schema, trace
from .events import (configure, counter, gauge, histogram,
                     histogram_summary, reset_histograms, span, trace_span)
from .flight import FlightRecorder
from .record import RunRecord, is_onchip_session_doc, new_entry, new_run_id
from .schema import SCHEMA_VERSION, SchemaError, require

__all__ = ["schema", "record", "events", "trace", "flight", "attr",
           "FlightRecorder", "RunRecord", "SchemaError",
           "SCHEMA_VERSION", "require", "new_entry", "new_run_id",
           "is_onchip_session_doc", "configure", "counter", "gauge",
           "span", "trace_span", "histogram", "histogram_summary",
           "reset_histograms"]
