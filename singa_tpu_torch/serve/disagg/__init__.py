"""singa_tpu_torch.serve.disagg — disaggregated serving, ported from
``singa_tpu/serve/disagg``.

Prefill chunks are compute-bound and decode ticks weight-read bound, so
one engine co-scheduling both wastes whichever resource the traffic
mix does not saturate.  This package splits them into separately
scaled pools behind an SLO-aware front door:

* :mod:`~singa_tpu_torch.serve.disagg.worker` — :class:`Worker` (one
  :class:`~singa_tpu_torch.serve.engine.ServeEngine` and a ``prefill``
  / ``decode`` role) and :func:`build_pools`, which constructs N + M
  same-config workers serving from ONE weight copy
  (``SharedPrograms``), each capturing its own programs.
* :mod:`~singa_tpu_torch.serve.disagg.handoff` — the KV block handoff:
  a finished prefill is blocks and a table row, gathered by the
  engine's handoff program, copied into the package and written into
  the destination arena in place, block by block; refcounts and
  prefix-cache chain keys transfer with the blocks, so shared prefixes
  cross once per decode worker, not once per request.
* :mod:`~singa_tpu_torch.serve.disagg.router` — :class:`Router`:
  per-tenant quotas, :class:`SLOClass` deadlines enforced by the
  scheduler's backpressure and shed machinery, least-loaded routing,
  the ``serve.handoff``/``serve.router`` fault sites (worker death →
  re-route, re-prefill from prompt, streams bitwise identical), and
  one trace id per request across every worker it touches.
"""

from .handoff import HandoffPackage
from .router import QuotaExceeded, Router, SLOClass, TierMetrics
from .worker import DECODE, PREFILL, Worker, build_pools

__all__ = ["Router", "SLOClass", "QuotaExceeded", "TierMetrics",
           "Worker", "build_pools", "HandoffPackage",
           "PREFILL", "DECODE"]
