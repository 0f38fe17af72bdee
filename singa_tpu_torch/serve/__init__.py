"""singa_tpu_torch.serve — the continuous-batching inference engine,
ported from ``singa_tpu/serve``.

* :mod:`~singa_tpu_torch.serve.slots` — :class:`BlockPool`, the PAGED
  KV-cache arena: fixed-size blocks behind per-request device-resident
  block tables, chain-hashed prefix-cache sharing with refcounts, an
  evictable LRU of resident prefixes, and static device storage that
  is only ever written in place.
* :mod:`~singa_tpu_torch.serve.scheduler` — FIFO queue, admission
  control (:class:`QueueFull` backpressure), per-request deadlines and
  token budgets, eviction policy.
* :mod:`~singa_tpu_torch.serve.engine` — :class:`ServeEngine`:
  ``submit() / step() / run_until_idle() / drain() / close()``,
  streaming token callbacks, greedy decode; its two programs
  (prefill-chunk and decode-over-block-tables) are captured as CUDA
  graphs on a card; retry, quarantine, shedding and arena recovery
  under injected faults.
* :mod:`~singa_tpu_torch.serve.metrics` — queue/slot gauges,
  admit/reject/evict counters, TTFT and per-token latency histograms
  through ``obs.events``.
* :mod:`~singa_tpu_torch.serve.spec` — the two halves of the
  prefill-chunk program (the verify program waits).

The int8 arena and spill tier (``serve/mem.py``), speculative decoding,
disaggregated serving and the multi-process tier are later slices.
"""

from .engine import EngineClosed, ServeEngine
from .scheduler import (EVICTED, FAILED, FINISHED, QUEUED, RUNNING,
                        QueueFull, RequestHandle, Scheduler)
from .slots import BlockPool

__all__ = ["ServeEngine", "BlockPool", "Scheduler", "RequestHandle",
           "QueueFull", "EngineClosed",
           "QUEUED", "RUNNING", "FINISHED", "EVICTED", "FAILED"]
