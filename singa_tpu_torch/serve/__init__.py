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
  admit/reject/evict counters, TTFT and per-token latency histograms,
  spill and speculation counters through ``obs.events``.
* :mod:`~singa_tpu_torch.serve.spec` — speculative decoding: draft
  propose-k / target verify-k as a third captured program over the same
  paged arena (the draft's KV blocks ride the same block tables);
  accepted runs are the target's own greedy picks, rejected positions
  roll back by position truncation, and a ``serve.verify`` fault falls
  back to plain decode for that tick.
* :mod:`~singa_tpu_torch.serve.mem` — the memory hierarchy: int8 KV
  blocks (``QuantKV``) and the host spill tier (``SpillStore``) with its
  captured restore program.
* :mod:`~singa_tpu_torch.serve.program` — :class:`Program`, one body
  over static tensors, eager once, then captured and replayed.

Disaggregated serving (``programs=``, the handoff) and the
multi-process tier are later slices.
"""

from .engine import SPEC_K_FALLBACK, EngineClosed, ServeEngine
from .mem import SpillStore
from .scheduler import (EVICTED, FAILED, FINISHED, QUEUED, RUNNING,
                        QueueFull, RequestHandle, Scheduler)
from .slots import BlockPool
from .spec import VerifyDispatchFailed

__all__ = ["ServeEngine", "BlockPool", "Scheduler", "RequestHandle",
           "QueueFull", "EngineClosed", "SpillStore",
           "VerifyDispatchFailed", "SPEC_K_FALLBACK",
           "QUEUED", "RUNNING", "FINISHED", "EVICTED", "FAILED"]
