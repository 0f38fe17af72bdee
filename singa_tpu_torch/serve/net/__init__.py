"""singa_tpu_torch.serve.net — multi-process disaggregated serving,
ported from ``singa_tpu/serve/net``.

The in-process tier (:mod:`~singa_tpu_torch.serve.disagg`) with the
workers moved into their own OS processes:

* :mod:`~singa_tpu_torch.serve.net.rpc` — framed request/response
  protocol over local sockets; every frame carries the contextvar trace
  id, so one request's timeline spans process boundaries.
* :mod:`~singa_tpu_torch.serve.net.codec` — versioned, length-prefixed,
  digest-checked binary wire format for ``HandoffPackage`` (a torn
  transfer is never injected; it replays instead), byte for byte the
  reference's.
* :mod:`~singa_tpu_torch.serve.net.procworker` — the worker-process
  main: one ``ServeEngine`` per process on the device it is given,
  deterministically built, reporting readiness over the control
  channel.
* :mod:`~singa_tpu_torch.serve.net.supervisor` —
  :func:`build_proc_pools` (mirrors ``build_pools``) and
  :class:`ProcRouter` (mirrors ``Router``), plus elastic grow/shrink of
  either pool at runtime, heartbeat liveness, respawn with backoff and
  a crash-loop breaker.
* :mod:`~singa_tpu_torch.serve.net.elastic` — the debounced autoscaling
  policy over SLO and backpressure signals.
"""

from .codec import (TornFrame, WireError, decode_package,
                    encode_package, probe_package)
from .elastic import ElasticPolicy
from .rpc import RPCError
from .supervisor import (ProcHandle, ProcRouter, ProcTierMetrics,
                         WorkerDied, WorkerProc, build_proc_pools)

__all__ = ["ProcRouter", "ProcHandle", "ProcTierMetrics", "WorkerProc",
           "WorkerDied", "build_proc_pools", "ElasticPolicy",
           "RPCError", "WireError", "TornFrame", "encode_package",
           "decode_package", "probe_package"]
