"""singa_tpu_torch.train — fault-tolerant run orchestration, ported from
``singa_tpu/train``.

The subsystem that owns a training run end to end and makes it survive
the failure modes a production fleet actually hits — preemption, torn
writes, wedged collectives, transient device errors:

* :mod:`~singa_tpu_torch.train.loop` — :class:`TrainRunner`: steps the
  model, integrates Heartbeat + device liveness, retries transient
  failures with bounded backoff, converts repeated failure into a
  recorded clean abort after an emergency checkpoint.
* :mod:`~singa_tpu_torch.train.ckpt` — :class:`AsyncCheckpointManager`:
  device→host snapshot on the step thread, serialization + atomic
  rename + commit marker on a background writer, keep-last-N /
  keep-every-M retention.  A torn write is never loadable.
* :mod:`~singa_tpu_torch.train.state` — :class:`RunState`:
  schema-versioned bundle of step/epoch/data-cursor/generator states so
  a resumed run reproduces the uninterrupted trajectory bit-for-bit.
* :mod:`~singa_tpu_torch.train.preempt` — :class:`PreemptionHandler`:
  SIGTERM/SIGINT request checkpoint-and-exit at the next step boundary.

The reference's docs/training.md describes the run lifecycle, the
checkpoint commit protocol and resume semantics, which this port
keeps; ``python -m singa_tpu_torch.tools.ckpt_fsck DIR`` audits a
checkpoint directory.
"""

from . import ckpt, loop, preempt, state
from .ckpt import AsyncCheckpointManager, CheckpointCorrupt
from .loop import TrainAborted, TrainResult, TrainRunner
from .preempt import PreemptionHandler
from .state import RunState

__all__ = ["ckpt", "loop", "preempt", "state", "AsyncCheckpointManager",
           "CheckpointCorrupt", "TrainRunner", "TrainResult",
           "TrainAborted", "PreemptionHandler", "RunState"]
