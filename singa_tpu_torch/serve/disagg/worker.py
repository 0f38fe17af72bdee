"""Worker pools for the disaggregated serving tier, ported from
``singa_tpu/serve/disagg/worker.py``.

A *worker* is one :class:`~singa_tpu_torch.serve.engine.ServeEngine`
plus its role in the tier — ``"prefill"`` (ticked with
``step(decode=False)``, its finished prefills handed off by the router)
or ``"decode"`` (receives handoffs, runs decode ticks; its own queue is
normally empty, but the engine keeps BOTH programs, so a decode
worker's arena recovery re-prefills locally without the router).

Prefill chunks are compute-bound and decode ticks weight-read bound, so
one engine co-scheduling both wastes whichever resource the traffic
mix does not saturate; separately sized pools let each phase scale
against its own bottleneck.

:func:`build_pools` constructs N + M same-config workers that all
share ONE :class:`~singa_tpu_torch.serve.engine.SharedPrograms` — one
served weight copy and one set of step closures.  Each worker captures
its own programs (a CUDA graph reads its engine's arena by address),
so every worker's ``compiled_counts()`` stays at (1, 1).

Speculative decoding: pass ``draft_model=``/``spec_k=`` through
``engine_kwargs`` and the whole tier carries the draft — prefill
workers write both arenas (so a handoff package ships draft KV beside
target KV, see handoff.py) and decode workers run verify rounds.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

from ..engine import ServeEngine

__all__ = ["Worker", "build_pools", "PREFILL", "DECODE"]

PREFILL = "prefill"
DECODE = "decode"

_WORKER_SEQ = itertools.count()


class Worker:
    """One engine + its role.  ``alive`` is the router's health flag:
    a dead worker is never routed to again and its in-flight requests
    are re-routed (re-prefilled from prompt + tokens-so-far)."""

    def __init__(self, name: str, role: str, engine: ServeEngine):
        if role not in (PREFILL, DECODE):
            raise ValueError(f"unknown worker role {role!r} "
                             f"(expected {PREFILL!r} or {DECODE!r})")
        self.name = name
        self.role = role
        self.engine = engine
        self.alive = True

    @property
    def load(self) -> int:
        """Queued + running requests — the router's least-loaded
        routing key."""
        return self.engine.pending

    def __repr__(self) -> str:
        return (f"Worker({self.name!r}, {self.role}, "
                f"{'alive' if self.alive else 'DEAD'}, "
                f"load={self.load})")


def build_pools(model, n_prefill: int, n_decode: int, *,
                template: Optional[ServeEngine] = None,
                num_slots: int = 4, max_len: int = 64,
                block_size: int = 16,
                num_blocks: Optional[int] = None,
                share_prefix: bool = True,
                max_queue: Optional[int] = None,
                record_store: Optional[str] = None,
                **engine_kwargs) -> Tuple[List[Worker], List[Worker]]:
    """(prefill_workers, decode_workers): N + M homogeneous engines
    over ``model``, all sharing the weight copy and step closures of
    ``template`` (or of the first worker built here).  ``engine_kwargs`` pass
    through to every :class:`ServeEngine` (retry/backoff budgets,
    recovery limits, ...); ``record_store`` lands on each worker so
    per-worker incidents and flight dumps have a durable home."""
    if n_prefill < 1 or n_decode < 1:
        raise ValueError(
            f"a tier needs at least one worker per pool, got "
            f"{n_prefill} prefill / {n_decode} decode")
    kw = dict(block_size=block_size, num_blocks=num_blocks,
              share_prefix=share_prefix, max_queue=max_queue,
              record_store=record_store, **engine_kwargs)
    programs = template.programs() if template is not None else None
    gen = next(_WORKER_SEQ)
    prefill: List[Worker] = []
    decode: List[Worker] = []
    for pool, role, n in ((prefill, PREFILL, n_prefill),
                          (decode, DECODE, n_decode)):
        for i in range(n):
            eng = ServeEngine(model, num_slots, max_len,
                              programs=programs, **kw)
            if programs is None:
                programs = eng.programs()
            pool.append(Worker(f"{role[0]}{i}-{gen}", role, eng))
    return prefill, decode
