"""Continuous-batching scheduler: request queue, admission control,
deadlines, eviction policy.  A copy of ``singa_tpu/serve/scheduler.py``
(pure host-side Python).

Pure host-side policy — no device code.  The engine asks the scheduler
three questions each step: who expired (deadline eviction, including
requests that died *waiting in the queue*), who to admit into the free
slots (FIFO — prefill interleaves between decode steps), and whether a
running request just finished (EOS / token budget / deadline).  Keeping
policy out of the engine keeps the two captured programs policy-free:
scheduling decisions can change per step without touching a graph.

Admission control (backpressure): `offer()` refuses requests beyond
``max_queue`` waiting entries by raising :class:`QueueFull` — callers
see rejection at submit time, not a silently growing queue.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np

__all__ = ["QueueFull", "Request", "RequestHandle", "Scheduler",
           "eta_first_token",
           "QUEUED", "RUNNING", "FINISHED", "EVICTED", "FAILED"]


def eta_first_token(position: int, *, free_slots: int, wave_size: int,
                    tick_s: float,
                    tokens_per_tick: float = 1.0) -> float:
    """Seconds until the queued request at ``position`` could plausibly
    deliver its first token — the ONE eta model behind
    :meth:`Scheduler.shed_overload` (engines and the disaggregated
    router's workers both delegate here).

    Shedding runs immediately before admission in the same tick, so the
    first ``free_slots`` queued requests prefill THIS tick — eta 0.0,
    never shed (a truly-expired deadline is eviction's job, not
    shedding's).  Requests behind that window wait about one admission
    period per wave of ``wave_size`` slots.

    ``tick_s`` is the ADMISSION PERIOD of the pool this queue drains
    into, not necessarily one engine's own step time: a worker stepped
    by the disaggregated Router gets one admission opportunity per
    ROUTER round (which steps every worker), so the router pushes its
    measured round time into each worker via
    ``ServeEngine.tick_hint_s`` and the eta uses the slower of the two
    clocks.

    ``tokens_per_tick`` is the measured ACCEPTED-tokens-per-tick per
    slot (``ServeEngine._tpt_ewma``): a speculative verify-k engine
    delivers up to ``k + 1`` tokens per dispatch, so its running slots
    free up proportionally faster and a queued request's wave count is
    worth ``tick_s / tokens_per_tick`` seconds, not ``tick_s``.  Values
    below 1 are clamped — a partially-delivered tick must not make the
    eta OPTIMISTIC about a plain engine."""
    if position < free_slots:
        return 0.0
    waves = 1 + (position - free_slots) // max(1, wave_size)
    return tick_s * waves / max(1.0, tokens_per_tick)

QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
EVICTED = "evicted"
#: terminal state of a request the ENGINE gave up on (quarantined after
#: repeatedly poisoning prefill, or unrecoverable after an arena
#: rebuild) — surfaced on the handle instead of crashing the engine
FAILED = "failed"


class QueueFull(RuntimeError):
    """Admission refused: the wait queue is at capacity.  (Queued
    requests drain into slots only at step() boundaries, so a large
    enough burst between ticks is refused even while slots are free —
    bounded queueing is the backpressure contract.)  The caller should
    shed load or retry later."""


class Request:
    """One generation request's full lifecycle state (engine-internal;
    users hold the :class:`RequestHandle` view)."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, max_new_tokens: int,
                 deadline_s: Optional[float],
                 eos_id: Optional[int],
                 on_token: Optional[Callable[[int, "RequestHandle"], None]]):
        self.rid = next(Request._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + float(deadline_s)
                         if deadline_s is not None else None)
        self.eos_id = eos_id
        self.on_token = on_token
        self.state = QUEUED
        self.slot: Optional[int] = None
        self.tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.ttft_s: Optional[float] = None
        self._replay: Optional[np.ndarray] = None   # replay_ids memo
        self.prefix_keys: Optional[list] = None     # chain-key memo
        # stamped by ServeEngine.submit (engine run_id + rid): the
        # obs.trace id every event about this request carries
        self.trace_id: Optional[str] = None
        self.handle = RequestHandle(self)

    def replay_ids(self) -> np.ndarray:
        """prompt + tokens generated so far — what an arena-recovery
        re-prefill feeds the prefill program, and (via
        :meth:`RequestHandle.result`) the user-facing full sequence.
        Greedy decode makes the replay idempotent: the re-prefilled
        slot's next token is exactly the token decode would have
        produced next, so recovering any number of times leaves the
        final stream bit-identical.

        Memoized while the token list is unchanged: the admission path
        asks for the replay several times per step for a head-of-queue
        request waiting on free blocks (callers treat it read-only;
        the user-facing copy is :meth:`RequestHandle.result`)."""
        size = self.prompt.size + len(self.tokens)
        if self._replay is None or self._replay.size != size:
            self._replay = np.concatenate(
                [self.prompt, np.asarray(self.tokens, np.int32)])
        return self._replay

    # -- transitions (called by the engine) ------------------------------
    def deliver(self, tok: int) -> bool:
        """Record one generated token; returns True when the request is
        now complete (EOS emitted or token budget spent).  The EOS token
        itself is kept — same convention as GenerateMixin.generate."""
        if self.ttft_s is None:
            self.ttft_s = time.monotonic() - self.submitted_at
        self.tokens.append(int(tok))
        if self.eos_id is not None and int(tok) == self.eos_id:
            self.finish_reason = "eos"
            return True
        if len(self.tokens) >= self.max_new_tokens:
            self.finish_reason = "length"
            return True
        return False

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class RequestHandle:
    """User-facing view of a submitted request (returned by
    ``ServeEngine.submit``)."""

    def __init__(self, req: Request):
        self._req = req

    @property
    def rid(self) -> int:
        return self._req.rid

    @property
    def trace_id(self) -> Optional[str]:
        """The request's obs trace id (``<engine run_id>/r<rid>``) —
        the key for ``obsq trace`` and for slicing a flight-recorder
        dump to this request's timeline."""
        return self._req.trace_id

    @property
    def status(self) -> str:
        return self._req.state

    @property
    def done(self) -> bool:
        return self._req.state in (FINISHED, EVICTED, FAILED)

    @property
    def failed(self) -> bool:
        """True when the engine gave up on this request (quarantined /
        unrecoverable) — a per-request failure status, never an engine
        crash."""
        return self._req.state == FAILED

    @property
    def error(self) -> Optional[str]:
        """The failure message when :attr:`failed`, else None."""
        return self._req.error

    @property
    def finish_reason(self) -> Optional[str]:
        """'eos' | 'length' | 'deadline' | 'shed' | 'quarantined' |
        'unrecoverable' (None while in flight)."""
        return self._req.finish_reason

    @property
    def tokens(self) -> List[int]:
        """Generated token ids so far (no prompt)."""
        return list(self._req.tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        return self._req.ttft_s

    def result(self) -> np.ndarray:
        """prompt + generated tokens as one int32 vector (a private
        copy — the engine memoizes the underlying array)."""
        return self._req.replay_ids().copy()


class Scheduler:
    """FIFO queue + admission/eviction policy over a fixed slot count."""

    def __init__(self, max_queue: int):
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self.queue: Deque[Request] = deque()

    @property
    def depth(self) -> int:
        return len(self.queue)

    def offer(self, req: Request) -> None:
        """Enqueue, or raise :class:`QueueFull` (admission control)."""
        if len(self.queue) >= self.max_queue:
            raise QueueFull(
                f"queue full ({len(self.queue)}/{self.max_queue} waiting); "
                f"request rejected — shed load or raise max_queue")
        self.queue.append(req)

    def expire_queued(self, now: float) -> List[Request]:
        """Drop queued requests already past their deadline (they would
        only waste a prefill).  Returns the dropped requests."""
        dead = [r for r in self.queue if r.expired(now)]
        if dead:
            self.queue = deque(r for r in self.queue if not r.expired(now))
            for r in dead:
                r.state = EVICTED
                r.finish_reason = "deadline"
        return dead

    def shed_overload(self, now: float,
                      eta_first_token_s: Callable[[int], float]
                      ) -> List[Request]:
        """Deadline-aware overload shedding: evict queued requests whose
        deadline will expire before they could plausibly produce a first
        token.  ``eta_first_token_s(position)`` is the engine's estimate
        of seconds until the request at queue ``position`` would deliver
        its first token (derived from measured tick times — see
        :func:`eta_first_token` for the model, including how a
        multi-pool tier folds the router's admission cadence in); a
        request with ``deadline < now + eta`` only wastes a prefill, so
        it is shed NOW — at admission-decision time, not after burning
        a slot.  Deadline-less requests are never shed."""
        shed: List[Request] = []
        keep: Deque[Request] = deque()
        pos = 0
        for r in self.queue:
            if (r.deadline is not None
                    and now + eta_first_token_s(pos) > r.deadline):
                r.state = EVICTED
                r.finish_reason = "shed"
                shed.append(r)
            else:
                keep.append(r)
                pos += 1
        self.queue = keep
        return shed

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put recovered in-flight requests back at the HEAD of the
        queue, preserving their order — they were already admitted once,
        so re-admission after an arena rebuild must neither lose their
        FIFO priority nor be refused by ``max_queue`` backpressure."""
        for r in reversed(reqs):
            r.state = QUEUED
            r.slot = None
            self.queue.appendleft(r)

    def peek(self) -> Optional[Request]:
        """The request :meth:`pop_for_admission` would return, without
        removing it — the engine checks the head's BLOCK need against
        the paged arena before committing to admission (FIFO: a head
        the free blocks cannot cover blocks the line rather than being
        overtaken, so admission order stays deterministic)."""
        return self.queue[0] if self.queue else None

    def pop_for_admission(self) -> Optional[Request]:
        """Next request to prefill into a free slot (FIFO), or None."""
        return self.queue.popleft() if self.queue else None
