"""Request/step-scoped trace contexts, ported from
``singa_tpu/obs/trace.py``.

A *trace* ties every telemetry event a subsystem emits while working on
one logical unit — a serve request — to one id, without threading that
id through every call signature.  The id rides a :mod:`contextvars`
context variable: ``ServeEngine`` activates a request's trace around
its admission/prefill/delivery sections, and
:mod:`singa_tpu_torch.obs.events` stamps the active ``trace`` (plus
``span``/``parent`` ids for spans, so spans nest) into every emitted
line.  The flight recorder (:mod:`singa_tpu_torch.obs.flight`) stamps
the same id into its in-memory ring, which is how an incident dump
reconstructs exactly the poisoned request's timeline.

Thread rules (the part contextvars do NOT do automatically):

* a ``threading.Thread`` starts with an EMPTY context — it never
  inherits the spawner's trace by accident, so two threads cannot leak
  span parentage into each other's traces;
* a worker that SHOULD carry the spawner's trace captures it with
  :func:`capture` on the spawning thread and re-enters it with
  :func:`attach` on the worker;
* a watchdog that observes the whole process rather than one unit
  (``utils.failure.Heartbeat``'s monitor thread) deliberately runs
  trace-less — its events are engine-scoped, not request-scoped
  (documented there).

Zero-overhead contract: reading/activating a context is a few hundred
nanoseconds of pure Python and allocates nothing persistent; when no
telemetry consumer is installed, nothing downstream even reads it.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
from typing import Iterator, Optional, Tuple

__all__ = ["new_trace_id", "current", "current_trace_id",
           "current_span_id", "activate", "capture", "attach",
           "new_span_id"]

#: (trace_id, parent_span_id) of the active trace, or None outside one.
#: One ContextVar holding a tuple, so readers pay a single .get().
_STATE: contextvars.ContextVar[Optional[Tuple[str, Optional[int]]]] = \
    contextvars.ContextVar("singa_obs_trace", default=None)

_trace_seq = itertools.count()
_span_seq = itertools.count(1)


def new_trace_id(prefix: str = "tr") -> str:
    """A process-unique trace id (``<prefix>-<pid>-<seq>``).  Callers
    with a naturally-unique id (a run_id, ``run_id/r<rid>``) should use
    that instead — ids exist to be greppable."""
    return f"{prefix}-{os.getpid()}-{next(_trace_seq)}"


def new_span_id() -> int:
    """Process-unique span id (monotonic int; uniqueness is per process,
    which is the scope a trace file covers)."""
    return next(_span_seq)


def current() -> Optional[Tuple[str, Optional[int]]]:
    """The active ``(trace_id, parent_span_id)``, or None."""
    return _STATE.get()


def current_trace_id() -> Optional[str]:
    ctx = _STATE.get()
    return ctx[0] if ctx is not None else None


def current_span_id() -> Optional[int]:
    ctx = _STATE.get()
    return ctx[1] if ctx is not None else None


@contextlib.contextmanager
def activate(trace_id: str,
             parent_span: Optional[int] = None) -> Iterator[str]:
    """Make ``trace_id`` the active trace for the dynamic extent of the
    block.  Nested activations shadow (and restore) the outer trace —
    e.g. a per-request section inside an engine-level span."""
    token = _STATE.set((trace_id, parent_span))
    try:
        yield trace_id
    finally:
        _STATE.reset(token)


def capture() -> Optional[Tuple[str, Optional[int]]]:
    """Snapshot the active context for hand-off to a worker thread
    (:func:`attach` on the other side).  Returns None outside a trace —
    attaching None is a documented no-op, so capture/attach pairs are
    safe unconditionally."""
    return _STATE.get()


@contextlib.contextmanager
def attach(ctx: Optional[Tuple[str, Optional[int]]]) -> Iterator[None]:
    """Re-enter a context captured on another thread (the checkpoint
    writer inheriting the saving step's trace).  ``attach(None)`` is a
    no-op block."""
    if ctx is None:
        yield
        return
    token = _STATE.set(ctx)
    try:
        yield
    finally:
        _STATE.reset(token)


def _push_span(span_id: int):
    """Used by ``events._Span``: keep the trace, re-parent children to
    ``span_id``.  Returns the reset token (None when no trace is
    active)."""
    ctx = _STATE.get()
    if ctx is None:
        return None
    return _STATE.set((ctx[0], span_id))


def _pop_span(token) -> None:
    if token is not None:
        _STATE.reset(token)
