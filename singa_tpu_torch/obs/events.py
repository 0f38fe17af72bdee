"""Structured telemetry events: spans, counters, gauges, histograms,
ported from ``singa_tpu/obs/events.py``.

A thin host-side event layer over the hot paths (the step executor's
capture and replay, generate() sessions, the serve engine's
dispatches).  Disabled by default and engineered so the disabled path
costs one attribute check — `span()` returns a shared no-op context
manager and `counter()/gauge()` return immediately — because
`Model.train_step` calls into here every step.

Enable with either:

* ``SINGA_OBS=/path/to/events.jsonl`` in the environment (one JSON
  object per line), or programmatically ``events.configure(path=...)``;
* ``SINGA_OBS_XPROF=1`` to additionally wrap spans in
  ``torch.profiler.record_function`` so they show up on the
  ``torch.profiler`` timeline next to the card's kernels.

Span durations are host-side wall clock.  A kernel launch or a CUDA
graph replay returns before the card has run it, so a span around one
measures the time to enqueue it (plus any blocking fetch the caller
does inside), not device time; spans tell you *what ran when* and
catch multi-second stalls (captures, hangs), they are not an MFU
instrument.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import warnings
from typing import Any, Dict, Optional

from . import trace

__all__ = ["JsonlSink", "configure", "enabled", "get_sink", "span",
           "trace_span", "counter", "gauge", "histogram",
           "histogram_summary", "reset_histograms"]


class JsonlSink:
    """Append events to a JSONL file (thread-safe, line-buffered).

    ``max_bytes`` (or ``SINGA_OBS_MAX_BYTES``; default off) bounds the
    file: when the next line would cross the limit the current file is
    atomically renamed to ``<path>.1`` (replacing the previous rollover)
    and a fresh file is opened — a long soak holds at most
    ``2 * max_bytes`` of event data on disk instead of growing without
    bound."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        if max_bytes is not None and int(max_bytes) < 0:
            raise ValueError(
                f"max_bytes must be >= 0 (0/None disables rotation), "
                f"got {max_bytes}")
        self.max_bytes = int(max_bytes) if max_bytes else None
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")
        self._size = self._f.tell()
        self._lock = threading.Lock()

    def emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, sort_keys=True, default=_jsonable)
        with self._lock:
            if self._f.closed:
                return
            try:
                if (self.max_bytes is not None and self._size
                        and self._size + len(line) + 1 > self.max_bytes):
                    self._rotate()
                self._f.write(line + "\n")
                self._f.flush()
                self._size += len(line) + 1
            except (OSError, ValueError):
                # disk full / fd gone mid-run: telemetry degrades, the
                # training loop it instruments must never die for it
                try:
                    self._f.close()
                except OSError:
                    pass

    def _rotate(self) -> None:
        """Size-based rollover (caller holds the lock): close, atomic
        ``os.replace`` to ``<path>.1`` (clobbering the previous roll),
        reopen fresh — every retained line lives in a complete file."""
        self._f.close()
        os.replace(self.path, self.path + ".1")
        # the sink lock serialises file writers; one reopen per max_bytes
        self._f = open(self.path, "a")
        self._size = 0

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


_sink: Optional[JsonlSink] = None
_annotate = False
#: serializes sink swaps: two concurrent configure() calls would both
#: read the same ``old`` and one replaced sink would never be closed
_config_lock = threading.Lock()


def configure(sink: Optional[JsonlSink] = None, path: Optional[str] = None,
              annotate: Optional[bool] = None,
              max_bytes: Optional[int] = None) -> None:
    """Install/replace the event sink and/or the XProf annotation flag.

    ``configure()`` with no arguments disables the JSONL sink (closing
    the old one) and leaves annotation untouched.  ``max_bytes``
    applies to a sink built from ``path`` (size-based rollover to
    ``<path>.1``; ``SINGA_OBS_MAX_BYTES`` in the environment).

    Safe to call while other threads emit: emitters snapshot the sink
    reference once per event (see ``_emit``), and a swapped-out sink's
    ``emit`` degrades to a no-op once closed."""
    if path is not None:
        sink = JsonlSink(path, max_bytes=max_bytes)
    global _sink, _annotate
    with _config_lock:
        old = _sink
        _sink = sink
        if annotate is not None:
            _annotate = bool(annotate)
    if old is not None and old is not sink:
        old.close()


def _init_from_env() -> None:
    path = os.environ.get("SINGA_OBS")
    if path:
        max_bytes: Optional[int] = None
        raw = os.environ.get("SINGA_OBS_MAX_BYTES")
        if raw:
            try:
                max_bytes = int(raw)
            except ValueError:
                warnings.warn(f"SINGA_OBS_MAX_BYTES={raw!r} is not an "
                              f"integer; sink rotation disabled",
                              stacklevel=2)
            if max_bytes is not None and max_bytes < 0:
                # a bad limit must degrade to "no rotation", never kill
                # the sink itself (JsonlSink would raise ValueError)
                warnings.warn(f"SINGA_OBS_MAX_BYTES={raw!r} is negative; "
                              f"sink rotation disabled", stacklevel=2)
                max_bytes = None
        try:
            configure(path=path, max_bytes=max_bytes)
        except (OSError, ValueError):
            # unwritable path / bad limit must never break training
            pass
    if os.environ.get("SINGA_OBS_XPROF") == "1":
        configure(sink=_sink, annotate=True)


def enabled() -> bool:
    """Cheap hot-path check: is any telemetry consumer installed?"""
    return _sink is not None or _annotate


def get_sink() -> Optional[JsonlSink]:
    return _sink


def _emit(kind: str, name: str, attrs: Dict[str, Any]) -> None:
    # SNAPSHOT the module global exactly once: a concurrent
    # configure() can swap (or clear) the sink between a check and a
    # use, and the pre-fix double read of ``_sink`` crashed the
    # emitting thread with AttributeError — telemetry taking down the
    # step loop it instruments.  Emitting into the just-replaced sink is
    # fine: its emit() is a silent no-op once closed.
    sink = _sink
    if sink is None:
        return
    # wall-clock stamps correlate across files; durations use the
    # monotonic clock in span()
    ev = {"t": time.time(), "kind": kind, "name": name}
    # request/step attribution: every event emitted inside
    # an active obs.trace context carries its trace id — how obsq
    # reconstructs one request's timeline out of an interleaved stream
    tid = trace.current_trace_id()
    if tid is not None and "trace" not in attrs:
        ev["trace"] = tid
    ev.update(attrs)
    sink.emit(ev)


def counter(name: str, value, **attrs) -> None:
    """A monotonically-accumulating quantity (bytes moved, steps run)."""
    if _sink is not None:
        attrs["value"] = value
        _emit("counter", name, attrs)


def gauge(name: str, value, **attrs) -> None:
    """A point-in-time level (loss, queue depth, HBM headroom)."""
    if _sink is not None:
        attrs["value"] = value
        _emit("gauge", name, attrs)


#: bounded per-name sample buffer: count/sum/min/max stay exact beyond
#: this; percentiles are computed over a deterministic ring of the most
#: recent _HIST_CAP observations (no RNG — reproducible summaries)
_HIST_CAP = 4096


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "samples")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: list = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < _HIST_CAP:
            self.samples.append(v)
        else:
            self.samples[(self.count - 1) % _HIST_CAP] = v

    def summary(self) -> Optional[Dict[str, Any]]:
        """{count, sum, mean, min, max, p50, p90, p99}, or None when
        nothing was observed yet.

        Determinism/approximation contract: count/sum/mean/min/max are
        exact over every
        observation.  Percentiles are nearest-rank over the retained
        ring — observation ``i`` (0-based) lives in slot
        ``i % _HIST_CAP``, so once the ring has wrapped it holds
        exactly the most recent ``_HIST_CAP`` observations and the same
        insertion order always reproduces the same summary (no RNG, no
        reservoir).  While ``count <= _HIST_CAP`` the percentiles are
        exact; beyond that they are the exact nearest-rank quantiles of
        the most recent window (rank resolution ``1/_HIST_CAP``), which
        can differ from the all-time quantile only by however much the
        stream drifted outside that window — for latency SLOs the
        recent window is the quantity of interest anyway."""
        if not self.count:
            return None
        vals = sorted(self.samples)
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count, "min": self.vmin,
                "max": self.vmax,
                "p50": _percentile(vals, 50.0),
                "p90": _percentile(vals, 90.0),
                "p99": _percentile(vals, 99.0)}


_hists: Dict[str, _Hist] = {}
_hist_lock = threading.Lock()


def histogram(name: str, value, **attrs) -> None:
    """One observation of a distribution (a latency, a queue wait).

    Unlike counter/gauge, histograms ALWAYS aggregate in-process —
    cheaply (one list append under a lock) — because their consumers
    (serve.metrics TTFT/per-token percentiles) need summaries even when
    no JSONL sink is installed.  With a
    sink, each observation is additionally emitted as a
    ``{"kind": "hist", "name": ..., "value": ...}`` line."""
    v = float(value)
    with _hist_lock:
        h = _hists.get(name)
        if h is None:
            h = _hists[name] = _Hist()
        h.observe(v)
    if _sink is not None:
        attrs["value"] = v
        _emit("hist", name, attrs)


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over the retained samples."""
    i = min(len(sorted_vals) - 1, max(0, int(round(
        q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[i]


def histogram_summary(name: str) -> Optional[Dict[str, Any]]:
    """{count, sum, mean, min, max, p50, p90, p99} for ``name``, or
    None when nothing was observed.  count/sum/min/max are exact over
    every observation; percentiles come from the retained ring (the
    most recent ``_HIST_CAP`` samples)."""
    with _hist_lock:
        h = _hists.get(name)
        return h.summary() if h is not None else None


def reset_histograms(name: Optional[str] = None) -> None:
    """Drop one histogram's aggregates (or all of them) — a bench run
    isolating its own window calls this before the measured phase."""
    with _hist_lock:
        if name is None:
            _hists.clear()
        else:
            _hists.pop(name, None)


class _NullCtx:
    """Shared no-op context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


class _Span:
    __slots__ = ("name", "attrs", "_t0", "_ann", "_sid", "_parent",
                 "_tok")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._ann = None
        self._sid = None
        self._parent = None
        self._tok = None

    def __enter__(self):
        if _annotate:
            try:
                import torch
                self._ann = torch.profiler.record_function(self.name)
                self._ann.__enter__()
            except Exception:  # profiler optional; never break the step
                self._ann = None
        # inside an active trace, spans nest: this span takes a span id,
        # records the current parent, and becomes the parent for any
        # span opened within its extent (contextvar push, popped on
        # exit) — no id threading through call signatures
        ctx = trace.current()
        if ctx is not None:
            self._parent = ctx[1]
            self._sid = trace.new_span_id()
            self._tok = trace._push_span(self._sid)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        trace._pop_span(self._tok)
        if self._ann is not None:
            with contextlib.suppress(Exception):
                self._ann.__exit__(exc_type, exc, tb)
        attrs = self.attrs
        attrs["dur_ms"] = round(dur * 1e3, 3)
        if self._sid is not None:
            attrs["span"] = self._sid
            if self._parent is not None:
                attrs["parent"] = self._parent
        if exc_type is not None:
            attrs["error"] = exc_type.__name__
        _emit("span", self.name, attrs)
        return False


def span(name: str, **attrs):
    """Context manager timing a host-side region.

        with events.span("graph.compile", graph="llama.train"):
            graph.capture(step, stream)

    Emits ``{"kind": "span", "name": ..., "dur_ms": ...}`` to the sink
    and (with SINGA_OBS_XPROF=1) annotates the profiler timeline.  Returns
    a shared no-op context when telemetry is disabled."""
    if _sink is None and not _annotate:
        return _NULL
    return _Span(name, attrs)


#: the reference package's second name for span()
trace_span = span

_init_from_env()
