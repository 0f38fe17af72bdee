"""Step timing, ported from ``singa_tpu/utils/timing.py``: two
measurements for two questions.

``windowed_steps`` — training throughput: windows of K back-to-back
steps with ONE fence at the window end, median over windows.  This is
how a real training loop runs (nothing fences per step).  On the card
it is the honest throughput number because a step returns before the
card has run it: a captured step's replay is enqueued asynchronously,
so the host's clock around one un-fenced call measures the enqueue,
and a fence after every step adds the host's launch and copy latency
to each step instead of hiding it behind the card's work.

``fenced_steps`` — per-step latency diagnostic: every step fenced
individually, median.  Includes the host's per-step overhead by
construction, and shows an outlier step as the max.

Both report medians: with windows, one disturbed window inflates one
sample and the median over >= 5 windows discards it.  The fence is
``torch.cuda.synchronize`` on the device of the result the step
returns; a result on the CPU needs none.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Optional

import torch

__all__ = ["windowed_steps", "fenced_steps"]


def _devices(x, out) -> None:
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _devices(v, out)


def _block(x) -> None:
    """Fence: wait until the card has run everything queued on the
    device of each CUDA tensor in `x` (a tensor, or tuples, lists and
    dicts of them); CPU results are ready when the step returns."""
    devices = set()
    _devices(x, devices)
    for d in devices:
        torch.cuda.synchronize(d)


def windowed_steps(step: Callable[[], object], *, windows: int = 6,
                   window_len: int = 8, warmup: int = 2,
                   budget_left: Optional[Callable[[], float]] = None,
                   min_budget_s: float = 30.0):
    """Median per-step seconds over `windows` windows of `window_len`
    back-to-back un-fenced steps (true fence at each window end only).

    `step()` runs one training/eval step and returns the object to
    fence on (e.g. the loss tensor, or the step's whole output).
    Returns ``(per_step_seconds, stats)`` where stats carries the raw
    window times and the derived per-step min/median/max in ms.

    The budget is consulted after every dispatch and at window ends —
    on a trip the current window is fenced immediately and kept only
    if no complete window exists (scaled by its actual step count).
    Honest limit: steps are asynchronous, so a fully-stalled window is
    only detected at its closing fence — worst case one window (~8 x
    the stall) is spent before the trip, vs one step under a
    per-step-fenced loop.  The median over windows keeps such a window
    out of the reported number either way."""
    out = None
    tripped = False
    for _ in range(warmup):
        out = step()
        if budget_left is not None and budget_left() < min_budget_s:
            tripped = True
            break
    if out is not None:
        _block(out)
    wtimes = []
    partial = None          # (seconds, steps) of an aborted window
    done_steps = 0
    for _ in range(windows):
        # honor the budget only once at least one window exists: the
        # caller must ALWAYS get a number, even if a slow warm-up
        # drained the budget
        if tripped and (wtimes or partial):
            break
        t0 = time.perf_counter()
        k = 0
        for _ in range(window_len):
            out = step()
            k += 1
            if budget_left is not None and budget_left() < min_budget_s:
                tripped = True
                break
        _block(out)
        dt = time.perf_counter() - t0
        done_steps += k
        if k == window_len:
            wtimes.append(dt)
        else:
            partial = (dt, k)
    if not wtimes and partial is not None and partial[1] > 0:
        wtimes = [partial[0] / partial[1] * window_len]
    if not wtimes:
        raise RuntimeError("budget exhausted before any timed window")
    wtimes.sort()
    med = statistics.median(wtimes)
    stats = {
        "method": "windowed",
        "window_len": window_len,
        "windows": len(wtimes),
        "n": done_steps,
        "window_ms": [round(t * 1e3, 1) for t in wtimes],
        "min": round(wtimes[0] / window_len * 1e3, 1),
        "median": round(med / window_len * 1e3, 1),
        "max": round(wtimes[-1] / window_len * 1e3, 1),
    }
    _emit_timing_gauge("timing.windowed.step_ms", stats)
    return med / window_len, stats


def fenced_steps(step: Callable[[], object], *, steps: int = 8,
                 warmup: int = 1,
                 budget_left: Optional[Callable[[], float]] = None,
                 min_budget_s: float = 30.0):
    """Median per-step seconds with EVERY step individually fenced
    (per-step latency).  Returns
    ``(per_step_seconds, stats)``."""
    out = None
    for _ in range(warmup):
        out = step()
    if out is not None:
        _block(out)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        _block(step())
        times.append(time.perf_counter() - t0)
        if budget_left is not None and budget_left() < min_budget_s:
            break
    times.sort()
    stats = {
        "method": "fenced",
        "n": len(times),
        "min": round(times[0] * 1e3, 1),
        "median": round(statistics.median(times) * 1e3, 1),
        "mean": round(sum(times) / len(times) * 1e3, 1),
        "max": round(times[-1] * 1e3, 1),
    }
    _emit_timing_gauge("timing.fenced.step_ms", stats)
    return statistics.median(times), stats


def _emit_timing_gauge(name: str, stats: dict) -> None:
    """Mirror a measurement's summary into the structured telemetry
    stream (obs.events) — no-op unless a sink is enabled."""
    from ..obs import events
    events.gauge(name, stats["median"], method=stats["method"],
                 n=stats["n"], min=stats["min"], max=stats["max"])
