"""Step profiling, ported from ``singa_tpu/utils/profiler.py``.

* `StepProfiler` — wall-clock per step with warmup discard; feeds MFU
  from the captured graph's counted FLOPs (``graph.CapturedGraph.
  flops``: the step's aten ops, not an analytic formula) when a model
  is attached.
* `device_trace` — context manager around ``torch.profiler`` with the
  CPU and (where a card is present) CUDA activities; on exit it writes
  a Chrome trace into ``logdir`` (chrome://tracing, Perfetto).
* `profile_model` — one-call summary: counted FLOPs, bytes accessed,
  arithmetic intensity, step time, MFU.

MFU needs the card's peak (``metrics.peak_flops``), which is known
only for the cards in its table: on the CPU, or on an unknown card,
the summaries leave ``mfu`` (and the achieved rate) out instead of
dividing by a guess.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..obs import record as obs_record
from .metrics import peak_flops
from .timing import _block

__all__ = ["StepProfiler", "device_trace", "profile_model"]

_trace_seq = itertools.count()


def _peak(device_kind: Optional[str]) -> Optional[float]:
    try:
        return peak_flops(device_kind)
    except ValueError:
        return None


def _rates(out: Dict, flops: float, step_s: float,
           device_kind: Optional[str]) -> None:
    """Add the achieved rate and MFU of `flops` a step to `out`."""
    peak = _peak(device_kind)
    if not flops or step_s <= 0 or peak is None:
        return
    achieved = flops / step_s
    out["compiled_gflops_per_step"] = round(flops / 1e9, 6)
    out["achieved_tflops"] = round(achieved / 1e12, 6)
    out["mfu"] = round(achieved / peak, 8)


class StepProfiler:
    """Accumulate per-step wall time; first `warmup` steps discarded
    (eager record, warm-up and capture on the card).

        prof = StepProfiler(warmup=3)
        for ...:
            with prof.step():
                model.train_step(x, y)
        print(prof.summary(model))

    A step's wall time is the host's: fence inside the block (or time
    with `utils.timing`) where the step is a replay that returns before
    the card has run it."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._n = 0

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)
            # mirror into the structured telemetry stream when enabled
            from ..obs import events as obs_events
            obs_events.gauge("profiler.step_ms", round(dt * 1e3, 3),
                             n=self._n)

    @property
    def mean_s(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50_s(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0

    def summary(self, model=None, device_kind: Optional[str] = None) -> Dict:
        out = {
            "steps_timed": len(self.times),
            "step_time_ms": round(self.mean_s * 1e3, 3),
            "step_time_p50_ms": round(self.p50_s * 1e3, 3),
        }
        g = getattr(model, "graph", None) if model is not None else None
        if g is not None:
            _rates(out, g.flops(), self.mean_s, device_kind)
        return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    where a card is present) and write a Chrome trace
    ``trace.<pid>.<n>.json`` into `logdir` on exit; yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace.{os.getpid()}.{next(_trace_seq)}.json"))


def profile_model(model, batch, steps: int = 10, warmup: int = 2,
                  device_kind: Optional[str] = None,
                  train: bool = True) -> Dict:
    """Run `steps` steps (train_step, or the eval forward with
    train=False), each fenced, after `warmup` untimed ones, and return
    the cost/latency summary (model compiled with use_graph=True; on
    the card give `warmup` >= 3 so the timed steps are replays)."""
    run = model.train_step if train else (lambda *b: model.eval()(b[0]))
    prof = StepProfiler(warmup=warmup)
    for _ in range(warmup + max(1, steps)):
        with prof.step():
            _block(run(*batch))
    # the cost must come from the graph of the mode we timed — a model
    # that ran train_step earlier also holds the (3x larger) train graph
    g = model.get_graph("train" if train else "eval")
    s = prof.summary(None, device_kind)
    ca = g.cost_analysis() if g is not None else {}
    flops = float(ca.get("flops", 0.0))
    dev = getattr(getattr(model, "device", None), "torch_device", None)
    if device_kind is None and dev is not None:
        device_kind = obs_record.device_kind(dev)[1]
    _rates(s, flops, prof.mean_s, device_kind)
    if "bytes accessed" in ca and s.get("step_time_ms"):
        ba = float(ca["bytes accessed"])
        s["bytes_accessed_per_step"] = int(ba)
        if flops and ba:
            s["arithmetic_intensity"] = round(flops / ba, 2)
    return s
