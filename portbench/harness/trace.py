"""The traced run's reading of the device: torch.profiler over CPU and
CUDA, the benchmark's own host spans, busy and idle time, kernel time by
kind, and the breakdown the result line carries.

`kernel_kind` and the profiler's warm-up are frozen copies of the
program's ``chip_smoke._kernel_kind`` and ``_profiled`` (its
``PROFILE_WARMUP`` spin kernels, run and finished under the profiler
before the traced work, keep the profiler from dropping the first
records of a session); the copy adds the gather, index and scatter
kernels and the profiler's memcpy records as kinds of their own.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

PROFILE_WARMUP = 512
SPAN_PREFIX = "pb."
LAYOUT_KERNELS = ("nchwtonhwc", "nhwctonchw", "transpose")
COPY_KINDS = ("copy_or_cast", "gather_index", "memcpy")


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind in ("flash_bwd_dq", "flash_bwd_dkv", "flash_fwd"):
        if kind + "_" in low:
            return kind
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy"
    if any(s in low for s in LAYOUT_KERNELS):
        return "layout_transpose"
    if any(s in low for s in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "nvjet", "xmma", "gemv")):
        return "matmul"
    if "copy" in low:
        return "copy_or_cast"
    if any(s in low for s in ("gather", "index", "scatter")):
        return "gather_index"
    return "other"


def span(name: str):
    """A host span of the benchmark's (recorded only under the profiler)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Profiles what runs between `start()` and `stop()`; `read()` then
    gives the device's busy seconds, the window, time by kind and name,
    and the longest idle gaps labelled by the host span around them."""

    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        self._t0 = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            for _ in range(PROFILE_WARMUP):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)

    def read(self) -> dict:
        from torch.autograd import DeviceType
        dev, spans = [], []
        warm_end = None
        for e in self.prof.events():
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                if e.device_type != DeviceType.CUDA:
                    spans.append((tr.start, tr.end,
                                  e.name[len(SPAN_PREFIX):]))
                continue                  # its mirror on the device track
            if e.device_type == DeviceType.CUDA:
                if "spin_kernel" in e.name:
                    warm_end = max(warm_end or 0.0, tr.end)
                    continue
                dev.append((tr.start, tr.end, e.name))
        if warm_end is not None:
            dev = [d for d in dev if d[0] >= warm_end]
        return summarise(dev, spans, self.window_s)


def summarise(dev: List[tuple], spans: List[tuple], window_s: float) -> dict:
    """Busy seconds (the union of device intervals, in µs), time by kind
    and by name, and the idle gaps of the union labelled by the
    innermost host span that covers each gap's middle."""
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    by_kind: Dict[str, float] = {}
    for n, t in by_name.items():
        k = kernel_kind(n)
        by_kind[k] = by_kind.get(k, 0.0) + t
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in sorted(dev):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    labelled = []
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (gs + ge)
        inside = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        label = min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside \
            else "outside the benchmark's spans"
        labelled.append([label, (ge - gs) * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": window_s,
            "device_s": sum(by_name.values()), "by_kind": by_kind,
            "kernels": len(dev),
            "breakdown": {
                "device_ops": [[f"{kernel_kind(n)}: {n[:120]}", t]
                               for n, t in top],
                "idle_gaps": labelled}}


def cuda_time_s(fn, reps: int = 10) -> float:
    """Seconds per call of fn() replayed as a captured CUDA graph (warmed
    up on a side stream first), timed with CUDA events over `reps`."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e-3 / reps
