"""The share of the traced window in which no operation ran on the
card (the union of the profiler's device intervals), in %."""

from harness import flops


def read(rec):
    t = rec.get("trace")
    if not t or not t["window_s"] or not t["kernels"]:
        return None
    return flops.pct(1.0 - t["busy_s"] / t["window_s"])
