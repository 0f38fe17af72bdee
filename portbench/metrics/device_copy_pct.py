"""The share of the traced device time spent in copy, cast, gather,
index and scatter kernels and memcpys (harness/trace.py's frozen
kernel kinds), in %."""

from harness import flops, trace


def read(rec):
    t = rec.get("trace")
    if not t or not t["device_s"]:
        return None
    copy = sum(t["by_kind"].get(k, 0.0) for k in trace.COPY_KINDS)
    return flops.pct(copy / t["device_s"])
