"""train_mfu: the model FLOP (harness/flops.py's frozen formula: active
experts only, no recompute of the head) of the window's steps that ran
after the profiler stopped, over their time, against the card's bf16
peak, in %."""

from harness import flops


def read(rec):
    if rec.get("kind") != "train" or not rec.get("untraced"):
        return None
    steps, seconds = rec["untraced"]
    rate = rec["flops_per_step"] * steps / seconds
    return flops.pct(rate / flops.PEAK_FLOPS)
