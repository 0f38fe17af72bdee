"""Find the highest rate an open-loop serving cell sustains, once, on the
card: one engine, the cell's traffic at each rate in turn.  Not part of
a benchmark run; the rate chosen goes into the mix file as a number:

    python3 portbench/sweep.py --workload <cell> --rates 3,5,7 [--seconds 30]

Per rate, one JSON line: TTFT p50 / p95 over the window's requests
timed from when each was due, the p95 of the first and of the second
half of them (a backlog that grows shows as a second half far slower),
the inter-token p95, the tokens per second and the queue at the close.
"""

import argparse
import copy
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch
    from harness import spec
    root = Path.cwd()
    sys.path.insert(0, str(root))
    cell = spec.load_cell(args.workload, root)
    drv = spec.driver(cell)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    m, eng = drv.build(cell, args.seed, dev)
    for rate in (float(r) for r in args.rates.split(",")):
        c = copy.copy(cell)
        c.mix = dict(cell.mix, rate_rps=rate, drain_s=30)
        rec = {"device": dev}
        win = drv.open_window(c, eng, args.seed, args.seconds, False, rec)
        w = win["window"]
        ttft = [(r.times[0] - r.due) * 1e3 if drv.served(r) and r.times
                else math.inf for r in w]
        half = len(ttft) // 2
        itl = [(b - a) * 1e3 for r in w if drv.served(r)
               for a, b in zip(r.times, r.times[1:])]
        base = win["base"]
        toks = sum(1 for r in win["requests"] for t in r.times
                   if base <= t < base + args.seconds)
        print(json.dumps({
            "rate_rps": rate, "requests": len(w),
            "ttft_p50_ms": sorted(ttft)[len(ttft) // 2],
            "ttft_p95_ms": drv.p95(ttft),
            "ttft_p95_first_half_ms": drv.p95(ttft[:half]),
            "ttft_p95_second_half_ms": drv.p95(ttft[half:]),
            "itl_p95_ms": drv.p95(itl), "tokens_per_s": toks / args.seconds,
            "unfinished": sum(1 for r in w if not r.done),
            "queue_at_close": eng.pending,
            "engine_step_ms": 1e3 * sum(rec["steps"]) / max(1, len(
                rec["steps"])),
            "wall_s": time.perf_counter() - base}, default=str), flush=True)
        while eng.pending:
            eng.step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
