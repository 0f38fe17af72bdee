"""Run one cell of the port's benchmark once, in this process, on the
card(s) of this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic
mix, its driver, its per-layer metrics and its limits are found by name
(``harness/spec.py``).  The last line of standard output is the result:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; then ``checks``,
each compared number beside its limit, which also close standard error.
Without enough cards, without the program, or with JAX or the JAX
package loaded once the window has closed, it prints no result and
exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def result_line(cell, res: dict, traced: bool, device: dict) -> dict:
    from harness import judge
    correct, checks = judge.judge(res["numbers"],
                                  cell.limits.get("numbers", {}))
    if traced:
        values = res["per_layer"]
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = res["end_to_end"]
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = {n: {"value": finite(values[n]), "unit": u}
               for n, u in units.items() if n in values}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if traced and res.get("trace"):
        line["breakdown"] = res["trace"]["breakdown"]
    line["checks"] = [{"name": n, "value": finite(v), "limit": lim}
                      for n, v, lim in checks]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    root = Path.cwd()
    import torch
    from harness import spec

    cell = spec.load_cell(args.workload, root)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    try:
        import singa_tpu_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"portbench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    drv = spec.driver(cell)
    readers = spec.metric_readers(cell) if args.trace else {}
    res = drv.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                  readers, T_START)
    bad = spec.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: no result", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace and res.get("trace"):
        device["busy_s"] = res["trace"]["busy_s"]
        device["window_s"] = res["trace"]["window_s"]
    line = result_line(cell, res, bool(args.trace), device)
    print(json.dumps({"detail": res.get("detail"),
                      "numbers": res["numbers"]}, default=str),
          file=sys.stderr)
    for c in line["checks"]:
        print(f"check {c['name']} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
