"""The control of a cell's correctness check, read on the card at the
cell's own size: the reference in the program's place, its products in
float8 e4m3 (the precision below the program's bf16), compared as the
benchmark compares the program.  Not part of a benchmark run:

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 20]

Training cells: per seed, the reference's first three steps in f32 and
in e4m3 from the same weights and batches, and the numbers of
``drivers/train.compare`` between them.  Serving cells: per seed, a
short run of the program at the cell's load, its numbers, and the gaps,
at each position of the served requests, of the token the e4m3
reference puts first; beside them the witness, the same gaps of the
reference with bf16 products, and in an MoE cell the share of tokens
and layers whose experts it chooses otherwise.  One JSON line a seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    import torch
    from harness import spec
    root = Path.cwd()
    sys.path.insert(0, str(root))
    cell = spec.load_cell(args.workload, root)
    drv = spec.driver(cell)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.driver == "train":
            feed = drv.batches(cell, seed, 3, torch.device(dev))
            ref = drv.reference(cell, seed, feed, dev)
            low = drv.reference(cell, seed, feed, dev, fp8=True)
            cmp = drv.compare(low, ref)
            out = {"control": cmp["numbers"],
                   "grad_norm_gap_by_step": cmp["grad_norm_gap_by_step"],
                   "ref_losses": ref["losses"],
                   "control_losses": low["losses"]}
        else:
            res = drv.run(cell, seed, args.seconds, False, dev, {}, t0,
                          control=True)
            out = {"program": res["numbers"],
                   "control": res["control_gaps"],
                   "bf16_witness": res["bf16_gaps"],
                   "bf16_route_flips": res.get("bf16_route_flips"),
                   "end_to_end": res["end_to_end"],
                   "detail": res["detail"]}
            if dev == "cuda":
                torch.cuda.empty_cache()
        out.update({"workload": args.workload, "seed": seed,
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
