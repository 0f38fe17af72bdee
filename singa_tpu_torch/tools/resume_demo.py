"""Crash-consistent training in one runnable file: the port's counterpart
of the JAX package's ``examples/mlp/resume_demo.py``.

    python -m singa_tpu_torch.tools.resume_demo --steps 60 --crash-at 25
    # ... trains, checkpoints every --save-every, dies hard at step 25
    python -m singa_tpu_torch.tools.resume_demo --steps 60
    # ... resumes from the newest commit and finishes the run

An MLP on 512 synthetic 64-feature blobs (10 classes), Adam 1e-3,
trained through ``train.TrainRunner`` with an
``AsyncCheckpointManager`` (keep the last 3 commits and every 20th).
``--crash-at`` ends the process with ``os._exit(1)`` after that step: no
cleanup, no final save.  The rerun resumes from the newest intact commit
and its trajectory is the uninterrupted run's, bitwise.  Ctrl-C or
SIGTERM checkpoints and exits cleanly (the preemption path).
``--record`` appends the ``train_run`` record to
``runs/torch/records.jsonl``.  ``python -m
singa_tpu_torch.tools.ckpt_fsck <ckpt-dir>`` audits the directory
afterwards.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import device as device_mod
from .. import models, opt, tensor
from ..train import AsyncCheckpointManager, TrainRunner
from ..utils.data import DataLoader, synthetic_dataset

__all__ = ["RECORD_STORE", "build_parser", "build", "run", "main"]

RECORD_STORE = os.path.join("runs", "torch", "records.jsonl")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--steps", type=int, default=60, help="total run length")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--save-every", type=int, default=5)
    p.add_argument("--ckpt-dir", default="ckpts_resume_demo")
    p.add_argument("--crash-at", type=int, default=None,
                   help="simulate a hard kill (os._exit) after this step")
    p.add_argument("--record", action="store_true",
                   help="append the train_run record to "
                        "runs/torch/records.jsonl")
    return p


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """The data loader and the compiled MLP (seed 0, or `params` carried
    in by name) with its optimizer: (model, loader)."""
    np.random.seed(0)
    tensor.set_seed(0)
    x, y = synthetic_dataset("blobs", n=512, classes=10, shape=(64,))
    loader = DataLoader(x, y, batch_size=args.batch_size, seed=1,
                        drop_last=True)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    m = models.MLP(perceptron_size=(64,), num_classes=10, input_shape=(64,),
                   device=device, generator=gen)
    if params is not None:
        models.load_reference_params(m, params)
    m.set_optimizer(opt.Adam(lr=1e-3))
    m.compile([x[:args.batch_size]], is_train=True, use_graph=True)
    return m, loader


def run(args, m, loader) -> Dict:
    """The run to `args.steps` through TrainRunner, resuming from the
    newest commit in `args.ckpt_dir`: what it printed."""
    losses = []

    def on_step(step, outs):
        losses.append(outs[1].item())
        if step % 10 == 0:
            print(f"step {step:4d}  loss {losses[-1]:.4f}", flush=True)
        if args.crash_at is not None and step == args.crash_at:
            print(f"*** simulating hard crash (kill -9) at step {step} — "
                  f"rerun without --crash-at to resume", flush=True)
            os._exit(1)   # no cleanup, no final save: the crash case

    runner = TrainRunner(
        m, loader, total_steps=args.steps,
        ckpt=AsyncCheckpointManager(args.ckpt_dir, keep_last=3,
                                    keep_every=20,
                                    save_every=args.save_every),
        step_timeout=300.0, on_step=on_step,
        record_store=RECORD_STORE if args.record else None,
        on_fatal=lambda msg: (_ for _ in ()).throw(SystemExit(msg)))
    with runner:
        res = runner.run()
    resumed = (f"resumed from step {res.resumed_from}"
               if res.resumed_from >= 0 else "fresh start")
    final = losses[-1] if losses else float("nan")
    print(f"{res.outcome}: {res.steps}/{args.steps} steps ({resumed}), "
          f"{res.ckpt_count} checkpoint(s), {res.wall_s:.2f}s wall; "
          f"final loss {final:.4f}")
    print(f"checkpoints in {args.ckpt_dir}/ — audit with: "
          f"python -m singa_tpu_torch.tools.ckpt_fsck {args.ckpt_dir}",
          flush=True)
    return {"outcome": res.outcome, "steps": res.steps,
            "resumed_from": res.resumed_from, "ckpt_count": res.ckpt_count,
            "wall_s": res.wall_s, "losses": losses, "final_loss": final,
            "device": str(m.device.torch_device)}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    m, loader = build(args, device_mod.create_device(args.device))
    return run(args, m, loader)


if __name__ == "__main__":
    main()
