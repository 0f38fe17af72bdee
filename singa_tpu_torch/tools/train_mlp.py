"""Train an MLP on MNIST: the port's counterpart of the JAX package's
``examples/mlp/train.py`` (the reference's smoke workload) with the
options of ``examples/common.py``'s ``base_parser``.

    python -m singa_tpu_torch.tools.train_mlp --epochs 1
    python -m singa_tpu_torch.tools.train_mlp --device cpu --no-graph

The model is ``models.MLP(perceptron_size=--hidden)`` over the dataset's
images, trained by ``train_cnn.train_classifier`` (SGD with momentum
0.9 and weight decay 1e-4; a CUDA graph on the card from the third step
unless ``--no-graph``) on ``<data-dir>/<dataset>.npz`` where it exists,
else the synthetic set of its shape.  ``--dist`` trains data-parallel
over the processes ``torchrun`` describes, as ``train_cnn --dist``.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import models
from .train_cnn import dataset_arrays, setup_device, train_classifier

__all__ = ["build_parser", "build", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="MLP on MNIST (reference examples/mlp)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--data-dir", default="", help="dir with <dataset>.npz")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--graph", action=argparse.BooleanOptionalAction,
                   default=True, help="captured graph mode vs eager")
    p.add_argument("--dist", action="store_true",
                   help="data-parallel over the processes torchrun or "
                        "SINGA_* describe (DistOpt; NCCL on the card)")
    p.add_argument("--bf16", action="store_true", help="bfloat16 inputs")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--hidden", type=int, nargs="+", default=[100])
    p.add_argument("--dataset", default="mnist")
    return p


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """The dataset's arrays and the MLP from seed 0 (or with `params`
    carried in by name): (model, (x_train, y_train, x_test, y_test))."""
    xt, yt, xe, ye, classes, shape = dataset_arrays(args.dataset,
                                                    args.data_dir)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    m = models.MLP(perceptron_size=tuple(args.hidden), num_classes=classes,
                   input_shape=shape, device=device, generator=gen)
    if params is not None:
        models.load_reference_params(m, params)
    return m, (xt, yt, xe, ye)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    # what train_classifier reads beyond the reference's options
    args.model, args.seed = "mlp", 0
    m, data = build(args, setup_device(args))
    return train_classifier(m, args, *data)


if __name__ == "__main__":
    main()
