"""Train a model of the vision zoo: the port's counterpart of the JAX
package's ``examples/cnn/train.py`` with the helpers of
``examples/common.py`` it runs (``dataset_arrays``, ``train_classifier``,
``evaluate``).

    python -m singa_tpu_torch.tools.train_cnn --model resnet50 \\
        --dataset imagenet --batch-size 256 --epochs 1 --lr 0.1
    python -m singa_tpu_torch.tools.train_cnn --model cnn --dataset mnist \\
        --device cpu

Each epoch trains through ``compile([x], is_train=True,
use_graph=True)`` and ``train_step`` (a CUDA graph on the card from the
third step), then evaluates the test split through the captured eval
step, and prints the loss, the accuracies and images a second.  Data is
``<data-dir>/<dataset>.npz`` where it exists, else a synthetic set of
the dataset's shape made from ``--seed``.  Runs on the card unless
``--device cpu``.

``--dist`` trains data-parallel (the reference's ``--dist``): it joins
the process group that ``torchrun`` or the ``SINGA_*`` variables
describe (``parallel.init_distributed``: NCCL on the card, gloo with
``--device cpu``), sets the data mesh, wraps the optimizer in
``DistOpt`` and gives each rank its shard of the training set
(``DataLoader(rank=, world_size=)``) in batches of B/W.  The step feeds
every rank the global batch and takes rank r's rows, so each rank puts
its own batch at rows [r·B/W, (r+1)·B/W) of a B-row batch.  Without a
launcher a world of 1 runs with no group.

    torchrun --nproc_per_node=1 -m singa_tpu_torch.tools.train_cnn \
        --model resnet50 --dataset imagenet --batch-size 256 --dist
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import device as device_mod
from .. import models, opt, parallel
from ..utils import metrics
from ..utils.data import DataLoader, synthetic_dataset

__all__ = ["MODELS", "DATASETS", "dataset_arrays", "build_model",
           "train_classifier", "evaluate", "setup_device", "main"]

#: the reference's model table; each takes (classes, (H, W, C), kwargs)
MODELS = {
    "mlp": lambda c, s, kw: models.MLP(num_classes=c, input_shape=s, **kw),
    "cnn": lambda c, s, kw: models.CNN(num_classes=c, input_shape=s, **kw),
    "lenet": lambda c, s, kw: models.LeNet5(num_classes=c, input_shape=s,
                                            **kw),
    "alexnet": lambda c, s, kw: models.AlexNet(num_classes=c, input_shape=s,
                                               **kw),
    **{name: (lambda c, s, kw, f=getattr(models, name):
              f(num_classes=c, in_channels=s[2], **kw))
       for name in ("resnet18", "resnet34", "resnet50", "vgg11", "vgg13",
                    "vgg16")},
}

#: image shape (H, W, C) and classes of each dataset
DATASETS = {
    "mnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "cifar100": ((32, 32, 3), 100),
    "imagenet": ((224, 224, 3), 1000),
}


def dataset_arrays(name: str, data_dir: str = "", n_synth: int = 2048,
                   seed: int = 0):
    """(x_train, y_train, x_test, y_test, num_classes, input_shape).

    Real data: `<data_dir>/<name>.npz` with x_train/y_train/x_test/
    y_test (NHWC images, float in [0, 1] or uint8); otherwise a
    synthetic set of the same shapes, `n_synth` training images and
    max(256, n_synth // 8) test images."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name}; options: "
                         f"{sorted(DATASETS)}")
    shape, classes = DATASETS[name]
    path = os.path.join(data_dir or ".", f"{name}.npz")
    if data_dir and os.path.exists(path):
        with np.load(path) as z:
            xt, xe = (z[k].astype(np.float32) for k in ("x_train", "x_test"))
            yt, ye = (z[k].astype(np.int32) for k in ("y_train", "y_test"))
        xt, xe = (a / 255.0 if a.max() > 2.0 else a for a in (xt, xe))
        if xt.ndim == 3:
            xt, xe = xt[..., None], xe[..., None]
        return xt, yt, xe, ye, classes, shape
    n_test = max(256, n_synth // 8)
    x, y = synthetic_dataset("images", n=n_synth + n_test, classes=classes,
                             shape=shape, seed=seed)
    return (x[:n_synth], y[:n_synth], x[n_synth:], y[n_synth:], classes,
            shape)


def build_model(name: str, classes: int, shape, dev, seed: int = 0):
    gen = torch.Generator(dev.torch_device).manual_seed(seed)
    return MODELS[name](classes, tuple(shape),
                        dict(device=dev, generator=gen))


def evaluate(model, x_test, y_test, batch_size: int) -> float:
    """Test accuracy over whole batches, through the eval step (captured
    on the card from its third batch)."""
    model.eval()
    dev = model.device.torch_device
    acc = metrics.Accuracy()
    for s in range(0, len(x_test) - batch_size + 1, batch_size):
        out = model(torch.from_numpy(x_test[s:s + batch_size]).to(dev))
        acc.update(out.detach().float().cpu().numpy(),
                   y_test[s:s + batch_size])
    return acc.value


def train_classifier(model, args, x_train, y_train, x_test, y_test
                     ) -> Dict:
    """The reference's training loop: SGD(lr, momentum 0.9, weight decay
    1e-4), compile once (in graph mode unless `args.graph` is False),
    `train_step` a batch (bf16 images where `args.bf16`), evaluate each
    epoch.  Returns what it printed."""
    dev = model.device.torch_device
    dtype = torch.bfloat16 if getattr(args, "bf16", False) else None
    base = opt.SGD(lr=args.lr, momentum=0.9, weight_decay=1e-4)
    model.set_optimizer(opt.DistOpt(base) if args.dist else base)
    model.compile([x_train[:args.batch_size]], is_train=True,
                  use_graph=getattr(args, "graph", True))
    world = parallel.mesh.process_count() if args.dist else 1
    rank = parallel.mesh.process_index() if args.dist else 0
    if args.batch_size % world:
        raise ValueError(f"--batch-size {args.batch_size} does not split "
                         f"over {world} ranks")
    local = args.batch_size // world
    loader = DataLoader(x_train, y_train, batch_size=local, seed=args.seed,
                        drop_last=True, rank=rank, world_size=world)
    rows = slice(rank * local, (rank + 1) * local)
    epochs = []
    for epoch in range(args.epochs):
        model.train()
        acc, loss_m, losses = metrics.Accuracy(), metrics.MeanMeter(), []
        tput = metrics.Throughput()
        tput.start()
        for step, (xb, yb) in enumerate(loader):
            out, loss = model.train_step(
                torch.from_numpy(_at_rows(xb, rows, world)).to(dev, dtype),
                torch.from_numpy(_at_rows(yb, rows, world)).to(dev))
            losses.append(loss.item())
            loss_m.update(losses[-1])
            acc.update(out[rows].detach().float().cpu().numpy(), yb)
            tput.update(len(xb) * world)
            if args.log_every and step % args.log_every == 0:
                print(f"epoch {epoch} step {step:4d} loss {loss_m.value:.4f}"
                      f" acc {acc.value:.4f}", flush=True)
        imgs = tput.value
        test_acc = evaluate(model, x_test, y_test, args.batch_size)
        print(f"epoch {epoch}: train loss {loss_m.value:.4f} acc "
              f"{acc.value:.4f}  test acc {test_acc:.4f}  ({imgs:.0f} "
              f"imgs/s)", flush=True)
        epochs.append({"losses": losses, "train_loss": loss_m.value,
                       "train_acc": acc.value, "test_acc": test_acc,
                       "images_per_s": imgs})
    train_graph, graph = model.get_graph("train"), model.get_graph("eval")
    return {"model": args.model, "dataset": args.dataset,
            "batch_size": args.batch_size, "world": world, "rank": rank,
            "steps_per_epoch": len(loader),
            "epochs": epochs, "device": str(dev),
            "train_captured": (train_graph is not None
                               and train_graph.graph is not None),
            "eval_captured": graph is not None and graph.graph is not None}


def _at_rows(a: np.ndarray, rows: slice, world: int) -> np.ndarray:
    """A batch of world·len(a) rows holding `a` at `rows` (zeros
    elsewhere, which this rank's step never reads)."""
    if world == 1:
        return a
    out = np.zeros((len(a) * world,) + a.shape[1:], a.dtype)
    out[rows] = a
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train a model of the vision zoo (the port's "
                    "examples/cnn)")
    p.add_argument("--model", default="cnn", choices=sorted(MODELS))
    p.add_argument("--dataset", default="mnist", choices=sorted(DATASETS))
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--data-dir", default="", help="dir with <dataset>.npz")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0,
                   help="synthetic data, weights and shuffling")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dist", action="store_true",
                   help="data-parallel over the processes torchrun or "
                        "SINGA_* describe (DistOpt; NCCL on the card)")
    return p


def setup_device(args):
    """The device of `args.device`; with `args.dist`, after joining the
    group and setting the data mesh (the rank's card on the card)."""
    cpu = args.device == "cpu"
    if args.dist:
        parallel.init_distributed(device="cpu" if cpu else None)
        parallel.set_mesh(parallel.data_parallel_mesh())
    if args.dist and parallel.distributed.is_initialized() and not cpu:
        return device_mod.get_default_device()    # this rank's card
    return device_mod.create_device(args.device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    xt, yt, xe, ye, classes, shape = dataset_arrays(
        args.dataset, args.data_dir, seed=args.seed)
    dev = setup_device(args)
    model = build_model(args.model, classes, shape, dev, args.seed)
    return train_classifier(model, args, xt, yt, xe, ye)


if __name__ == "__main__":
    main()
