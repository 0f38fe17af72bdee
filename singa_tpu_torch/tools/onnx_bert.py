"""BERT through the ONNX path: the port's counterpart of the JAX
package's ``examples/onnx/bert.py``.

    python -m singa_tpu_torch.tools.onnx_bert       # self-exported round trip
    python -m singa_tpu_torch.tools.onnx_bert --onnx bert.onnx --compile
    python -m singa_tpu_torch.tools.onnx_bert --device cpu --finetune 3

With ``--onnx PATH`` the file is imported; otherwise a BERT of the
model zoo (seed 0, ``--layers/--dim/--heads/--vocab``) is exported with
``sonnx.to_onnx``, re-imported with ``sonnx.prepare``, and the import's
encoder output must equal the native model's within the reference's
absolute 1e-2: the path an official file takes.  ``--compile`` runs the
import as a captured eval step (a CUDA graph on the card from its third
call); ``--finetune N`` trains the import for N steps.  Both models
compute in f32 on either device, so that the absolute limit means on
the card what it means on the CPU.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import autograd, models, opt, sonnx
from .. import device as device_mod

__all__ = ["ROUND_TRIP_ATOL", "build_parser", "onnx_device", "build",
           "run", "main"]

#: the reference's limit on |import - native|
ROUND_TRIP_ATOL = 1e-2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BERT via sonnx")
    p.add_argument("--onnx", default="", help="path to a BERT .onnx file")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--layers", type=int, default=2, help="(self-export mode)")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--compile", action="store_true",
                   help="run the imported graph as one captured step")
    p.add_argument("--finetune", type=int, default=0, metavar="STEPS",
                   help="fine-tune the IMPORTED model for N steps "
                        "(training-capable import: the reimported graph "
                        "trains through the captured executor)")
    return p


def onnx_device(kind: str):
    """The device of `kind`, computing in f32 (see the module's
    docstring)."""
    dev = device_mod.create_device(kind)
    dev.default_dtype = torch.float32
    return dev


def _sync(dev) -> None:
    if dev.torch_device.type == "cuda":
        torch.cuda.synchronize(dev.torch_device)


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """The ids and, without ``--onnx``, the native BERT from seed 0 (or
    with `params` carried in by name): (native or None, ids as numpy)."""
    ids = np.random.RandomState(0).randint(
        0, args.vocab, (args.batch, args.seq)).astype(np.int64)
    if args.onnx:
        return None, ids
    cfg = models.BERTConfig(vocab_size=args.vocab, dim=args.dim,
                            num_heads=args.heads, num_layers=args.layers,
                            max_position=max(128, args.seq), dropout=0.0)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    native = models.BERT(cfg, device=device, generator=gen)
    if params is not None:
        models.load_reference_params(native, params)
    return native, ids


def run(args, device, native, ids: np.ndarray) -> Dict:
    """Export (or load), import, run and check; then `--finetune`: what
    it printed."""
    t_ids = torch.as_tensor(ids, device=device.torch_device)
    out = {}
    ref = None
    if args.onnx:
        model_proto = sonnx.load(args.onnx)
    else:
        with torch.no_grad():
            hidden, _pooled = native(t_ids)
        ref = hidden.float().cpu().numpy()
        print("exporting BERT to ONNX via sonnx.to_onnx ...", flush=True)
        model_proto = sonnx.to_onnx(native, [t_ids])
        out["nodes"] = len(model_proto.graph.node)
        out["initializers"] = len(model_proto.graph.initializer)
        print(f"  graph: {out['nodes']} nodes, {out['initializers']} "
              f"initializers", flush=True)

    print("importing with sonnx.prepare ...", flush=True)
    rep = sonnx.prepare(model_proto, device=device)
    if args.compile:
        rep.compile([t_ids], is_train=False, use_graph=True)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = rep.run([t_ids])
    _sync(device)
    lat = time.perf_counter() - t0
    got = outs[0].float().cpu().numpy()
    out.update(shape=list(got.shape), latency_ms=lat * 1e3)
    print(f"encoder output shape {got.shape}  "
          f"first-call latency {lat * 1e3:.1f} ms", flush=True)
    if ref is not None:
        err = float(np.max(np.abs(got - ref)))
        out["max_abs_diff"] = err
        print(f"import vs native max |diff| = {err:.2e}", flush=True)
        if not err < ROUND_TRIP_ATOL:
            raise AssertionError("sonnx round-trip mismatch")
        print("round-trip OK", flush=True)

    if args.finetune:
        rep.set_optimizer(opt.AdamW(lr=3e-4))
        rep.set_loss(lambda outs, y: autograd.mse_loss(
            outs[0] if isinstance(outs, (list, tuple)) else outs, y))
        target = torch.zeros(got.shape, dtype=torch.float32,
                             device=device.torch_device)
        rep.compile([t_ids], is_train=True, use_graph=True)
        out["finetune_losses"] = []
        for step in range(args.finetune):
            _, loss = rep.train_step(t_ids, target)
            out["finetune_losses"].append(loss.item())
            print(f"finetune step {step}: loss {loss.item():.4f}",
                  flush=True)
    out["device"] = str(device.torch_device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    dev = onnx_device(args.device)
    native, ids = build(args, dev)
    return run(args, dev, native, ids)


if __name__ == "__main__":
    main()
