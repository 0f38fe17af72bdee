"""GPT-2 through the ONNX path, then greedy generation: the port's
counterpart of the JAX package's ``examples/onnx/gpt2.py``.

    python -m singa_tpu_torch.tools.onnx_gpt2 --steps 8
    python -m singa_tpu_torch.tools.onnx_gpt2 --onnx gpt2.onnx
    python -m singa_tpu_torch.tools.onnx_gpt2 --device cpu --steps 4

Like ``onnx_bert``: imports ``--onnx PATH`` if given, else exports a
GPT-2 of the model zoo (seed 0) and re-imports it, and the import's
logits must equal the native model's within the reference's absolute
1e-2.  Generation then runs the native model's KV-cached ``generate()``
(a captured prefill and decode step on the card), whose first tokens
must equal greedy picks from the imported graph.  With ``--onnx`` (an
imported graph, no native weights) each token re-runs the fixed-length
imported graph.  Both models compute in f32 on either device (see
``onnx_bert``).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import models, sonnx
from .onnx_bert import ROUND_TRIP_ATOL, _sync, onnx_device

__all__ = ["build_parser", "build", "run", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GPT-2 via sonnx + generation")
    p.add_argument("--onnx", default="", help="path to a GPT-2 .onnx file")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1000)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--steps", type=int, default=8, help="tokens to generate")
    return p


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """The prompt (1, seq // 2) and, without ``--onnx``, the native GPT-2
    from seed 0 (or with `params` carried in by name): (native or None,
    prompt as numpy)."""
    prompt = np.random.RandomState(0).randint(
        0, args.vocab, (1, args.seq // 2)).astype(np.int64)
    if args.onnx:
        return None, prompt
    cfg = models.GPT2Config(vocab_size=args.vocab, dim=args.dim,
                            num_heads=args.heads, num_layers=args.layers,
                            max_position=max(64, args.seq), dropout=0.0)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    native = models.GPT2(cfg, device=device, generator=gen)
    if params is not None:
        models.load_reference_params(native, params)
    return native, prompt


def run(args, device, native, prompt: np.ndarray) -> Dict:
    """Export (or load), import, check the logits, generate: what it
    printed."""
    tdev = device.torch_device
    out = {}
    ref = None
    n = prompt.shape[1]
    ids = np.zeros((1, args.seq), np.int64)
    ids[0, :n] = prompt
    if args.onnx:
        model_proto = sonnx.load(args.onnx)
    else:
        with torch.no_grad():
            ref = native(torch.as_tensor(ids, device=tdev)).float() \
                .cpu().numpy()
        print("exporting GPT-2 to ONNX via sonnx.to_onnx ...", flush=True)
        model_proto = sonnx.to_onnx(native, [torch.as_tensor(ids,
                                                             device=tdev)])
        out["nodes"] = len(model_proto.graph.node)
        print(f"  graph: {out['nodes']} nodes", flush=True)

    rep = sonnx.prepare(model_proto, device=device)

    def logits_of(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            (lg,) = rep.run([torch.as_tensor(x, device=tdev)])
        return lg.float().cpu().numpy()

    if ref is not None:
        err = float(np.max(np.abs(logits_of(ids) - ref)))
        out["max_abs_diff"] = err
        print(f"import vs native max |diff| = {err:.2e}", flush=True)
        if not err < ROUND_TRIP_ATOL:
            raise AssertionError("sonnx round-trip mismatch")

    steps = min(args.steps, args.seq - n)
    if ref is not None:
        # native weights: KV-cached generate() — a prefill and one decode
        # step, captured on the card at the second call and replayed
        print(f"greedy generation (KV cache), {steps} tokens:", flush=True)
        gen = native.generate(prompt.astype(np.int32), steps)   # warm call
        _sync(device)
        t0 = time.perf_counter()
        gen = native.generate(prompt.astype(np.int32), steps)
        dt = time.perf_counter() - t0
        gen = gen[0, n:].tolist()
        # cross-check the first tokens against the imported-graph loop
        check = ids.copy()
        cn = n
        for _ in range(min(2, steps)):
            check[0, cn] = int(logits_of(check)[0, cn - 1].argmax())
            cn += 1
        out["checked_tokens"] = check[0, n:cn].tolist()
        if gen[:cn - n] != out["checked_tokens"]:
            raise AssertionError("KV-cached generation diverged from the "
                                 "sonnx-imported graph")
        print("generated ids:", gen, flush=True)
        print(f"{steps / dt:.2f} tok/s (decode cost independent of length)",
              flush=True)
    else:
        # imported graph only: fixed-length re-run per token
        print(f"greedy generation (imported graph), {steps} tokens:",
              flush=True)
        t0 = time.perf_counter()
        for _ in range(steps):
            ids[0, n] = int(logits_of(ids)[0, n - 1].argmax())
            n += 1
        dt = time.perf_counter() - t0
        gen = ids[0, prompt.shape[1]:n].tolist()
        print("generated ids:", gen, flush=True)
        print(f"{(n - prompt.shape[1]) / dt:.2f} tok/s", flush=True)
    out.update(generated=gen, tokens_per_s=steps / dt,
               device=str(tdev))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = build_parser().parse_args(argv)
    dev = onnx_device(args.device)
    native, prompt = build(args, dev)
    return run(args, dev, native, prompt)


if __name__ == "__main__":
    main()
