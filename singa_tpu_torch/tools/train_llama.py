"""Train a Llama-3 model on a mesh: the port's counterpart of the JAX
package's ``examples/llama/train.py`` (its options, defaults, refusals
and printed lines).

    python -m singa_tpu_torch.tools.train_llama --preset small --steps 5 \\
        --fused-loss --opt adafactor --generate 16
    python -m singa_tpu_torch.tools.train_llama --preset tiny --device cpu
    python -m singa_tpu_torch.tools.train_llama --preset 8b --plan \\
        --dp 4 --tp 8
    torchrun --nproc_per_node=8 -m singa_tpu_torch.tools.train_llama \\
        --preset tiny --dp 2 --tp 2 --sp 2 --device cpu

The mesh flags ``--dp/--tp/--sp/--pp/--micro/--ep`` make a
``parallel.make_mesh`` over the process group that ``torchrun`` (or the
``SINGA_*`` variables) describes: NCCL on the card, gloo with
``--device cpu``.  A world of 1 runs with no group.  The reference's
``--force-host-devices`` (XLA's virtual CPU devices) has no counterpart:
launch that many processes with ``torchrun ... --device cpu``.

``--plan`` plans the step on meta tensors (``parallel.plan_train_step``;
no weights, no card) with the reference's optimizer, and prints its
bytes and whether they fit the cards of ``planner.HBM_BYTES`` at 75 %.
Otherwise the model is built from seed 0, the ids are drawn from
``np.random.RandomState(0)`` over min(vocab, 32000), and the step runs
through ``compile(..., use_graph=True)`` and ``train_step`` (a CUDA
graph on the card from the third step): each step prints its loss,
tokens/s and TFLOP/s from ``flops_per_token``.  ``--generate N`` then
decodes greedily with the KV cache.  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import device as device_mod
from .. import models, opt, parallel, tensor
from ..parallel.mesh import Mesh

__all__ = ["PRESETS", "build_parser", "model_config", "mesh_axes",
           "plan", "build", "train", "run", "main"]

PRESETS = {
    "tiny": models.LlamaConfig.tiny,
    "small": models.LlamaConfig.small,
    "8b": models.LlamaConfig.llama3_8b,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Llama training (GSPMD sharded)")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--preset", default="tiny", choices=["tiny", "small", "8b"])
    p.add_argument("--dp", type=int, default=1, help="data-parallel ways")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ways")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel ways")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stages (GPipe over the "
                        "'pipe' mesh axis; layers must divide evenly)")
    p.add_argument("--micro", type=int, default=0,
                   help="pipeline microbatches (default: = --pp)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--lr", type=float, default=None,
                   help="default 3e-4; with --opt adafactor, unset "
                        "means the relative-step schedule")
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention (Mistral-style; the "
                        "flash kernels with a window on the card)")
    p.add_argument("--experts", type=int, default=0,
                   help="Mixtral-style MoE: SwiGLU experts per block "
                        "(use with --ep ways via the 'expert' axis)")
    p.add_argument("--ep", type=int, default=1, help="expert-parallel ways")
    p.add_argument("--opt", default="adamw",
                   choices=["adamw", "adafactor", "sgd"],
                   help="adafactor = factored second moment (r+c floats "
                        "per matrix instead of r*c) with relative step "
                        "size")
    p.add_argument("--int8-ring", action="store_true",
                   help="int8-ring quantized gradient sync with error "
                        "feedback (DistOpt compression='int8_ring')")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding: optimizer "
                        "moments sharded over the data axis (1/N memory)")
    p.add_argument("--fused-loss", action="store_true",
                   help="chunked fused lm-head+CE (no (B*T,V) logits; "
                        "train_one_batch returns (loss, loss))")
    p.add_argument("--plan", action="store_true",
                   help="shape-only capacity plan (no weights allocated): "
                        "per-device param/moment/grad bytes + card fit")
    p.add_argument("--generate", type=int, default=0, metavar="N",
                   help="after training, greedy-generate N tokens with "
                        "the KV cache")
    return p


def _refuse(msg: str):
    raise ValueError(msg)


def model_config(args, error: Callable[[str], None] = _refuse
                 ) -> models.LlamaConfig:
    """The preset with the flags applied; `error(msg)` refuses what the
    reference refuses (the parser's ``p.error`` from the command line)."""
    cfg = PRESETS[args.preset]()
    if args.fused_loss:
        cfg.fused_loss = True
    if args.pp > 1:
        cfg.pipeline_stages = args.pp
        cfg.pipeline_microbatches = args.micro
    if args.window:
        if args.window < 1:
            error(f"--window must be positive, got {args.window}")
        if args.sp > 1:
            error("--window does not compose with --sp (ring attention)")
        cfg.sliding_window = args.window
    if args.experts:
        cfg.num_experts = args.experts
        cfg.moe_top_k = min(cfg.moe_top_k, args.experts)
    if args.ep > 1:
        if not args.experts:
            error("--ep needs --experts (an 'expert' axis with no MoE "
                  "replicates weights and wastes devices)")
        if args.experts % args.ep:
            error(f"--experts {args.experts} must divide by --ep "
                  f"{args.ep} (otherwise expert weights silently "
                  "replicate instead of sharding)")
    return cfg


def mesh_axes(args) -> Dict[str, int]:
    """The mesh's axes above 1, or a data axis of 1."""
    return {k: v for k, v in
            (("data", args.dp), ("model", args.tp), ("seq", args.sp),
             ("pipe", args.pp), ("expert", args.ep))
            if v > 1} or {"data": 1}


def _lr(args) -> float:
    return 3e-4 if args.lr is None else args.lr


def plan(args, cfg: models.LlamaConfig, axes: Dict[str, int]):
    """The step's plan on meta tensors over a mesh of `axes` (a shape: no
    group, no card), with the reference's optimizer."""
    plan_opt = (opt.DistOpt(opt.AdamW(lr=_lr(args)),
                            shard_weight_update=True)
                if args.zero1 else opt.AdamW(lr=_lr(args)))
    return parallel.plan_train_step(
        lambda d: models.Llama(cfg, device=d), plan_opt,
        ((torch.Size([args.batch, args.seq]), torch.int32),), axes)


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """The model from seed 0 (or with `params` carried in by name), its
    optimizer, and the (batch, seq) ids: (model, ids as numpy)."""
    cfg = model_config(args)
    tensor.set_seed(0)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    m = models.Llama(cfg, device=device, generator=gen)
    if params is not None:
        models.load_reference_params(m, params)
    base_opt = {"adamw": lambda: opt.AdamW(lr=_lr(args)),
                # explicit --lr overrides adafactor's relative step
                "adafactor": lambda: opt.Adafactor(lr=args.lr),
                "sgd": lambda: opt.SGD(lr=_lr(args), momentum=0.9),
                }[args.opt]()
    m.set_optimizer(opt.DistOpt(
        base_opt, shard_weight_update=args.zero1,
        compression="int8_ring" if args.int8_ring else None))
    vocab = min(cfg.vocab_size, 32000)
    ids = np.random.RandomState(0).randint(
        0, vocab, (args.batch, args.seq)).astype(np.int32)
    return m, ids


def train(args, m, ids_np: np.ndarray) -> Dict:
    """Compile, `args.steps` steps on the one batch, then `--generate`:
    what it printed."""
    ids = torch.as_tensor(ids_np, device=m.device.torch_device)
    print(f"params: {m.num_params() / 1e6:.1f}M; compiling sharded step ...",
          flush=True)
    m.compile([ids], is_train=True, use_graph=True)
    flops_step = m.flops_per_token(args.seq) * args.batch * args.seq
    out = {"params": m.num_params(), "flops_per_step": flops_step,
           "losses": [], "tokens_per_s": [], "tflops": []}
    for step in range(args.steps):
        t0 = time.perf_counter()
        _, loss = m.train_step(ids)
        lv = loss.item()
        dt = time.perf_counter() - t0
        tok_s = args.batch * args.seq / dt
        out["losses"].append(lv)
        out["tokens_per_s"].append(tok_s)
        out["tflops"].append(flops_step / dt / 1e12)
        print(f"step {step}: loss {lv:.4f}  {tok_s:,.0f} tok/s  "
              f"{flops_step / dt / 1e12:.2f} TFLOP/s", flush=True)
    g = m.get_graph("train")
    out["train_captured"] = g is not None and g.graph is not None
    if args.generate:
        # KV-cache decoding: a prefill and one decode step, captured on
        # the card at the second call and replayed
        parallel.set_mesh(None)
        prompt = ids_np[:1, : min(8, args.seq)]
        m.generate(prompt, args.generate)     # warm: eager first call
        t0 = time.perf_counter()
        gen = m.generate(prompt, args.generate)
        dt = time.perf_counter() - t0
        out["generated"] = gen[0, prompt.shape[1]:].tolist()
        out["generate_tokens_per_s"] = args.generate / dt
        print(f"generated {args.generate} tokens "
              f"({args.generate / dt:.1f} tok/s, cached decode): "
              f"{out['generated']}", flush=True)
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = build_parser()
    args = p.parse_args(argv)
    cfg = model_config(args, p.error)
    axes = mesh_axes(args)
    if args.plan:
        mesh = Mesh(axes)
        print(f"mesh axes: {axes}  devices: {mesh.devices.size}")
        pl = plan(args, cfg, axes)
        gib = 2.0 ** 30
        print(f"params (global):     {pl.param_bytes_global / gib:8.2f} GiB")
        print(f"params / device:     {pl.param_bytes_per_device / gib:8.2f}"
              f" GiB")
        print(f"moments / device:    {pl.slot_bytes_per_device / gib:8.2f} "
              f"GiB")
        print(f"grads / device:      {pl.grad_bytes_per_device / gib:8.2f} "
              f"GiB")
        print(f"state / device:      {pl.per_device_state_bytes / gib:8.2f} "
              f"GiB")
        fits = {chip: pl.fits(chip) for chip in ("h100", "h200")}
        for chip, ok in fits.items():
            print(f"fits {chip:4s} (75% HBM): {ok}")
        return {"mesh": axes, "fits": fits, "plan": {
            f: getattr(pl, f) for f in (
                "param_bytes_global", "param_bytes_per_device",
                "slot_bytes_per_device", "grad_bytes_per_device",
                "per_device_state_bytes")}}

    cpu = args.device == "cpu"
    joined = False
    if not parallel.distributed.is_initialized():
        parallel.init_distributed(device="cpu" if cpu else None)
        joined = parallel.distributed.is_initialized()
    try:
        if parallel.distributed.is_initialized() and not cpu:
            dev = device_mod.get_default_device()    # this rank's card
        else:
            dev = device_mod.create_device(args.device)
        return run(args, dev)
    finally:
        if joined:
            parallel.finalize_distributed()


def run(args, device, params: Optional[Dict[str, np.ndarray]] = None
        ) -> Dict:
    """The mesh of the flags over the current group (a world of 1 without
    one), then `build` and `train` on `device`: what it printed."""
    axes = mesh_axes(args)
    mesh = parallel.make_mesh(axes)
    parallel.set_mesh(mesh)
    try:
        print(f"mesh axes: {axes}  devices: {mesh.devices.size}", flush=True)
        m, ids = build(args, device, params)
        out = train(args, m, ids)
        out.update(mesh=axes, device=str(device.torch_device))
        return out
    finally:
        parallel.set_mesh(None)


if __name__ == "__main__":
    main()
