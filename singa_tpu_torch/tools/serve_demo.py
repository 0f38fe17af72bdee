"""Continuous-batching serving demo: the port's counterpart of the JAX
package's ``examples/llama/serve_demo.py``.

    python -m singa_tpu_torch.tools.serve_demo
    python -m singa_tpu_torch.tools.serve_demo --requests 16 --slots 4 \\
        --obs /tmp/serve_events.jsonl        # JSONL telemetry stream

Drives a mixed prompt-length request stream (each prompt behind a shared
system prefix) through ``serve.ServeEngine`` on ``LlamaConfig.tiny()``
from seed 0: tokens stream per request, each request has a deadline, a
full queue answers ``QueueFull`` (backpressure), and the engine's metric
snapshot is printed at the end.  Where the reference prints its compiled
programs, the port prints its captured ones: the prefill-chunk and
decode programs run as CUDA graphs on the card from their second
dispatch (none on the CPU).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import device as device_mod
from .. import models, serve, tensor
from ..obs import events

__all__ = ["build_parser", "build", "run", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="continuous-batching demo")
    p.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                   help="auto is the card and fails without one")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--max-len", type=int, default=96)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--shared-prefix", type=int, default=16,
                   help="tokens of a shared system prompt prepended "
                        "to every request (0 = fully private prompts)")
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--new-tokens", type=int, default=24)
    p.add_argument("--deadline", type=float, default=30.0,
                   help="per-request deadline (s)")
    p.add_argument("--obs", default="",
                   help="JSONL telemetry sink path (as SINGA_OBS names one)")
    return p


def build(args, device, params: Optional[Dict[str, np.ndarray]] = None):
    """Llama(LlamaConfig.tiny()) from seed 0 (or with `params` carried in
    by name), in eval mode."""
    tensor.set_seed(0)
    np.random.seed(0)
    gen = torch.Generator(device.torch_device).manual_seed(0)
    m = models.Llama(models.LlamaConfig.tiny(), device=device, generator=gen)
    if params is not None:
        models.load_reference_params(m, params)
    m.eval()
    m.compile([torch.zeros((1, 4), dtype=torch.int32,
                           device=device.torch_device)],
              is_train=False, use_graph=False)
    return m


def run(args, m) -> Dict:
    """The demo's traffic through an engine over `m`: what it printed,
    with each admitted request's prompt and stream."""
    cfg = m.cfg
    print(f"engine: {args.slots} block-table rows x {args.max_len} "
          f"positions, paged in {args.block_size}-token blocks",
          flush=True)
    t0 = time.time()
    eng = serve.ServeEngine(m, args.slots, args.max_len,
                            block_size=args.block_size,
                            heartbeat_timeout_s=120.0)
    try:
        # warm the two programs before the traffic (the card captures
        # each at its second dispatch)
        eng.submit(np.zeros(4, np.int32), max_new_tokens=2)
        eng.run_until_idle()
        print(f"warmup (2 programs): {time.time() - t0:.1f}s", flush=True)

        rng = np.random.RandomState(42)
        max_private = args.max_len - args.new_tokens - args.shared_prefix
        lens = rng.randint(3, max(4, min(max_private + 1,
                                         max_private // 2 + 2)),
                           size=args.requests)
        shared = rng.randint(0, cfg.vocab_size,
                             (args.shared_prefix,)).astype(np.int32)
        handles, prompts, rejected = [], [], 0
        t0 = time.time()
        for i, plen in enumerate(lens):
            prompt = np.concatenate([
                shared,
                rng.randint(0, cfg.vocab_size, (plen,)).astype(np.int32)])

            def stream(tok, h, i=i):
                if len(h.tokens) == 1:
                    print(f"  req{i:02d} first token after "
                          f"{h.ttft_s * 1e3:.0f} ms", flush=True)

            try:
                handles.append(eng.submit(
                    prompt, max_new_tokens=args.new_tokens,
                    deadline_s=args.deadline, on_token=stream))
                prompts.append(prompt)
            except serve.QueueFull:
                rejected += 1
                print(f"  req{i:02d} REJECTED (queue full — backpressure)",
                      flush=True)
            # a few engine ticks between arrivals: requests overlap,
            # slots churn, prefill interleaves with decode
            if i % 3 == 2:
                eng.step()
        eng.run_until_idle()
        dt = time.time() - t0

        n_tok = sum(len(h.tokens) for h in handles)
        print(f"\nserved {len(handles)} requests, {n_tok} tokens "
              f"in {dt:.2f}s ({n_tok / dt:.0f} tok/s)", flush=True)
        for i, h in enumerate(handles):
            out = h.result()
            print(f"  req{i:02d} [{h.finish_reason:8s}] "
                  f"{len(h.tokens):3d} tokens: {out[:6]}...", flush=True)
        snap = eng.metrics.snapshot()
        print(f"\nmetrics: admitted {snap['admitted']}, rejected "
              f"{snap['rejected']}, evicted {snap['evicted']}", flush=True)
        print(f"prefix cache: {snap['prefix_hits']} hits, "
              f"{snap['prefix_hit_tokens']} prompt tokens served without "
              f"prefill", flush=True)
        if snap["ttft_ms"]:
            print(f"TTFT p50 {snap['ttft_ms']['p50']:.1f} ms, "
                  f"p99 {snap['ttft_ms']['p99']:.1f} ms; per-token p50 "
                  f"{snap['token_ms']['p50']:.2f} ms", flush=True)
        captured = tuple(int(p.graph is not None and p.graph.graph is not None)
                         for p in (eng._prefill, eng._decode))
        print(f"captured programs (prefill, decode): {captured}", flush=True)
        if args.obs:
            print(f"telemetry stream: {args.obs}", flush=True)
        return {"prompts": prompts,
                "streams": [list(map(int, h.tokens)) for h in handles],
                "finish_reasons": [h.finish_reason for h in handles],
                "rejected": rejected, "tokens": n_tok, "seconds": dt,
                "metrics": snap, "compiled_counts": eng.compiled_counts(),
                "captured": captured, "device": str(m.device.torch_device)}
    finally:
        eng.close()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = build_parser()
    args = p.parse_args(argv)
    if args.shared_prefix + 3 + args.new_tokens > args.max_len:
        p.error(f"--shared-prefix {args.shared_prefix} + a >=3-token "
                f"private suffix + --new-tokens {args.new_tokens} "
                f"exceeds --max-len {args.max_len}")
    if args.obs:
        events.configure(path=args.obs)
    try:
        return run(args, build(args, device_mod.create_device(args.device)))
    finally:
        if args.obs:
            events.configure()                # close the sink


if __name__ == "__main__":
    main()
