"""Open-loop traffic generator for the port's paged serving engine,
ported from the JAX package's ``tools/loadgen.py`` (its core: the
workload, the run and the record).

Closed-loop generators (submit, wait, submit) let a slow server set its own
pace; an open-loop generator arrives on its own clock — Poisson
inter-arrivals at a configured rate, mixed prompt and output lengths, a
tenant mix whose requests share per-tenant system prompts — so the
engine is judged on what its users feel: TTFT p50/p99, tokens/s, and
how load is shed past capacity.

    python -m singa_tpu_torch.tools.loadgen --device cpu      # tiny, CPU
    python -m singa_tpu_torch.tools.loadgen --config base --num-slots 8 \\
        --max-len 1024 --block-size 32 --prompt-lens 256,384,512 \\
        --shared-prefix 256 --new-tokens 32,64 --rate 8 --requests 48
    python -m singa_tpu_torch.tools.loadgen --config mixtral-8x7b \\
        --layers 2 ...                                        # on the card
    python -m singa_tpu_torch.tools.loadgen --device cpu \\
        --prefill-workers 1 --decode-workers 2                # a tier
    python -m singa_tpu_torch.tools.loadgen --device cpu \\
        --ratio-sweep 2:1,1:2                                 # N:M sweep

The run drives ``step()`` of a ``ServeEngine`` or an in-process
``Router`` directly: arrivals are submitted the tick their timestamp
passes, ``QueueFull`` rejections count as overload outcomes.  The
headline lands in the port's run-record store
(``runs/torch/records.jsonl``) as a ``serve_load`` entry.  The engine's
knobs are explicit arguments (the port has no autotune table yet).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

__all__ = ["build_workload", "run_load", "append_record", "parse_ratios",
           "main"]

CONFIG_NAMES = ("tiny", "base", "mistral-w4096", "mixtral-8x7b")


def _model_config(name: str, layers: Optional[int] = None):
    """The LlamaConfig `--config` names (a preset, or one of
    ``models.llama.PUBLISHED``), cut to `layers` layers if given."""
    from ..models import LlamaConfig, llama
    presets = {"tiny": LlamaConfig.tiny, "base": LlamaConfig.base}
    cfg = presets[name]() if name in presets else llama.PUBLISHED[name]
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


@dataclass
class _Arrival:
    at_s: float
    prompt: np.ndarray
    max_new: int
    tenant: int


def build_workload(n_requests: int, rate_rps: float, seed: int, *,
                   prompt_lens: Sequence[int] = (6, 10, 16, 24),
                   new_tokens: Sequence[int] = (4, 8, 16),
                   tenants: int = 3, shared_len: int = 16,
                   vocab: int = 256) -> List[_Arrival]:
    """A reproducible open-loop trace: Poisson arrivals at ``rate_rps``,
    prompts drawn as ``tenant system prefix (shared_len tokens) +
    private suffix (prompt_lens mix)``, output budgets from
    ``new_tokens``.  ``tenants=0`` or ``shared_len=0`` disables sharing
    (every prompt fully private)."""
    rng = np.random.RandomState(seed)
    at = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    prefixes = [rng.randint(0, vocab, (shared_len,)).astype(np.int32)
                for _ in range(tenants)] if tenants and shared_len else []
    out = []
    for i in range(n_requests):
        tenant = int(rng.randint(0, tenants)) if prefixes else -1
        suffix = rng.randint(
            0, vocab,
            (int(prompt_lens[rng.randint(0, len(prompt_lens))]),)
        ).astype(np.int32)
        prompt = (np.concatenate([prefixes[tenant], suffix])
                  if prefixes else suffix)
        out.append(_Arrival(float(at[i]), prompt,
                            int(new_tokens[rng.randint(0,
                                                       len(new_tokens))]),
                            tenant))
    return out


def _model_key(model) -> str:
    """Per-architecture identity of a served model: class name, width
    and depth (the reference's ``autotune.table.model_key``)."""
    cfg = getattr(model, "cfg", None)
    name = type(model).__name__.lower()
    dim = getattr(cfg, "dim", None)
    layers = getattr(cfg, "num_layers", None)
    if isinstance(dim, int) and isinstance(layers, int):
        return f"{name}-d{dim}-L{layers}"
    return name


def run_load(engine, workload: List[_Arrival], *,
             deadline_s: Optional[float] = None,
             eos_id: Optional[int] = None,
             max_wall_s: float = 300.0,
             pass_tenant: bool = False) -> dict:
    """Drive ``engine`` (a ``ServeEngine`` or a ``Router``) through
    ``workload`` open-loop and return the ``serve_load`` payload (plus a
    ``detail`` sub-dict outside the schema contract).  Overload outcomes
    (``QueueFull``, an injected routing fault at the door) are counted,
    never raised; only an engine crash propagates.  ``pass_tenant``
    forwards each arrival's tenant to ``submit(tenant=...)`` (Router
    only).  A Router's payload also carries its pool fields
    (``tier_stats()``)."""
    from ..faults import InjectedFault
    from ..serve import QueueFull

    handles = []
    router_faults = 0
    n = len(workload)
    i = 0
    t0 = time.monotonic()
    while True:
        now = time.monotonic() - t0
        while i < n and workload[i].at_s <= now:
            kw = {"tenant": f"t{workload[i].tenant}"} \
                if pass_tenant and workload[i].tenant >= 0 else {}
            try:
                handles.append(engine.submit(
                    workload[i].prompt,
                    max_new_tokens=workload[i].max_new,
                    deadline_s=deadline_s, eos_id=eos_id, **kw))
            except QueueFull:
                handles.append(None)       # counted via metrics.rejected
            except InjectedFault:
                handles.append(None)       # a chaos-plan routing outage
                router_faults += 1
            i += 1
        if engine.pending:
            engine.step()
        elif i < n:
            # idle until the next arrival: sleep, never pull it early
            time.sleep(min(workload[i].at_s - now, 0.05))
        else:
            break
        if now > max_wall_s:
            break
    wall = time.monotonic() - t0
    snap = engine.metrics.snapshot()
    served_model = getattr(engine, "model", None)
    done = [h for h in handles if h is not None]
    completed = sum(1 for h in done
                    if h.finish_reason in ("eos", "length"))
    tokens = sum(len(h.tokens) for h in done)
    ttft = snap["ttft_ms"] or {}
    payload = {
        "requests": n,
        "completed": completed,
        "shed": int(snap["evicted"].get("shed", 0)),
        "rejected": int(snap["rejected"]),
        "tokens_per_s": round(tokens / wall, 1) if wall else 0.0,
        "ttft_p50_ms": round(ttft.get("p50", 0.0), 3),
        "ttft_p99_ms": round(ttft.get("p99", 0.0), 3),
    }
    if served_model is not None:
        payload["model"] = _model_key(served_model)
    if snap.get("accept_rate") is not None:
        payload["accept_rate"] = round(snap["accept_rate"], 4)
        payload["tokens_per_dispatch"] = round(
            snap["tokens_per_dispatch"] or 0.0, 3)
    pool = getattr(engine, "pool", None)
    if pool is not None and getattr(pool, "spill", None) is not None:
        payload["spilled_blocks"] = int(snap.get("spilled_blocks", 0))
        payload["prefetch_hits"] = int(snap.get("prefetch_hits", 0))
        payload["prefetch_wait_ms"] = round(
            float(snap.get("prefetch_wait_ms", 0.0)), 3)
    payload["detail"] = {
        "wall_s": round(wall, 3),
        "generated_tokens": tokens,
        "deadline_evicted": int(snap["evicted"].get("deadline", 0)),
        "quarantined": int(snap["quarantined"]),
        "preempted": int(snap["preempted"]),
        "recoveries": int(snap["recoveries"]),
        "prefix_hits": int(snap["prefix_hits"]),
        "prefix_hit_tokens": int(snap["prefix_hit_tokens"]),
        "retries": dict(snap["retries"]),
        "token_p50_ms": round((snap["token_ms"] or {}).get("p50", 0.0),
                              3),
        "router_faults": router_faults,
        "spec_rounds": int(snap.get("spec_rounds", 0)),
        "spec_fallbacks": int(snap.get("spec_fallbacks", 0)),
    }
    tier = getattr(engine, "tier_stats", None)
    if tier is not None:
        payload.update(tier())
        payload["detail"]["reroutes"] = int(snap.get("reroutes", 0))
        payload["detail"]["worker_deaths"] = int(
            snap.get("worker_deaths", 0))
        payload["detail"]["handoff_p50_ms"] = round(
            (snap.get("handoff_ms") or {}).get("p50", 0.0), 3)
    return payload


def append_record(payload: dict, store: Optional[str] = None,
                  prefix: str = "load", device: str = "cuda") -> str:
    """Write the headline (schema-required fields and numeric extras;
    ``detail``'s numbers flattened in, its dicts left out) as a
    ``serve_load`` entry of the port's store, stamped with `device`'s
    platform and kind.  Returns the store path.  Two appends from one
    process get distinct run ids (``new_run_id``'s sequence)."""
    from ..obs import record as obs_record
    from ..obs import schema

    body = {k: v for k, v in payload.items() if k != "detail"}
    body.update({k: v for k, v in payload["detail"].items()
                 if isinstance(v, (int, float))})
    platform, kind = obs_record.device_kind(device)
    entry = obs_record.new_entry(
        "serve_load", platform, platform != "cuda", kind,
        run_id=obs_record.new_run_id(prefix), payload=body)
    schema.validate_entry(entry)           # fail before touching disk
    store = store or os.path.join(_REPO, obs_record.DEFAULT_STORE)
    obs_record.RunRecord(store).append(entry)
    return store


def parse_ratios(spec: str) -> List[tuple]:
    """``"3:1,2:2,1:3"`` -> [(3, 1), (2, 2), (1, 3)]: the N:M
    prefill:decode points a ratio sweep runs (each pool >= 1 worker)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        try:
            n, m = part.split(":")
            n, m = int(n), int(m)
        except ValueError:
            raise ValueError(
                f"--ratio-sweep: expected N:M points like '3:1,1:3', "
                f"got {part!r}")
        if n < 1 or m < 1:
            raise ValueError(f"--ratio-sweep: each pool needs >= 1 "
                             f"worker, got {part!r}")
        out.append((n, m))
    if not out:
        raise ValueError("--ratio-sweep: no points")
    return out


def _build_model(args):
    import torch

    from ..device import create_device
    from ..models import Llama
    dev = create_device(args.device)
    gen = torch.Generator(dev.torch_device.type).manual_seed(args.seed)
    return Llama(_model_config(args.config, args.layers), device=dev,
                 generator=gen)


def _engine_kwargs(args, model) -> dict:
    """The engine's knobs: the CLI's, with bf16 weights served on the
    card and the f32 masters on the CPU."""
    import torch
    on_card = model.device.torch_device.type == "cuda"
    return dict(block_size=args.block_size, num_blocks=args.num_blocks,
                share_prefix=not args.no_share, max_queue=args.max_queue,
                backoff_base=0.005, backoff_max=0.05, max_recoveries=100,
                param_dtype=torch.bfloat16 if on_card else None)


def _warm(target, vocab: int, seed: int) -> None:
    """One short request through `target`, so every program is made
    and captured before the timed run."""
    target.submit(build_workload(1, 1.0, seed + 1, vocab=vocab)[0].prompt,
                  max_new_tokens=2)
    target.run_until_idle()


def _fresh_metrics(target) -> None:
    """Start the engine's or every worker's counters afresh."""
    from ..serve.metrics import ServeMetrics
    engines = ([w.engine for w in target.prefill + target.decode]
               if hasattr(target, "tier_stats") else [target])
    for eng in engines:
        eng.metrics = ServeMetrics(flight=eng.flight)
    if hasattr(target, "tier_stats"):
        from ..serve.disagg.router import TierMetrics
        target.metrics = TierMetrics(target)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop Poisson traffic through the port's paged "
                    "serving engine or an in-process prefill/decode tier "
                    "(SLO readout + serve_load record)")
    ap.add_argument("--config", default="tiny", choices=CONFIG_NAMES)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--device", default="auto",
                    help="'auto' (the card; raises without one), 'cuda' "
                         "or 'cpu'")
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered arrivals/s")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the workload and of the weights")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="system-prompt tokens shared per tenant")
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request deadline (s)")
    ap.add_argument("--new-tokens", default="4,8,16")
    ap.add_argument("--prompt-lens", default="6,10,16,24")
    ap.add_argument("--num-slots", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--no-share", action="store_true",
                    help="disable prefix sharing in the engine")
    ap.add_argument("--store", default=None,
                    help="run-record store (default: runs/torch/"
                         "records.jsonl)")
    ap.add_argument("--no-record", action="store_true")
    ap.add_argument("--prefill-workers", type=int, default=0)
    ap.add_argument("--decode-workers", type=int, default=0)
    ap.add_argument("--ratio-sweep", default=None, metavar="N:M,...",
                    help="the same workload through each prefill:decode "
                         "ratio, one serve_load record per point")
    args = ap.parse_args(argv)
    tier = bool(args.prefill_workers or args.decode_workers)
    if tier and (args.prefill_workers < 1 or args.decode_workers < 1):
        ap.error("a tier needs --prefill-workers >= 1 AND "
                 "--decode-workers >= 1")
    points = parse_ratios(args.ratio_sweep) if args.ratio_sweep else None

    from ..obs import record as obs_record
    from ..serve import Router, ServeEngine, build_pools

    m = _build_model(args)
    dev = str(m.device.torch_device)
    store = (None if args.no_record else
             args.store or os.path.join(_REPO, obs_record.DEFAULT_STORE))
    kw = _engine_kwargs(args, m)
    vocab = m.cfg.vocab_size

    def workload():
        return build_workload(
            args.requests, args.rate, args.seed,
            prompt_lens=[int(t) for t in args.prompt_lens.split(",")],
            new_tokens=[int(t) for t in args.new_tokens.split(",")],
            tenants=args.tenants, shared_len=args.shared_prefix,
            vocab=vocab)

    def tier_of(n, mdec, template):
        pw, dw = build_pools(m, n, mdec, template=template,
                             num_slots=args.num_slots, max_len=args.max_len,
                             record_store=store, **kw)
        return Router(pw, dw, record_store=store)

    runs = []
    if points:
        template = ServeEngine(m, args.num_slots, args.max_len, **kw)
        sweep_id = obs_record.new_run_id("sweep")
        for i, (n, mdec) in enumerate(points):
            target = tier_of(n, mdec, template)
            _warm(target, vocab, args.seed)
            _fresh_metrics(target)
            payload = run_load(target, workload(), deadline_s=args.deadline)
            payload["sweep_id"] = sweep_id
            payload["sweep_seq"] = i
            runs.append(payload)
            target.close()
    else:
        if tier:
            target = tier_of(args.prefill_workers, args.decode_workers, None)
        else:
            target = ServeEngine(m, args.num_slots, args.max_len,
                                 record_store=store, **kw)
        _warm(target, vocab, args.seed)
        _fresh_metrics(target)
        runs.append(run_load(target, workload(), deadline_s=args.deadline))
        target.close()
    for payload in runs:
        print(json.dumps(payload, indent=2))
        if store is not None:
            append_record(payload, store, device=dev)
    if store is not None:
        print(f"# {len(runs)} serve_load entries appended to {store}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
