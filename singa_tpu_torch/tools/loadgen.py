"""Open-loop traffic generator for the port's paged serving engine,
ported from the JAX package's ``tools/loadgen.py``.

Closed-loop generators (submit, wait, submit) let a slow server set its own
pace; an open-loop generator arrives on its own clock — Poisson
inter-arrivals at a configured rate, mixed prompt and output lengths, a
tenant mix whose requests share per-tenant system prompts — so the
engine is judged on what its users feel: TTFT p50/p99, tokens/s, and
how load is shed past capacity.

    python -m singa_tpu_torch.tools.loadgen --device cpu      # tiny, CPU
    python -m singa_tpu_torch.tools.loadgen --config base --layers 2 \\
        --max-len 1024 --prompt-lens 256,384,512 --shared-prefix 256 \\
        --new-tokens 32,64 --rate 8 --requests 48             # the card

    # a disaggregated tier: N prefill + M decode workers behind the
    # Router (--tenant-quota: per-tenant in-flight quota at its door),
    # and the N:M sweep, one serve_load record per point
    python -m singa_tpu_torch.tools.loadgen --device cpu \\
        --prefill-workers 1 --decode-workers 2 --tenant-quota 2
    python -m singa_tpu_torch.tools.loadgen --device cpu \\
        --ratio-sweep 2:1,1:2

    # speculative decoding through a self-speculation draft, the int8
    # arena and the host spill tier (a plain engine), and the
    # plain-vs-spec pair (shared spec_pair_id, interleaved medians)
    python -m singa_tpu_torch.tools.loadgen --spec-k 4 --new-tokens 32
    python -m singa_tpu_torch.tools.loadgen --kv-dtype int8
    python -m singa_tpu_torch.tools.loadgen --spill-blocks 64
    python -m singa_tpu_torch.tools.loadgen --spec-compare --spec-k 3

    # the process tier (serve.net): every worker a ServeEngine in its
    # own OS process (each with its own CUDA context on the card); an
    # ElasticPolicy resizes it with --elastic-max
    python -m singa_tpu_torch.tools.loadgen --procs \\
        --prefill-workers 1 --decode-workers 1 --elastic-max 4

    # the smokes: each exits non-zero when a stream diverges
    python -m singa_tpu_torch.tools.loadgen --disagg-smoke
    python -m singa_tpu_torch.tools.loadgen --spec-smoke
    python -m singa_tpu_torch.tools.loadgen --spill-smoke
    python -m singa_tpu_torch.tools.loadgen --mp-smoke
    # a seeded chaos campaign (singa_tpu_torch.tools.chaosd)
    python -m singa_tpu_torch.tools.loadgen --chaos-campaign --seed 19

Every entry point takes ``--device`` (``auto``, the default, is the
card and raises without one; ``cpu`` when asked for), ``--config``
(``tiny``, ``base`` or a published configuration) and ``--layers``
(cut the depth).  On the card the load runs serve bf16 weights; the
smokes hold their streams bitwise to ``generate()`` and to a single
engine, so they compute in f32 there (the f32 masters, f32
activations), as the reference's smokes do on its CPU.

The run drives ``step()`` of a ``ServeEngine``, a ``Router`` or a
``ProcRouter`` directly: arrivals are submitted the tick their
timestamp passes, ``QueueFull`` rejections count as overload outcomes.
The headline lands in the port's run-record store
(``runs/torch/records.jsonl``) as a ``serve_load`` entry, beside a
``perf_attr`` entry (each engine program's dispatch times joined
against its recorded FLOPs and bytes; ``--perf-attr PATH`` also dumps
it).  ``--num-slots``, ``--block-size`` and ``--spill-blocks`` left
unset come from the port's best-config table
(``singa_tpu_torch.autotune``): an explicit flag wins, then the table's
entry for this model and device, then the registry's defaults.
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
           "tier_model", "disagg_smoke", "spec_smoke", "spill_smoke",
           "mp_smoke", "spec_compare", "main"]

CONFIG_NAMES = ("tiny", "base", "mistral-w4096", "mixtral-8x7b")

#: the builder every process-tier worker imports by name
TIER_BUILDER = "singa_tpu_torch.tools.loadgen:tier_model"


def _model_config(name: str, layers: Optional[int] = None):
    """The LlamaConfig `--config` names (a preset, or one of
    ``models.llama.PUBLISHED``), cut to `layers` layers if given."""
    from ..models import LlamaConfig, llama
    presets = {"tiny": LlamaConfig.tiny, "base": LlamaConfig.base}
    cfg = presets[name]() if name in presets else llama.PUBLISHED[name]
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def tier_model(device, config: str = "tiny", layers: Optional[int] = None,
               seed: int = 0, f32: bool = False):
    """Llama(`config` cut to `layers`) on the port ``Device`` `device`,
    weights from `seed`: what the CLI serves and what each process-tier
    worker builds (it imports this builder by name, under the same
    seed, so every process holds the same weights).  ``f32`` makes the
    device compute in f32 (its default dtype on a card is bf16)."""
    import torch

    from ..models import Llama
    if f32:
        device.default_dtype = torch.float32
    gen = torch.Generator(device.torch_device.type).manual_seed(seed)
    return Llama(_model_config(config, layers), device=device,
                 generator=gen)


@dataclass
class _Arrival:
    at_s: float
    prompt: np.ndarray
    max_new: int
    tenant: int


#: chat traffic: 3 tenants behind 256-token system prompts, private
#: suffixes of 256/384/512 tokens, 32 or 64 new tokens (``chip_smoke.py``'s
#: load phase, and the card's autotune serve sweep)
CHAT_WORKLOAD = dict(prompt_lens=(256, 384, 512), new_tokens=(32, 64),
                     tenants=3, shared_len=256)


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
    from ..autotune.table import model_key
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
        payload["model"] = model_key(served_model)
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


def _emit_perf_attr(led, target, window_s: float,
                    dump_path: Optional[str], store: Optional[str],
                    device: str) -> None:
    """Join the run's attribution ledger against the recorded FLOPs and
    bytes of the driven engine's programs (``obs.cost``); dump to
    ``dump_path`` when given and append a ``perf_attr`` record when a
    store is resolved.  Never fatal: attribution must not turn a
    completed load run into a failure."""
    if dump_path is None and store is None:
        return
    try:
        from ..obs import cost as obs_cost
        from ..obs import record as obs_record

        payload = obs_cost.perf_attr_payload(led.snapshot(), target,
                                             window_s)
        if dump_path:
            with open(dump_path, "w", encoding="utf-8") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            print(f"# perf_attr payload written to {dump_path}",
                  file=sys.stderr)
        if store is not None:
            platform, kind = obs_record.device_kind(device)
            entry = obs_record.new_entry(
                "perf_attr", platform, platform != "cuda", kind,
                run_id=obs_record.new_run_id("perfattr"),
                payload=payload)
            obs_record.RunRecord(store).append(entry)
            print(f"# perf_attr entry appended to {store}",
                  file=sys.stderr)
    except Exception as e:  # noqa: BLE001
        print(f"# perf_attr emission failed: {type(e).__name__}: {e}",
              file=sys.stderr)


def _spec_kwargs(spec_k, model) -> dict:
    """The ServeEngine speculative kwargs for ``--spec-k``: ONE place
    parameterizes every engine, tier and template builder
    (self-speculation: the draft is the target)."""
    return {"draft_model": model, "spec_k": spec_k} if spec_k else {}


def _build_model(args):
    from ..device import create_device
    return tier_model(create_device(args.device), args.config, args.layers,
                      args.seed)


def _engine_kwargs(args, model) -> dict:
    """The engine's knobs: the CLI's, with bf16 weights served on the
    card and the f32 masters on the CPU."""
    import torch
    on_card = model.device.torch_device.type == "cuda"
    return dict(block_size=args.block_size, num_blocks=args.num_blocks,
                share_prefix=not args.no_share, max_queue=args.max_queue,
                backoff_base=0.005, backoff_max=0.05,
                # a chaos soak may recover many times; the engine's
                # default budget of 2 is tuned for unit scenarios
                max_recoveries=100,
                param_dtype=torch.bfloat16 if on_card else None)


def _resolve_serve_knobs(args, model) -> dict:
    """Fill ``args.num_slots`` / ``args.block_size`` /
    ``args.spill_blocks`` from the port's best-config table when the
    CLI left them unset: an explicit flag wins, then the table's entry
    for this model on its device, then the registry's defaults
    (announced once).  The registry stores ``spill_blocks`` with 0 =
    off; the engine wants None for off."""
    from ..autotune import table as autotune_table

    knobs = autotune_table.resolve(
        "serve", autotune_table.model_key(model),
        autotune_table.platform_of(model),
        {"num_slots": args.num_slots, "block_size": args.block_size,
         "spill_blocks": getattr(args, "spill_blocks", None)})
    args.num_slots = int(knobs["num_slots"])
    args.block_size = int(knobs["block_size"])
    if getattr(args, "spill_blocks", None) is None:
        spill = int(knobs.get("spill_blocks", 0) or 0)
        args.spill_blocks = spill if spill > 0 else None
    return {"num_slots": args.num_slots, "block_size": args.block_size}


def _build_tier(model, n_prefill: int, n_decode: int, args, store,
                template=None):
    """A Router over N + M same-config workers sharing ``template``'s
    weight copy when given (each worker captures its own programs).
    With ``--spec-k`` the whole tier carries the self-speculation draft
    — prefill workers write both arenas, decode workers verify."""
    from ..serve import Router, build_pools

    pw, dw = build_pools(model, n_prefill, n_decode, template=template,
                         num_slots=args.num_slots, max_len=args.max_len,
                         record_store=store, **_engine_kwargs(args, model),
                         **_spec_kwargs(args.spec_k, model))
    return Router(pw, dw, tenant_quota=args.tenant_quota,
                  record_store=store)


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


def _smoke_model(config: str, layers: Optional[int], device: str):
    """A smoke's model: `config` cut to `layers`, seed 0, computing in
    f32 (on the card too), so its greedy streams are held bitwise to
    ``generate()`` as the reference's smokes hold them on its CPU."""
    from ..device import create_device
    return tier_model(create_device(device), config, layers, 0, f32=True)


def _prompts(m, seed: int, lens) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.randint(0, m.cfg.vocab_size, (int(n),)).astype(np.int32)
            for n in lens]


def _gen(m, prompt, n: int) -> List[int]:
    return list(map(int, m.generate(prompt[None], max_new_tokens=n)
                    [0, prompt.size:]))


def _diverged(what: str, ref, got, names=("engine", "tier")) -> None:
    for i, (a, b) in enumerate(zip(ref, got)):
        if a != b:
            print(f"{what}: FAIL — request {i} diverged: {names[0]}={a} "
                  f"{names[1]}={b}", file=sys.stderr)


def disagg_smoke(config: str = "tiny", layers: Optional[int] = None,
                 device: str = "auto") -> int:
    """A 1:1 in-process tier serves 8 requests with greedy streams held
    IDENTICAL to a single engine's (and the first one to
    ``generate()``): the handoff path end to end in one command
    (``--disagg-smoke``)."""
    from ..serve import Router, ServeEngine, build_pools

    m = _smoke_model(config, layers, device)
    prompts = _prompts(m, 11, (4, 6, 9, 12, 5, 7, 10, 8))
    eng = ServeEngine(m, num_slots=4, max_len=32, block_size=8)
    ref = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    ref_toks = [h.tokens for h in ref]
    if _gen(m, prompts[0], 6) != ref_toks[0]:
        print("disagg-smoke: FAIL — single engine drifted from "
              "generate()", file=sys.stderr)
        return 1
    pw, dw = build_pools(m, 1, 1, template=eng, num_slots=4, max_len=32,
                         block_size=8)
    tier = Router(pw, dw)
    got = [tier.submit(p, max_new_tokens=6) for p in prompts]
    tier.run_until_idle()
    got_toks = [h.tokens for h in got]
    handoffs = tier.metrics.handoffs
    tier.close()
    eng.close()
    if got_toks != ref_toks:
        _diverged("disagg-smoke", ref_toks, got_toks)
        return 1
    print(f"disagg-smoke: OK — {len(prompts)} streams identical "
          f"through a 1:1 tier ({handoffs} handoffs)")
    return 0


def spec_smoke(config: str = "tiny", layers: Optional[int] = None,
               device: str = "auto") -> int:
    """The same 8 prompts decoded three ways — ``generate()``, a plain
    engine, and a self-speculation engine (draft == target, spec_k=3)
    — must give IDENTICAL greedy streams, and self-speculation must
    accept every proposal (``--spec-smoke``)."""
    from ..serve import ServeEngine

    m = _smoke_model(config, layers, device)
    prompts = _prompts(m, 13, (4, 6, 9, 12, 5, 7, 10, 8))
    plain = ServeEngine(m, num_slots=4, max_len=32, block_size=8)
    ref = [plain.submit(p, max_new_tokens=6) for p in prompts]
    plain.run_until_idle()
    ref_toks = [h.tokens for h in ref]
    plain.close()
    if _gen(m, prompts[0], 6) != ref_toks[0]:
        print("spec-smoke: FAIL — plain engine drifted from generate()",
              file=sys.stderr)
        return 1
    spec = ServeEngine(m, num_slots=4, max_len=32, block_size=8,
                       draft_model=m, spec_k=3)
    got = [spec.submit(p, max_new_tokens=6) for p in prompts]
    spec.run_until_idle()
    got_toks = [h.tokens for h in got]
    snap = spec.metrics.snapshot()
    spec.close()
    if got_toks != ref_toks:
        _diverged("spec-smoke", ref_toks, got_toks, ("plain", "spec"))
        return 1
    if snap["accept_rate"] != 1.0:
        print(f"spec-smoke: FAIL — self-speculation accept_rate "
              f"{snap['accept_rate']} != 1.0 (the draft IS the target; "
              f"anything rejected means the verify window diverged "
              f"from sequential decode)", file=sys.stderr)
        return 1
    print(f"spec-smoke: OK — {len(prompts)} streams identical "
          f"(generate == plain == spec_k=3), accept_rate 1.0, "
          f"{snap['tokens_per_dispatch']:.2f} tokens/dispatch")
    return 0


def spill_smoke(config: str = "tiny", layers: Optional[int] = None,
                device: str = "auto") -> int:
    """A shrunk arena (num_blocks=9) with a host spill store serves a
    shared-prefix request, churns the arena until the cold prefix
    blocks are evicted to the spill tier, then re-hits the prefix so
    the blocks are restored.  Both shared-prefix streams must equal
    ``generate()``, blocks must have spilled, and the re-hit must be
    served from the spill store (``--spill-smoke``)."""
    from ..serve import ServeEngine

    m = _smoke_model(config, layers, device)
    rng = np.random.RandomState(17)
    shared = rng.randint(0, m.cfg.vocab_size, (16,)).astype(np.int32)
    tails = [rng.randint(0, m.cfg.vocab_size, (4,)).astype(np.int32)
             for _ in range(2)]
    prompts = [np.concatenate([shared, t]) for t in tails]
    refs = [_gen(m, p, 6) for p in prompts]
    # the churn requests need 3+ blocks each and run two at a time, so
    # with 9 physical blocks the LRU must evict the first request's cold
    # shared-prefix blocks — into the spill store instead of oblivion
    eng = ServeEngine(m, num_slots=2, max_len=32, block_size=8,
                      num_blocks=9, spill_blocks=16)
    h1 = eng.submit(prompts[0], max_new_tokens=6)
    eng.run_until_idle()
    for _ in range(4):
        q = rng.randint(0, m.cfg.vocab_size, (20,)).astype(np.int32)
        eng.submit(q, max_new_tokens=4)
    eng.run_until_idle()
    h2 = eng.submit(prompts[1], max_new_tokens=6)
    eng.run_until_idle()
    got = [h1.tokens, h2.tokens]
    snap = eng.metrics.snapshot()
    eng.close()
    if got != refs:
        _diverged("spill-smoke", refs, got, ("generate", "spill"))
        return 1
    if snap["spilled_blocks"] < 1:
        print("spill-smoke: FAIL — the shrunk arena never spilled a "
              "block (arena sizing drifted?)", file=sys.stderr)
        return 1
    if snap["prefetch_hits"] < 1:
        print("spill-smoke: FAIL — blocks spilled but no prefix re-hit "
              "was served from the spill store", file=sys.stderr)
        return 1
    print(f"spill-smoke: OK — streams identical to generate() through "
          f"a 9-block arena, {snap['spilled_blocks']} blocks spilled, "
          f"{snap['prefetch_hits']} restored "
          f"({snap['prefetch_wait_ms']:.1f} ms total prefetch wait)")
    return 0


def _device_type(device: str) -> str:
    """``"cuda"`` or ``"cpu"``: what `device` names (``auto`` is the
    card and raises without one)."""
    from ..device import create_device
    return create_device(device).torch_device.type


def _build_proc_tier(n_prefill: int, n_decode: int, args, store,
                     policy=None, f32: bool = False):
    """A ProcRouter over N + M worker PROCESSES: each worker builds
    :func:`tier_model` (``args.config`` / ``layers`` / ``seed``) in its
    own interpreter on ``args.device`` and captures its own programs;
    KV handoffs travel the digest-checked wire codec.  On the card
    the workers serve bf16 weights (``f32`` serves the f32 masters in
    f32, as the smokes compute)."""
    import torch

    from ..serve import ProcRouter, build_proc_pools

    kind = _device_type(args.device)
    spec = {"builder": TIER_BUILDER,
            "kwargs": {"config": args.config, "layers": args.layers,
                       "seed": args.seed, "f32": f32}}
    pool_kw = {}
    if kind == "cuda" and not f32:
        pool_kw["param_dtype"] = torch.bfloat16
    pw, dw = build_proc_pools(
        spec, n_prefill, n_decode, num_slots=args.num_slots,
        max_len=args.max_len, block_size=args.block_size,
        num_blocks=args.num_blocks, share_prefix=not args.no_share,
        max_queue=args.max_queue, record_store=store, device=kind,
        self_spec_k=args.spec_k, **pool_kw)
    return ProcRouter(pw, dw, record_store=store, policy=policy)


def _stamp_mp(payload: dict, tier, n_procs: int) -> None:
    """The multi-process provenance a ``--procs`` record carries: the
    transport trio, the worker process count, and the host's core
    count (whether the tokens/s number COULD have scaled with
    processes)."""
    payload.update(tier.transport_stats())
    if tier.model_key:
        payload["model"] = tier.model_key
    payload["procs"] = int(n_procs)
    payload["host_cores"] = int(os.cpu_count() or 1)


def mp_smoke(config: str = "tiny", layers: Optional[int] = None,
             device: str = "auto") -> int:
    """A 2-process 1:1 tier (each worker a ServeEngine in its own OS
    process behind the serve.net RPC) serves 6 requests with greedy
    streams held IDENTICAL to a single in-process engine's — spawn,
    framed RPC, the digest-checked KV wire codec and the in-place
    inject end to end (``--mp-smoke``)."""
    from ..serve import ServeEngine

    m = _smoke_model(config, layers, device)
    prompts = _prompts(m, 19, (4, 6, 9, 12, 5, 10))
    eng = ServeEngine(m, num_slots=4, max_len=32, block_size=8)
    ref = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_until_idle()
    ref_toks = [h.tokens for h in ref]
    eng.close()
    del eng, m

    args = _parser().parse_args(
        ["--config", config, "--device", device, "--num-slots", "4",
         "--max-len", "32", "--block-size", "8"]
        + (["--layers", str(layers)] if layers else []))
    tier = _build_proc_tier(1, 1, args, None, f32=True)
    try:
        got = [tier.submit(p, max_new_tokens=6) for p in prompts]
        tier.run_until_idle()
        got_toks = [h.tokens for h in got]
        handoffs = tier.metrics.handoffs
        wire = tier.metrics.wire_bytes
    finally:
        tier.close()
    if got_toks != ref_toks:
        _diverged("mp-smoke", ref_toks, got_toks)
        return 1
    if handoffs < 1:
        print("mp-smoke: FAIL — a 1:1 tier completed without a single "
              "KV handoff (the wire path was never exercised)",
              file=sys.stderr)
        return 1
    print(f"mp-smoke: OK — {len(prompts)} streams identical through a "
          f"2-process 1:1 tier ({handoffs} KV handoffs, {wire} bytes "
          f"over the wire)")
    return 0


def _workload(args, vocab: int) -> List[_Arrival]:
    return build_workload(
        args.requests, args.rate, args.seed,
        prompt_lens=[int(t) for t in args.prompt_lens.split(",")
                     if t.strip()],
        new_tokens=[int(t) for t in args.new_tokens.split(",") if t.strip()],
        tenants=args.tenants, shared_len=args.shared_prefix, vocab=vocab)


def spec_compare(args, store, trials: int = 3) -> List[dict]:
    """``--spec-compare``: the SAME Poisson workload through a plain
    engine and a self-speculation verify-k engine, one ``serve_load``
    record each, paired by a shared ``spec_pair_id`` (what
    ``autotune.table.pick_spec_k`` reads).  Trials are INTERLEAVED
    (plain, spec, plain, spec, ...) and each side records its
    median-tokens/s run.  Returns the two payloads (plain first)."""
    from ..obs import record as obs_record
    from ..serve import ServeEngine

    m = _build_model(args)
    _resolve_serve_knobs(args, m)
    dev = str(m.device.torch_device)
    pair_id = obs_record.new_run_id("specpair")
    variants = (0, args.spec_k or 3)
    engines = {}
    for spec_k in variants:
        engines[spec_k] = ServeEngine(
            m, args.num_slots, args.max_len, record_store=store,
            **_engine_kwargs(args, m), **_spec_kwargs(spec_k, m))
        _warm(engines[spec_k], m.cfg.vocab_size, args.seed)
    runs = {spec_k: [] for spec_k in variants}
    for _ in range(max(1, trials)):
        for spec_k in variants:
            eng = engines[spec_k]
            _fresh_metrics(eng)
            runs[spec_k].append(run_load(eng, _workload(args,
                                                        m.cfg.vocab_size),
                                         deadline_s=args.deadline))
    rows = []
    for seq, spec_k in enumerate(variants):
        engines[spec_k].close()
        ordered = sorted(runs[spec_k], key=lambda p: p["tokens_per_s"])
        payload = ordered[len(ordered) // 2]       # median trial
        payload["spec_pair_id"] = pair_id
        payload["spec_seq"] = seq
        payload["spec_k"] = spec_k
        payload["spec_trials"] = len(ordered)
        rows.append(payload)
        print(f"# {'spec_k=' + str(spec_k) if spec_k else 'plain'}  "
              f"tokens/s={payload['tokens_per_s']} (median of "
              f"{len(ordered)})  ttft_p99={payload['ttft_p99_ms']} ms"
              + (f"  accept_rate={payload['accept_rate']}"
                 f"  tokens/dispatch={payload['tokens_per_dispatch']}"
                 if spec_k else ""), file=sys.stderr)
        print(json.dumps(payload, indent=2))
        if store is not None:
            append_record(payload, store, prefix=f"load-spec{spec_k}",
                          device=dev)
    plain_tps, spec_tps = (r["tokens_per_s"] for r in rows)
    print(f"# spec vs plain tokens/s: {spec_tps} vs {plain_tps} "
          f"({spec_tps / plain_tps:.2f}x, pair {pair_id})",
          file=sys.stderr)
    return rows


def _warm(target, vocab: int, seed: int) -> None:
    """One short request through `target`, so every program is made
    and captured before the timed run."""
    target.submit(build_workload(1, 1.0, seed + 1, vocab=vocab)[0].prompt,
                  max_new_tokens=2)
    target.run_until_idle()


def _fresh_metrics(target) -> None:
    """Start the engine's or every in-process worker's counters
    afresh."""
    from ..serve.metrics import ServeMetrics
    engines = ([w.engine for w in target.prefill + target.decode]
               if hasattr(target, "tier_stats") else [target])
    for eng in engines:
        eng.metrics = ServeMetrics(flight=eng.flight)
    if hasattr(target, "tier_stats"):
        from ..serve.disagg.router import TierMetrics
        target.metrics = TierMetrics(target)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="open-loop Poisson traffic through the port's paged "
                    "serving engine or a disaggregated prefill/decode "
                    "tier, in process or across worker processes (SLO "
                    "readout + serve_load record)")
    ap.add_argument("--config", default="tiny", choices=CONFIG_NAMES)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--device", default="auto",
                    help="'auto' (the card; raises without one), 'cuda' "
                         "or 'cpu'")
    ap.add_argument("--requests", type=int, default=60)
    ap.add_argument("--rate", type=float, default=20.0,
                    help="offered arrivals/s (push past capacity to "
                         "study overload)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the workload and of the weights")
    ap.add_argument("--tenants", type=int, default=3,
                    help="tenant count for the shared-prefix mix "
                         "(0 = no sharing)")
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="system-prompt tokens shared per tenant")
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request deadline (s); drives shedding "
                         "under overload")
    ap.add_argument("--new-tokens", default="4,8,16",
                    help="comma-separated generation-budget mix")
    ap.add_argument("--prompt-lens", default="6,10,16,24",
                    help="comma-separated private-suffix prompt-length "
                         "mix")
    ap.add_argument("--num-slots", type=int, default=None,
                    help="decode-batch slots (default: the best-config "
                         "table's value for this model and device, "
                         "else 8)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-queue capacity (default: the "
                         "engine's 2*num_slots)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged-KV block size (default: the best-config "
                         "table's value for this model and device, "
                         "else 8)")
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--no-share", action="store_true",
                    help="disable prefix sharing in the engine")
    ap.add_argument("--store", default=None,
                    help="run-record store (default: runs/torch/"
                         "records.jsonl)")
    ap.add_argument("--no-record", action="store_true")
    ap.add_argument("--perf-attr", default=None, metavar="PATH",
                    help="dump the runtime-attribution payload (each "
                         "program's dispatch times joined against its "
                         "recorded FLOPs and bytes) to PATH; a "
                         "perf_attr record is appended whenever "
                         "recording is on")
    ap.add_argument("--prefill-workers", type=int, default=0,
                    help="disaggregated tier: prefill pool size (with "
                         "--decode-workers; 0 = single engine)")
    ap.add_argument("--decode-workers", type=int, default=0,
                    help="disaggregated tier: decode pool size")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="per-tenant in-flight quota at the tier door "
                         "(Router only)")
    ap.add_argument("--ratio-sweep", default=None, metavar="N:M,...",
                    help="the same workload through each prefill:decode "
                         "ratio, one serve_load record per point")
    ap.add_argument("--disagg-smoke", action="store_true",
                    help="smoke: 1:1 tier streams held identical to a "
                         "single engine (8 requests); exits non-zero on "
                         "divergence")
    ap.add_argument("--procs", action="store_true",
                    help="run the tier MULTI-PROCESS (serve.net): each "
                         "worker a ServeEngine in its own OS process, "
                         "KV handoffs over the digest-checked wire "
                         "codec; records stamp the transport trio plus "
                         "procs/host_cores provenance")
    ap.add_argument("--elastic-max", type=int, default=0,
                    help="with --procs: cap for an ElasticPolicy that "
                         "grows/shrinks the pools at runtime from "
                         "backpressure signals (0 = fixed pools)")
    ap.add_argument("--mp-smoke", action="store_true",
                    help="smoke: 2-process 1:1 tier streams held "
                         "identical to a single in-process engine (6 "
                         "requests, >= 1 wire handoff)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: propose/verify k tokens "
                         "per round through a self-speculation draft "
                         "(0 = plain decode)")
    ap.add_argument("--spec-compare", action="store_true",
                    help="the same workload through a plain and a "
                         "speculative engine, one serve_load record "
                         "each paired by spec_pair_id")
    ap.add_argument("--spec-smoke", action="store_true",
                    help="smoke: self-speculation streams held identical "
                         "to generate() and a plain engine, accept rate "
                         "1.0")
    ap.add_argument("--spill-smoke", action="store_true",
                    help="smoke: shrunk arena + host spill store; "
                         "streams identical to generate(), with blocks "
                         "spilled AND a prefix re-hit served from the "
                         "spill store")
    ap.add_argument("--chaos-campaign", action="store_true",
                    help="delegate to singa_tpu_torch.tools.chaosd: a "
                         "seeded campaign of worker kills/hangs, fault "
                         "plans and resizes against a live process tier "
                         "under this Poisson rate, committing a "
                         "chaos_campaign record")
    ap.add_argument("--chaos-events", type=int, default=6,
                    help="with --chaos-campaign: schedule length")
    ap.add_argument("--kv-dtype", default=None, choices=("f32", "int8"),
                    help="KV arena storage format (plain engine only; "
                         "int8 = quantize-on-scatter blocks with "
                         "per-position scales)")
    ap.add_argument("--spill-blocks", type=int, default=None,
                    help="host spill-store capacity in blocks (plain "
                         "engine only; default: the best-config "
                         "table's, else no spill tier)")
    return ap


def _check_args(ap, args) -> None:
    """The reference's refusals (``tools/loadgen.py``), in its order."""
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    if ((args.kv_dtype or args.spill_blocks) and
            (args.prefill_workers or args.decode_workers or
             args.ratio_sweep or args.spec_compare or args.procs)):
        ap.error("--kv-dtype/--spill-blocks drive a plain engine — "
                 "not a tier, sweep, or --spec-compare")
    if args.procs and args.spec_compare:
        ap.error("--spec-compare is an in-process A/B (interleaved "
                 "trials on shared engines) — it has no --procs mode")
    if args.procs and not (args.ratio_sweep or
                           (args.prefill_workers and
                            args.decode_workers)):
        ap.error("--procs needs a tier: --prefill-workers/"
                 "--decode-workers or --ratio-sweep")
    if args.procs and args.tenant_quota is not None:
        ap.error("--tenant-quota is the in-process Router's door — "
                 "the multi-process tier has no per-tenant quota yet")
    if args.elastic_max and not args.procs:
        ap.error("--elastic-max resizes worker PROCESSES — it needs "
                 "--procs")


def _emit(payload: dict, store, dev: str, prefix: str) -> None:
    print(json.dumps(payload, indent=2))
    if store is not None:
        append_record(payload, store, prefix=prefix, device=dev)


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    smoke_kw = dict(config=args.config, layers=args.layers,
                    device=args.device)
    for flag, smoke in (("disagg_smoke", disagg_smoke),
                        ("mp_smoke", mp_smoke), ("spec_smoke", spec_smoke),
                        ("spill_smoke", spill_smoke)):
        if getattr(args, flag):
            return smoke(**smoke_kw)
    if args.chaos_campaign:
        from . import chaosd
        cargv = ["--seed", str(args.seed), "--events",
                 str(args.chaos_events), "--rate", str(args.rate),
                 "--config", args.config, "--device", args.device]
        if args.layers:
            cargv += ["--layers", str(args.layers)]
        if args.prefill_workers:
            cargv += ["--prefill", str(args.prefill_workers)]
        if args.decode_workers:
            cargv += ["--decode", str(args.decode_workers)]
        if args.store:
            cargv += ["--store", args.store]
        if args.no_record:
            cargv += ["--no-record"]
        return chaosd.main(cargv)
    _check_args(ap, args)

    from ..obs import attr as obs_attr
    from ..obs import record as obs_record
    from ..serve import ServeEngine

    # one resolved store for both record producers: the engines'
    # incident entries and the serve_load headline
    store = (None if args.no_record else
             args.store or os.path.join(_REPO, obs_record.DEFAULT_STORE))
    if args.spec_compare:
        spec_compare(args, store)
        return 0

    m = _build_model(args)
    _resolve_serve_knobs(args, m)
    dev = str(m.device.torch_device)
    vocab = m.cfg.vocab_size

    if args.ratio_sweep and args.procs:
        points = parse_ratios(args.ratio_sweep)
        # every point spawns fresh workers that each capture their own
        # programs at their first dispatches (the price of process
        # isolation; spawn stays outside run_load's wall)
        sweep_id = obs_record.new_run_id("mpsweep")
        for i, (n, mdec) in enumerate(points):
            tier = _build_proc_tier(n, mdec, args, store)
            try:
                payload = run_load(tier, _workload(args, vocab),
                                   deadline_s=args.deadline)
                _stamp_mp(payload, tier, n + mdec)
            finally:
                tier.close()
            # mp_sweep_id, not sweep_id: the in-process ratio points and
            # the process points are grouped apart
            payload["mp_sweep_id"] = sweep_id
            payload["mp_sweep_seq"] = i
            print(f"# mp ratio {n}:{mdec} ({n + mdec} procs, "
                  f"{payload['host_cores']} cores)  "
                  f"ttft_p99={payload['ttft_p99_ms']} ms  "
                  f"tokens/s={payload['tokens_per_s']}  "
                  f"handoffs={payload['handoffs']}  "
                  f"wire_bytes={payload['handoff_wire_bytes']}",
                  file=sys.stderr)
            _emit(payload, store, dev, f"mpload{i}")
        return 0

    if args.ratio_sweep:
        points = parse_ratios(args.ratio_sweep)
        # every point's tier serves from ONE template engine's weight
        # copy; the template carries the draft the workers get
        template = ServeEngine(m, args.num_slots, args.max_len,
                               **_engine_kwargs(args, m),
                               **_spec_kwargs(args.spec_k, m))
        sweep_id = obs_record.new_run_id("sweep")
        for i, (n, mdec) in enumerate(points):
            tier = _build_tier(m, n, mdec, args, store, template=template)
            _warm(tier, vocab, args.seed)
            _fresh_metrics(tier)
            payload = run_load(tier, _workload(args, vocab),
                               deadline_s=args.deadline,
                               pass_tenant=args.tenant_quota is not None)
            tier.close()
            payload["sweep_id"] = sweep_id
            payload["sweep_seq"] = i
            print(f"# ratio {n}:{mdec}  ttft_p99={payload['ttft_p99_ms']}"
                  f" ms  tokens/s={payload['tokens_per_s']}  "
                  f"handoffs={payload['handoffs']}", file=sys.stderr)
            _emit(payload, store, dev, "load")
        template.close()
        return 0

    if args.prefill_workers or args.decode_workers:
        if args.prefill_workers < 1 or args.decode_workers < 1:
            ap.error("a tier needs --prefill-workers >= 1 AND "
                     "--decode-workers >= 1")
        if args.procs:
            policy = None
            if args.elastic_max:
                from ..serve import ElasticPolicy
                policy = ElasticPolicy(max_total=args.elastic_max)
            eng = _build_proc_tier(args.prefill_workers,
                                   args.decode_workers, args, store,
                                   policy=policy)
        else:
            eng = _build_tier(m, args.prefill_workers,
                              args.decode_workers, args, store)
    else:
        if args.tenant_quota is not None:
            ap.error("--tenant-quota needs a tier "
                     "(--prefill-workers/--decode-workers) — a plain "
                     "engine has no tenant door")
        eng = ServeEngine(m, args.num_slots, args.max_len,
                          record_store=store, kv_dtype=args.kv_dtype,
                          spill_blocks=args.spill_blocks,
                          **_engine_kwargs(args, m),
                          **_spec_kwargs(args.spec_k, m))
    try:
        if not args.procs:
            _warm(eng, vocab, args.seed)
            _fresh_metrics(eng)
        # the attribution ledger around the driven window (a process
        # tier's dispatches happen in its workers: nothing to note here)
        led = obs_attr.install()
        try:
            payload = run_load(eng, _workload(args, vocab),
                               deadline_s=args.deadline,
                               pass_tenant=args.tenant_quota is not None)
        finally:
            obs_attr.uninstall()
        if args.procs:
            _stamp_mp(payload, eng,
                      args.prefill_workers + args.decode_workers)
        _emit(payload, store, dev, "mpload" if args.procs else "load")
        if store is not None:
            print(f"# serve_load entry appended to {store}",
                  file=sys.stderr)
        if not args.procs:
            _emit_perf_attr(led, eng, payload["detail"]["wall_s"],
                            args.perf_attr, store, dev)
    finally:
        eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
