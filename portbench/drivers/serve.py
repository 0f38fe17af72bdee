"""The serving driver: the program's paged ``serve.ServeEngine`` over a
model built from the seed, fed by the mix's traffic, and the served
tokens judged against the reference once the window has closed.

Open loop (``"loop": "open"``): requests arrive at their due times
whatever the engine does; warm-up arrivals before the window fill the
queue and the prefix cache, tail arrivals after it keep the load on
while the window's requests end.  Each request is timed from when it
was due.  Closed loop (``"loop": "closed"``): a batch job that keeps
``outstanding`` requests submitted until the window closes, then
submits no more and lets those submitted end, for at most ``drain_s``.
Its window's requests are those live in the window: submitted before
its close and not ended before its start.  ``submit`` happens between
``step()`` calls, as a server's loop would do it.
"""

from __future__ import annotations

import gc
import math
import time
from typing import List

import numpy as np
import torch

from harness import trace, traffic
from harness.program import llama_config, program_device
from harness.weights import Weights, mix as mix_seed
from reference import model as ref_model


class Tracked:
    __slots__ = ("arrival", "due", "handle", "times", "rejected")

    def __init__(self, arrival, due):
        self.arrival, self.due = arrival, due
        self.handle, self.times, self.rejected = None, [], False

    @property
    def done(self) -> bool:
        return self.rejected or (self.handle is not None and self.handle.done)


def build(cell, seed: int, dev):
    from singa_tpu_torch.models import Llama
    from singa_tpu_torch.serve import ServeEngine
    mix = cell.mix
    m = Llama(llama_config(cell.config, mix), device=program_device(dev))
    m.eval()
    dtype = getattr(torch, mix["param_dtype"]) if dev.type == "cuda" \
        else None
    Weights(cell.config, seed, dev, dtype or torch.float32).load_into(
        m.get_params())
    eng = ServeEngine(m, mix["num_slots"], mix["max_len"],
                      block_size=mix["block_size"],
                      share_prefix=mix["share_prefix"], param_dtype=dtype,
                      max_queue=mix.get("max_queue"))
    return m, eng


def submit(eng, r: Tracked) -> None:
    from singa_tpu_torch.serve import QueueFull
    times = r.times
    try:
        with trace.span("submit"):
            r.handle = eng.submit(
                r.arrival.prompt, max_new_tokens=r.arrival.max_new,
                on_token=lambda tok, h: times.append(time.perf_counter()))
    except QueueFull:
        r.rejected = True


class Loop:
    """The engine driven from one thread: submissions between steps, each
    step timed on the host."""

    def __init__(self, eng):
        self.eng = eng
        self.step_s: List[tuple] = []         # (start, seconds)

    def step(self) -> None:
        t = time.perf_counter()
        with trace.span("engine.step"):
            self.eng.step()
        self.step_s.append((t, time.perf_counter() - t))


def open_window(cell, eng, seed, seconds, traced, rec) -> dict:
    mix = cell.mix
    arrivals = traffic.open_loop(mix, seed, seconds,
                                 cell.config["vocab_size"])
    loop = Loop(eng)
    tracer = trace.Tracer() if traced else None
    base = time.perf_counter() + mix["warm_s"]   # the window's start
    reqs = [Tracked(a, base + a.due_s) for a in arrivals]
    nxt, hits0, hits1, t_trace, traced_done = 0, None, None, None, None
    window = [r for r in reqs if r.arrival.phase == "window"]
    while True:
        now = time.perf_counter()
        if hits0 is None and now >= base:
            hits0 = eng.metrics.prefix_hit_tokens
            rec["setup_end"] = now
            if tracer:
                tracer.start()
                t_trace = time.perf_counter()
        if tracer and t_trace and now - t_trace >= mix["trace_seconds"]:
            tracer.stop()
            tracer, traced_done = None, tracer
        if hits1 is None and now >= base + seconds:
            hits1 = eng.metrics.prefix_hit_tokens
        while nxt < len(reqs) and reqs[nxt].due <= now:
            submit(eng, reqs[nxt])
            nxt += 1
        if now >= base + seconds and all(r.done for r in window):
            break
        if now > base + seconds + mix["drain_s"]:
            break
        if any(not r.done for r in reqs[:nxt]):
            loop.step()
        elif nxt < len(reqs):
            time.sleep(max(0.0, min(reqs[nxt].due - now, 0.002)))
        else:
            break
    if tracer:
        tracer.stop()
        traced_done = tracer
    if traced_done:
        rec["trace"] = traced_done.read()
    end = base + seconds
    rec["prefix_hit_tokens"] = (hits1 or 0) - (hits0 or 0)
    # the prompts admitted in the window: a request is admitted, and its
    # prefix hits counted, in the step that delivers its first token
    rec["prompt_tokens"] = sum(r.arrival.prompt.size for r in reqs
                               if r.times and base <= r.times[0] < end)
    rec["steps"] = [s for t, s in loop.step_s if base <= t < end]
    return {"requests": reqs, "window": window, "base": base}


def closed_window(cell, eng, seed, seconds, traced, rec) -> dict:
    mix = cell.mix
    pool = traffic.closed_pool(mix, seed, cell.config["vocab_size"])
    loop = Loop(eng)
    tracer = trace.Tracer() if traced else None
    reqs, nxt = [], 0
    t_start = time.perf_counter()
    base = t_start + mix["warm_s"]
    t_trace = traced_done = None
    while True:
        now = time.perf_counter()
        if t_trace is None and now >= base:
            rec["setup_end"] = now
            t_trace = now
            if tracer:
                tracer.start()
        if tracer and t_trace and now - t_trace >= mix["trace_seconds"]:
            tracer.stop()
            tracer, traced_done = None, tracer
        if now >= base + seconds:
            if now > base + seconds + mix["drain_s"] or \
                    all(r.done for r in reqs):
                break
            loop.step()
            continue
        live = sum(1 for r in reqs if not r.done)
        while live < mix["outstanding"]:
            if nxt >= len(pool):
                raise RuntimeError("the batch job's pool ran out: raise "
                                   "its 'pool'")
            r = Tracked(pool[nxt], now)
            nxt += 1
            submit(eng, r)
            reqs.append(r)
            live += 1
        loop.step()
    if tracer:
        tracer.stop()
        traced_done = tracer
    if traced_done:
        rec["trace"] = traced_done.read()
    end = base + seconds
    rec["steps"] = [s for t, s in loop.step_s if base <= t < end]
    window = [r for r in reqs if r.due < end
              and not (r.done and r.times and r.times[-1] < base)]
    return {"requests": reqs, "window": window, "base": base}


def p95(xs) -> float:
    xs = sorted(xs)
    if not xs:
        return math.nan
    return xs[min(len(xs) - 1, int(math.ceil(0.95 * len(xs))) - 1)]


def served(r: Tracked) -> bool:
    h = r.handle
    return h is not None and h.done and not h.failed \
        and h.finish_reason in ("length", "eos")


def sample(reqs: List[Tracked], seed: int, n: int) -> List[Tracked]:
    """`n` served requests drawn from the seed, the longest among them."""
    ok = [r for r in reqs if served(r)]
    if not ok:
        return []
    longest = max(range(len(ok)), key=lambda i: len(ok[i].times))
    rest = [i for i in range(len(ok)) if i != longest]
    rng = np.random.RandomState(mix_seed(seed, 30) % (2 ** 32))
    pick = rng.choice(len(rest), min(n - 1, len(rest)), replace=False) \
        if rest else []
    return [ok[longest]] + [ok[rest[i]] for i in sorted(pick)]


def logit_gaps(ref, prompt: np.ndarray, toks: List[int], dev,
               lower=None) -> torch.Tensor:
    """Per served token, the gap by which its reference logit lies below
    the reference's best at its position; with `lower` (a reference in a
    lower precision), the gap of the token that `lower` puts first."""
    ids = torch.as_tensor(np.concatenate([prompt, toks[:-1]]).astype(
        np.int64), device=dev)[None]
    P = prompt.size
    lg = ref.logits(ids)[0, P - 1:]
    best = lg.max(-1).values
    if lower is None:
        pick = torch.as_tensor(toks, device=dev)
    else:
        pick = lower.logits(ids)[0, P - 1:].argmax(-1)
    return (best - lg.gather(1, pick[:, None])[:, 0]).cpu()


def route_flips(ref, other, prompt: np.ndarray, toks: List[int],
                dev) -> tuple:
    """(rows, all rows): the tokens times MoE layers at which `other`
    chooses another set of experts than `ref` does, over one served
    request."""
    ids = torch.as_tensor(np.concatenate([prompt, toks[:-1]]).astype(
        np.int64), device=dev)[None]
    ref.routes, other.routes = [], []
    ref.logits(ids)
    other.logits(ids)
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(ref.routes, other.routes))
    rows = sum(a.shape[0] for a in ref.routes)
    ref.routes = other.routes = None
    return flips, rows


def gap_summary(gaps: List[torch.Tensor]) -> dict:
    g = torch.cat(gaps).double()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], dtype=g.dtype))
    return {"max": float(g.max()), "p99": float(q[2]), "p90": float(q[1]),
            "p50": float(q[0]), "mean": float(g.mean()),
            "share_over_0.1": float((g > 0.1).double().mean()),
            "tokens": int(g.numel())}


def run(cell, seed: int, seconds: float, traced: bool, dev, readers: dict,
        t_start: float, control: bool = False) -> dict:
    mix = cell.mix
    dev = torch.device(dev)
    m, eng = build(cell, seed, dev)
    rec = {"kind": "serve", "cell": cell, "device": dev, "model": m,
           "engine": eng}
    win = (open_window if mix["loop"] == "open" else closed_window)(
        cell, eng, seed, seconds, traced, rec)
    setup_s = rec["setup_end"] - t_start
    reqs, window, base = win["requests"], win["window"], win["base"]
    end = base + seconds
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    e2e = {"setup_s": setup_s}
    failed = sum(1 for r in window if r.rejected or
                 (r.handle is not None and r.handle.failed))
    unfinished = sum(1 for r in window if not r.done)
    if mix["loop"] == "open":
        missing = (seconds + mix["drain_s"]) * 1e3
        ttft = [(r.times[0] - r.due) * 1e3 if served(r) and r.times
                else missing for r in window]
        itl = [(b - a) * 1e3 for r in window if served(r)
               for a, b in zip(r.times, r.times[1:])]
        rec.update({"ttft_p95_ms": p95(ttft), "itl_p95_ms": p95(itl)})
    tokens = sum(1 for r in reqs for t in r.times if base <= t < end)
    e2e[mix.get("tokens_metric", "serve_tokens_per_s")] = tokens / seconds
    rec.update({"window_s": seconds, "tokens": tokens})
    per_layer = {}
    if traced:
        for name, mod in readers.items():
            v = mod.read(rec)
            if v is not None:
                per_layer[name] = v
    picked = [(r.arrival.prompt, r.handle.tokens)
              for r in sample(window, seed, mix["sample_requests"])]
    traced_rec = rec.get("trace")
    rec.clear()
    del m, eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_model.set_exact()
    w = Weights(cell.config, seed, dev,
                getattr(torch, mix["param_dtype"]) if dev.type == "cuda"
                else torch.float32).all()
    ref = ref_model.Reference(cell.config, w)
    low = ref_model.Reference(cell.config, w, fp8=True) if control else None
    mid = ref_model.Reference(cell.config, w, bf16=True) if control \
        else None
    gaps = gap_summary([logit_gaps(ref, p, t, dev) for p, t in picked]) \
        if picked else {"max": math.inf}
    out = {"attempted": len(window), "failed": failed,
           "end_to_end": e2e, "per_layer": per_layer,
           "memory_peak_bytes": peak,
           "numbers": {"logit_gap": gaps["max"],
                       "logit_gap_mean": gaps.get("mean", math.inf),
                       "unfinished": float(unfinished)},
           "detail": {"sampled": len(picked), "gaps": gaps,
                      "window_requests": len(window), "tokens": tokens},
           "trace": traced_rec}
    if control:
        out["control_gaps"] = gap_summary(
            [logit_gaps(ref, p, t, dev, low) for p, t in picked])
        # the witness: the reference itself with bf16 products, the
        # program's precision, read as the control is
        out["bf16_gaps"] = gap_summary(
            [logit_gaps(ref, p, t, dev, mid) for p, t in picked])
        if cell.config.get("num_local_experts"):
            f = [route_flips(ref, mid, p, t, dev) for p, t in picked]
            out["bf16_route_flips"] = [sum(a for a, _ in f),
                                       sum(b for _, b in f)]
    return out
