"""The one traffic generator every serving mix goes through.

A copy of the program's ``tools/loadgen.build_workload`` idea (seeded
Poisson arrivals, tenants behind shared system prompts, private
suffixes), with heavy-tailed lengths read from the mix file.  Every seed
gets the same set of sizes and gaps in another order: the sizes come
from the mix's ``population_seed``, the order and the token ids from the
run's seed, so runs of different seeds do the same work.

A mix's lengths are ``{"median": m, "sigma": s, "min": a, "max": b}``
(lognormal, rounded and clipped) or ``{"uniform": [a, b]}`` (inclusive).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .weights import mix as mix_seed

PHASES = {"warm": 1, "window": 2, "tail": 3}


@dataclass
class Arrival:
    due_s: float                # due time from the window's start
    prompt: np.ndarray          # int32 ids
    max_new: int
    tenant: int
    phase: str


def lengths(rng: np.random.RandomState, n: int, spec: dict) -> np.ndarray:
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return rng.randint(lo, hi + 1, n)
    z = rng.standard_normal(n)
    x = np.round(np.exp(np.log(spec["median"]) + spec["sigma"] * z))
    return np.clip(x, spec["min"], spec["max"]).astype(np.int64)


def _rng(seed: int, *salt: int) -> np.random.RandomState:
    return np.random.RandomState(mix_seed(seed, *salt) % (2 ** 32))


def system_prompts(mix: dict, seed: int, vocab: int) -> List[np.ndarray]:
    r = _rng(seed, 10)
    return [r.randint(0, vocab, mix["system_len"]).astype(np.int32)
            for _ in range(mix.get("tenants", 0))]


def requests(mix: dict, seed: int, phase: str, n: int, vocab: int,
             span_s: float = 0.0, start_s: float = 0.0,
             systems: Optional[List[np.ndarray]] = None) -> List[Arrival]:
    """`n` requests of `phase`.  Sizes, tenants and gaps are the mix's
    fixed population for that phase; the run's seed orders them and
    draws the tokens.  In an open loop (`span_s` > 0) the gaps, scaled to
    fill `span_s`, set each request's due time from `start_s`."""
    if n <= 0:
        return []
    pop = _rng(mix["population_seed"], PHASES[phase])
    prompt_spec = mix.get("suffix", mix.get("prompt"))
    plen = lengths(pop, n, prompt_spec)
    olen = lengths(pop, n, mix["output"])
    tenants = mix.get("tenants", 0)
    ten = pop.randint(0, tenants, n) if tenants else np.full(n, -1)
    gaps = pop.exponential(1.0, n + 1)
    run = _rng(seed, 20, PHASES[phase])
    order = run.permutation(n)
    gaps = gaps[np.concatenate([run.permutation(n), [n]])]
    due = start_s + span_s * np.cumsum(gaps)[:-1] / gaps.sum() \
        if span_s > 0 else np.full(n, start_s)
    out = []
    for j, i in enumerate(order):
        suffix = run.randint(0, vocab, int(plen[i])).astype(np.int32)
        t = int(ten[i])
        prompt = np.concatenate([systems[t], suffix]) if t >= 0 else suffix
        out.append(Arrival(float(due[j]), prompt, int(olen[i]), t, phase))
    return out


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> List[Arrival]:
    """Warm-up arrivals before the window, the window's, and the tail's
    after it (which keep the load on while the window's requests end),
    at the mix's fixed rate."""
    rate = mix["rate_rps"]
    systems = system_prompts(mix, seed, vocab)
    out = []
    for phase, span, start in (("warm", mix["warm_s"], -mix["warm_s"]),
                               ("window", seconds, 0.0),
                               ("tail", mix["drain_s"], seconds)):
        out += requests(mix, seed, phase, int(round(rate * span)), vocab,
                        span, start, systems)
    return out


def closed_pool(mix: dict, seed: int, vocab: int) -> List[Arrival]:
    """The batch job's requests, in the order they are handed out."""
    return requests(mix, seed, "window", mix["pool"], vocab,
                    systems=system_prompts(mix, seed, vocab))
