"""Seeded chaos-campaign driver for the port's process tier, ported
from the JAX package's ``tools/chaosd.py``.

``loadgen --mp-smoke`` proves the tier serves; this driver proves it
SURVIVES.  A campaign is a deterministic sequence of disruptive events
— worker SIGKILLs (crash), worker SIGSTOPs (hang: the process exists
but stops answering), supervisor-side fault plans (``serve.handoff``
errors, ``serve.transport`` torn frames), and elastic resizes — fired
mid-stream against a live ``ProcRouter`` under open-loop Poisson load,
with the standing invariants re-asserted after every event:

* **bitwise** — every stream completes and matches the single-engine
  reference token for token (kills and hangs replay on survivors, the
  respawned worker adopts at a step boundary);
* **program sets fixed** — every live worker's ``compiled_counts()``
  stays within (1, 1) (chaos never makes or captures a program twice);
* **no orphan processes** — every process the fabric ever spawned is
  either an adopted pool member or reaped (``poll() is not None``);
* **flight refs resolve** — every incident committed to the record
  store points at a dump file that exists.

Determinism contract: the event schedule is a pure function of the
seed (blake2b over ``(seed, field, event index)``), so
:func:`plan_events` recomputed from a ``chaos_campaign`` record's
``seed``/``events`` fields reproduces exactly the kills, hangs, fault
plans and resizes the record claims; :func:`plan_events`,
:func:`composition`, :data:`EVENT_KINDS` and :data:`FAULT_PLANS` are
the reference's.  Wall-clock timing is not part of the contract.

    python -m singa_tpu_torch.tools.chaosd --seed 19 --events 6
    python -m singa_tpu_torch.tools.chaosd --smoke   # 1 kill + 1 hang
    python -m singa_tpu_torch.tools.loadgen --chaos-campaign --seed 19

Each worker is a fresh interpreter building
``singa_tpu_torch.tools.loadgen:tier_model`` (``--config``,
``--layers``, seed 0) on ``--device`` (``auto`` = the card, raising
without one; ``cpu`` when asked for).  On the card every worker holds
its own CUDA context, and a SIGSTOPped worker keeps its context and
memory until the supervisor kills it, while its replacement starts on
the same card: size the model so that the contexts fit (the smoke on
the card serves base() cut to 2 layers).  The workers serve bf16
weights on the card, as the reference engine here does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import threading
import time
from typing import Dict, List, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: what a campaign may do to the tier, in schedule-derivation order
EVENT_KINDS = ("kill", "hang", "fault", "resize")

#: the supervisor-side fault plans a ``fault`` event cycles through —
#: all REQUEST-PRESERVING seams (the router replays; streams stay
#: bitwise), which is exactly why they belong under load
FAULT_PLANS = (
    "serve.handoff=error:p=0.4",
    "serve.transport=torn_frame:at=1",
    "serve.handoff=hang:p=0.2,delay=0.05",
)

#: snappy RPC deadlines for chaos runs: hang DETECTION is the thing
#: under test, so a wedged worker must be declared dead in seconds
#: (the defaults in supervisor._OP_TIMEOUTS trade latency for
#: tolerance of loaded hosts).  The reference's values
CHAOS_OP_TIMEOUTS = {"heartbeat": 2.0, "health": 5.0, "tick": 8.0,
                     "handoff": 10.0}
#: a fresh worker's first ticks make and capture its programs — keep
#: the escalated budget for them (a respawned worker on the card pays
#: its interpreter start, CUDA init, the build and the captures).  On
#: an H100 with base() cut to 2 layers both tables hold as they are: a
#: SIGSTOP is declared at the 8 s tick deadline and a replacement is
#: adopted about 8-9 s after a death (PERF.md, section 6)
CHAOS_COMPILE_TIMEOUT_S = 120.0

#: engine shape every campaign worker (and the reference engine) uses;
#: max_len covers shared prefix (16) + longest private suffix (16) +
#: largest output budget (8)
ENGINE_KW = dict(num_slots=4, max_len=48, block_size=8)
_PROMPT_LENS = (6, 10, 16)
_NEW_TOKENS = (4, 8)

SMOKE_SEED = 7


def _det_u32(seed: int, *parts) -> int:
    """Deterministic u32 from (seed, parts) — blake2b like
    ``FaultPlan._det_uniform``, stable across processes and
    PYTHONHASHSEED."""
    text = ":".join([str(int(seed))] + [str(p) for p in parts])
    h = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(h[:4], "big")


def plan_events(seed: int, n_events: int) -> List[dict]:
    """The campaign's event schedule — a PURE function of the seed, so
    a committed record's schedule is recomputable forever."""
    events = []
    for i in range(n_events):
        kind = EVENT_KINDS[_det_u32(seed, "kind", i) % len(EVENT_KINDS)]
        ev = {"i": i, "kind": kind}
        if kind in ("kill", "hang"):
            ev["role"] = ("prefill",
                          "decode")[_det_u32(seed, "role", i) % 2]
        elif kind == "fault":
            ev["plan"] = FAULT_PLANS[_det_u32(seed, "plan", i)
                                     % len(FAULT_PLANS)]
        else:
            ev["decode"] = 1 + _det_u32(seed, "nd", i) % 2
        events.append(ev)
    return events


def composition(events: List[dict]) -> Dict[str, int]:
    """Event counts by kind — what a ``chaos_campaign`` record's
    kills/hangs/fault_plans/resizes fields must equal for its seed."""
    out = {k: 0 for k in EVENT_KINDS}
    for ev in events:
        out[ev["kind"]] += 1
    return out


# -- event firing ------------------------------------------------------------

def _victim(tier, role: str, seed: int, i: int, *,
            warmed_only: bool = False):
    """Deterministically pick a target worker of ``role`` (falls back
    to the other pool if that role has no alive worker — a campaign
    event never no-ops just because an earlier event emptied a pool).
    ``warmed_only`` restricts to workers past their compile-warmup
    ticks, so a SIGSTOP is detected on the fast steady-state deadline
    rather than the compile-escalated one."""
    from ..serve.net import supervisor as sup

    pools = [tier.prefill if role == "prefill" else tier.decode,
             tier.decode if role == "prefill" else tier.prefill]
    for pool in pools:
        alive = sorted([w for w in pool if w.alive],
                       key=lambda w: w.name)
        if warmed_only:
            alive = [w for w in alive
                     if w.ok_ticks >= sup._WARMUP_TICKS]
        if alive:
            return alive[_det_u32(seed, "victim", i) % len(alive)]
    return None


def _fire(tier, ev: dict, seed: int) -> bool:
    """Fire one schedule event against the live tier.  Returns False
    when the event has no target YET (hang with no warmed victim) —
    the phase loop retries on a later step."""
    kind = ev["kind"]
    if kind == "kill":
        w = _victim(tier, ev["role"], seed, ev["i"])
        if w is None:
            return False
        # raw SIGKILL on the worker process — the supervisor learns of
        # it the hard way (socket error on the next RPC), which is the
        # crash path production would see
        w.proc.kill()
        return True
    if kind == "hang":
        w = _victim(tier, ev["role"], seed, ev["i"], warmed_only=True)
        if w is None or w.pid is None:
            return False
        # SIGSTOP: the process EXISTS but stops answering — only the
        # liveness layer (per-op deadlines / heartbeat probes) can
        # tell this apart from a healthy-but-slow worker
        os.kill(w.pid, signal.SIGSTOP)
        return True
    if kind == "resize":
        tier.resize(n_decode=ev["decode"])
        return True
    raise ValueError(f"unfireable event kind {kind!r}")


# -- invariants --------------------------------------------------------------

class _Clock:
    """The wall clock of a campaign's deaths and respawns: a kill or
    hang is stamped when it fires, its death when the supervisor's
    ``worker_deaths`` counter moves, its respawn when ``respawns``
    moves.  The counters move inside a tier step, which can block for
    seconds on a worker's deadline, so a thread reads them every
    ``every_s`` while the campaign runs (:meth:`start` / :meth:`stop`);
    :meth:`poll` also reads them at once."""

    def __init__(self, tier, every_s: float = 0.02):
        self.tier = tier
        self.every_s = every_s
        self.deaths = tier.metrics.worker_deaths
        self.respawns = tier.metrics.respawns
        self._fired: List[float] = []
        self._died: List[float] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: seconds from each kill/hang to the death being declared
        self.detect_s: List[float] = []
        #: seconds from each death to its replacement's adoption
        self.respawn_s: List[float] = []

    def fired(self) -> None:
        with self._lock:
            self._fired.append(time.monotonic())

    def poll(self) -> None:
        with self._lock:
            now = time.monotonic()
            m = self.tier.metrics
            while m.worker_deaths > self.deaths:
                self.deaths += 1
                self._died.append(now)
                if self._fired:
                    self.detect_s.append(now - self._fired.pop(0))
            while m.respawns > self.respawns:
                self.respawns += 1
                if self._died:
                    self.respawn_s.append(now - self._died.pop(0))

    def _run(self) -> None:
        while not self._stop.wait(self.every_s):
            self.poll()

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaosd-clock")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        self.poll()


def _settle(tier, timeout_s: float = 240.0) -> dict:
    """Step the tier until self-healing has converged: no spawn in
    flight, nothing staged, and every role either back at its target
    size or given up on by the breaker.  Returns the final
    ``heal_state`` snapshot."""
    deadline = time.monotonic() + timeout_s
    while True:
        tier.step()
        hs = tier.heal_state()
        busy = (any(hs["spawning"].values())
                or any(hs["staged"].values()))
        sized = all(hs["breaker"][r]
                    or hs["alive"][r] >= hs["target"][r]
                    for r in ("prefill", "decode"))
        if not busy and sized:
            return hs
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"tier did not settle within {timeout_s:.0f}s: {hs}")
        time.sleep(0.05)


def check_invariants(tier, store: Optional[str]) -> List[str]:
    """The standing invariants asserted after every event (call only
    on a SETTLED tier).  Returns human-readable violations; empty
    means the tier held."""
    problems: List[str] = []
    # program sets fixed: every live worker's compiled_counts() within
    # (1, 1), its handoff program made at most once
    for w in tier.workers():
        if not w.alive:
            continue
        rep, _ = w.call({"op": "health"})
        comp = rep.get("compiles") or ()
        if any(int(c) > 1 for c in comp):
            problems.append(
                f"{w.name}: compiled_counts() grew to {list(comp)} "
                f"(program set not fixed)")
        if int(rep.get("handoff_compiles") or 0) > 1:
            problems.append(
                f"{w.name}: handoff program recompiled "
                f"({rep['handoff_compiles']} cache entries)")
    # no orphan processes: everything the fabric ever spawned is an
    # adopted pool member or reaped
    live = {w.proc.pid for w in tier.workers() if w.alive}
    for p in tier.fabric.procs:
        if p.pid not in live and p.poll() is None:
            problems.append(f"orphan worker process pid={p.pid} "
                            f"(alive but not in any pool)")
    # every committed incident's flight_ref resolves to a dump file
    if store and os.path.exists(store):
        base = os.path.dirname(os.path.abspath(store))
        with open(store, encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    problems.append(f"{store}:{ln}: unparseable record")
                    continue
                ref = (entry.get("payload") or {}).get("flight_ref")
                if ref and not os.path.exists(os.path.join(base, ref)):
                    problems.append(
                        f"{store}:{ln}: flight_ref {ref!r} does not "
                        f"resolve")
    return problems


# -- the campaign ------------------------------------------------------------

def _engine_kw(device: str) -> dict:
    """The engine shape every campaign worker and the reference engine
    use, with bf16 weights served on the card."""
    import torch
    kw = dict(ENGINE_KW)
    if device == "cuda":
        kw["param_dtype"] = torch.bfloat16
    return kw


def _ref_streams(model, workloads: List[list],
                 device: str) -> List[List[List[int]]]:
    """Per-phase reference token streams from ONE in-process engine —
    the bitwise ground truth every tier stream is held to."""
    from ..serve import ServeEngine

    eng = ServeEngine(model, **_engine_kw(device))
    try:
        refs = []
        for wl in workloads:
            phase = []
            for a in wl:
                h = eng.submit(a.prompt, max_new_tokens=a.max_new)
                while not h.done:
                    eng.step()
                phase.append(list(h.tokens))
            refs.append(phase)
        return refs
    finally:
        eng.close()


def run_campaign(seed: int, n_events: int, *, per_phase: int = 4,
                 rate: float = 30.0, n_prefill: int = 1,
                 n_decode: int = 2, store: Optional[str] = None,
                 forced_events: Optional[List[dict]] = None,
                 breaker_k: int = 10,
                 phase_wall_s: float = 300.0, config: str = "tiny",
                 layers: Optional[int] = None,
                 device: str = "auto") -> dict:
    """Run one seeded campaign; returns ``{"ok": bool, "payload": ...,
    "problems": [...], "timings": {...}}`` where ``payload`` is the
    (schema-valid) ``chaos_campaign`` record body and ``timings`` the
    campaign's wall clock: each phase's seconds, each worker death's
    detection seconds (from its event to the supervisor declaring the
    death) and each respawn's seconds (from the death to the adoption
    of its replacement).  ``forced_events`` overrides the seeded
    schedule (the smoke pins 1 kill + 1 hang); the record still carries
    the seed, and the schedule-vs-record assertion only applies to
    seeded runs.  The tier serves ``config`` cut to ``layers`` on
    ``device``."""
    from .. import faults
    from ..device import create_device
    from ..faults.plan import FaultPlan
    from ..obs import flight as obs_flight
    from ..obs import record as obs_record
    from ..serve import ProcRouter, QueueFull, build_proc_pools
    from .loadgen import TIER_BUILDER, build_workload, tier_model

    events = (forced_events if forced_events is not None
              else plan_events(seed, n_events))
    dev = create_device(device)
    kind = dev.torch_device.type
    model = tier_model(dev, config, layers)
    vocab = int(model.cfg.vocab_size)
    # phase 0 is event-free warmup (compiles land, caches settle),
    # then one phase per event
    workloads = [build_workload(per_phase, rate,
                                _det_u32(seed, "wl", i) % (1 << 16),
                                prompt_lens=_PROMPT_LENS,
                                new_tokens=_NEW_TOKENS, vocab=vocab)
                 for i in range(len(events) + 1)]
    refs = _ref_streams(model, workloads, kind)
    del model

    pw, dw = build_proc_pools(
        {"builder": TIER_BUILDER,
         "kwargs": {"config": config, "layers": layers, "seed": 0}},
        n_prefill, n_decode, record_store=store, device=kind,
        op_timeouts=CHAOS_OP_TIMEOUTS,
        compile_timeout_s=CHAOS_COMPILE_TIMEOUT_S, **_engine_kw(kind))
    tier = ProcRouter(pw, dw, record_store=store,
                      run_id=obs_record.new_run_id("chaosd"),
                      heartbeat_every_s=1.0, respawn_backoff_s=0.25,
                      breaker_k=breaker_k)

    counters = {k: 0 for k in EVENT_KINDS}
    requests = completed = 0
    bitwise_ok = True
    problems: List[str] = []
    clock = _Clock(tier)
    phase_s: List[float] = []

    def fire(ev: dict) -> bool:
        if not _fire(tier, ev, seed):
            return False
        counters[ev["kind"]] += 1
        if ev["kind"] in ("kill", "hang"):
            clock.fired()
        return True

    def phase(idx: int, ev: Optional[dict]) -> None:
        nonlocal requests, completed, bitwise_ok
        arrivals, want = workloads[idx], refs[idx]
        plan_installed = False
        if ev is not None and ev["kind"] == "fault":
            faults.uninstall()
            faults.install(FaultPlan.parse(ev["plan"],
                                           seed=seed + ev["i"]))
            plan_installed = True
            counters["fault"] += 1
        fired = ev is None or plan_installed
        handles: list = []
        i = 0
        t0 = time.monotonic()
        try:
            while True:
                now = time.monotonic() - t0
                while i < len(arrivals) and arrivals[i].at_s <= now:
                    try:
                        handles.append(tier.submit(
                            arrivals[i].prompt,
                            max_new_tokens=arrivals[i].max_new))
                    except QueueFull:
                        break       # still due — retried next round
                    i += 1
                if not fired and handles and tier.pending:
                    # mid-stream, by construction: requests are in
                    # flight when the event lands
                    fired = fire(ev)
                if tier.pending:
                    tier.step()
                elif i < len(arrivals):
                    time.sleep(min(arrivals[i].at_s - now, 0.05))
                else:
                    break
                if time.monotonic() - t0 > phase_wall_s:
                    raise RuntimeError(
                        f"phase {idx} exceeded {phase_wall_s:.0f}s")
        finally:
            if plan_installed:
                faults.uninstall()
        # a hang that never found a warmed victim mid-phase fires now,
        # against the settling tier (streams already complete)
        while not fired:
            tier.step()
            fired = fire(ev)
            if time.monotonic() - t0 > phase_wall_s:
                raise RuntimeError(
                    f"phase {idx}: event {ev} never became fireable")
        _settle(tier)
        phase_s.append(time.monotonic() - t0)
        requests += len(arrivals)
        for h, ref in zip(handles, want):
            done = h.finish_reason in ("eos", "length")
            completed += 1 if done else 0
            if not done or list(h.tokens) != ref:
                bitwise_ok = False
                problems.append(
                    f"phase {idx} req {h.qid}: "
                    + ("did not complete "
                       f"({h.finish_reason}, {h.error})" if not done
                       else "stream diverged from the single-engine "
                            "reference"))
        problems.extend(check_invariants(tier, store))

    clock.start()
    try:
        phase(0, None)
        for n, ev in enumerate(events):
            phase(n + 1, ev)
    finally:
        clock.stop()
        tier.close()
    # the tier is down: its processes must ALL be gone now
    for p in tier.fabric.procs:
        if p.poll() is None:
            problems.append(f"post-close orphan pid={p.pid}")
    flight_ref = obs_flight.dump_for_store(
        tier.flight, "serve.respawn", store,
        f"chaos campaign seed={seed} summary")
    payload = {
        "seed": int(seed),
        "events": len(events),
        "kills": counters["kill"],
        "hangs": counters["hang"],
        "fault_plans": counters["fault"],
        "resizes": counters["resize"],
        "respawns": int(tier.metrics.respawns),
        "reroutes": int(tier.metrics.reroutes),
        "worker_deaths": int(tier.metrics.worker_deaths),
        "requests": int(requests),
        "completed": int(completed),
        "bitwise_ok": bool(bitwise_ok),
    }
    if flight_ref:
        payload["flight_ref"] = flight_ref
    ok = bitwise_ok and not problems and completed == requests
    if store:
        platform, dev_kind = obs_record.device_kind(kind)
        entry = obs_record.new_entry(
            "chaos_campaign", platform, platform != "cuda", dev_kind,
            run_id=obs_record.new_run_id("chaos"), payload=payload)
        obs_record.RunRecord(store).append(entry)
    timings = {"phase_s": phase_s, "detect_s": clock.detect_s,
               "respawn_s": clock.respawn_s}
    return {"ok": bool(ok), "payload": payload, "problems": problems,
            "timings": timings}


#: the smoke's fixed schedule: one SIGKILL and one SIGSTOP, both aimed
#: at the decode role
SMOKE_EVENTS = ({"i": 0, "kind": "kill", "role": "decode"},
                {"i": 1, "kind": "hang", "role": "decode"})


def run_smoke(store: Optional[str] = None, *, config: str = "tiny",
              layers: Optional[int] = None, device: str = "auto"):
    """The smoke's campaign (:data:`SMOKE_EVENTS` against a 2-process
    1:1 tier serving ``config`` cut to ``layers`` on ``device``):
    ``(failures, run_campaign's result)``, no failure meaning the
    streams were bitwise, both deaths detected, both respawns adopted
    and no process orphaned."""
    forced = [dict(ev) for ev in SMOKE_EVENTS]
    res = run_campaign(SMOKE_SEED, len(forced), per_phase=3,
                       n_prefill=1, n_decode=1, store=store,
                       forced_events=forced, config=config,
                       layers=layers, device=device)
    p = res["payload"]
    fails = list(res["problems"])
    if not p["bitwise_ok"]:
        fails.append("streams diverged from the single-engine "
                     "reference")
    if p["worker_deaths"] < 2:
        fails.append(f"expected 2 worker deaths (1 kill + 1 hang), "
                     f"observed {p['worker_deaths']}")
    if p["respawns"] < 2:
        fails.append(f"expected 2 respawns adopted, observed "
                     f"{p['respawns']}")
    return fails, res


def smoke(store: Optional[str] = None, *, config: str = "tiny",
          layers: Optional[int] = None, device: str = "auto") -> int:
    """The chaos smoke (``--smoke``): :func:`run_smoke`, printed; a
    nonzero exit on any failure."""
    fails, res = run_smoke(store, config=config, layers=layers,
                           device=device)
    p = res["payload"]
    if fails:
        for f in fails:
            print(f"chaos-smoke: FAIL — {f}", file=sys.stderr)
        return 1
    t = res["timings"]
    print(f"chaos-smoke: OK — 1 kill + 1 hang against a 2-process "
          f"tier: {p['completed']}/{p['requests']} streams bitwise, "
          f"{p['respawns']} respawns adopted, "
          f"{p['reroutes']} reroutes, no orphans (detected in "
          f"{', '.join(f'{x:.2f}' for x in t['detect_s'])} s, respawned "
          f"in {', '.join(f'{x:.2f}' for x in t['respawn_s'])} s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos campaign against a live "
                    "multi-process serve tier (kills, hangs, fault "
                    "plans, resizes under Poisson load; bitwise / "
                    "program-set / no-orphan / flight-ref invariants "
                    "asserted after every event)")
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--events", type=int, default=6,
                    help="schedule length (one load phase per event, "
                         "plus an event-free warmup phase)")
    ap.add_argument("--per-phase", type=int, default=4,
                    help="Poisson arrivals per phase")
    ap.add_argument("--rate", type=float, default=30.0,
                    help="offered arrivals/s within a phase")
    ap.add_argument("--prefill", type=int, default=1)
    ap.add_argument("--decode", type=int, default=2)
    ap.add_argument("--config", default="tiny",
                    help="the served configuration (loadgen's --config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the configuration to this many layers")
    ap.add_argument("--device", default="auto",
                    help="'auto' (the card; raises without one), 'cuda' "
                         "or 'cpu'")
    ap.add_argument("--store", default=None,
                    help="record store path (default: "
                         "runs/torch/records.jsonl; incidents + the "
                         "chaos_campaign summary land here)")
    ap.add_argument("--no-record", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="fixed 1-kill + 1-hang schedule against a 1:1 "
                         "tier (no record store unless --store)")
    args = ap.parse_args(argv)
    from ..obs import record as obs_record
    store = (None if args.no_record
             else args.store
             or os.path.join(_REPO, obs_record.DEFAULT_STORE))
    model_kw = dict(config=args.config, layers=args.layers,
                    device=args.device)
    if args.smoke:
        return smoke(store=args.store if args.store else None, **model_kw)
    res = run_campaign(args.seed, args.events,
                       per_phase=args.per_phase, rate=args.rate,
                       n_prefill=args.prefill, n_decode=args.decode,
                       store=store, **model_kw)
    print(json.dumps(res["payload"], indent=2))
    if res["problems"]:
        for p in res["problems"]:
            print(f"chaosd: INVARIANT VIOLATION — {p}",
                  file=sys.stderr)
        return 1
    print(f"chaosd: OK — seed {args.seed}: {res['payload']['events']} "
          f"events ({res['payload']['kills']} kills, "
          f"{res['payload']['hangs']} hangs, "
          f"{res['payload']['fault_plans']} fault plans, "
          f"{res['payload']['resizes']} resizes), "
          f"{res['payload']['respawns']} respawns, every stream "
          f"bitwise", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
