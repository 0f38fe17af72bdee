"""SLO-aware front door of the disaggregated serving tier, ported from
``singa_tpu/serve/disagg/router.py``.

The :class:`Router` owns N prefill workers and M decode workers
(:mod:`~singa_tpu_torch.serve.disagg.worker`) and drives the whole tier from
one host loop:

* **submit** — resolves the request's SLO class to a deadline, applies
  per-tenant quotas, and offers the request to the least-loaded alive
  prefill worker.  Admission IS the existing ``Scheduler`` machinery:
  a full worker queue raises :class:`~singa_tpu_torch.serve.scheduler.
  QueueFull` (the router tries the next worker, then rejects), queued
  requests past their deadline are evicted, and overload is shed by
  ``shed_overload`` — whose eta now runs against the ROUTER's round
  cadence (``ServeEngine.tick_hint_s``), because a worker stepped once
  per round would otherwise under-estimate queue wait by
  (round / own tick) and admit doomed requests.
* **step** — one tier round: every prefill worker ticks with
  ``step(decode=False)`` (admission only), finished prefills are
  handed off to the least-loaded decode worker with capacity
  (:mod:`~singa_tpu_torch.serve.disagg.handoff` — refcounts and prefix keys
  transfer with the blocks), then every decode worker ticks.  A
  handoff the decode pool cannot absorb stays parked in its prefill
  slot (deadline eviction still guards it) — that back-pressure is the
  signal the decode pool is the bottleneck.
* **resilience** — a worker whose ``step()`` raises past the engine's
  own retry/recovery budget (or is killed via :meth:`Router.
  kill_worker`) is marked dead: its flight ring is dumped, an
  ``incident`` record with a ``flight_ref`` lands in the store, and
  every request the router had placed on it re-prefills from prompt +
  tokens-so-far on the surviving prefill pool — greedy replay makes
  the streams bitwise identical to a fault-free run.  The
  ``serve.handoff`` fault site models a worker dying MID-handoff: the
  in-flight KV is treated as lost and the request re-routes the same
  way.  Degraded modes rather than wedges: with the whole decode pool
  dead, prefill workers decode locally (co-located fallback); with the
  prefill pool dead, submits route to decode workers (every engine
  keeps both programs).
* **observability** — the router assigns each request ONE trace id
  (``<tier run_id>/q<n>``) that rides through every worker it touches,
  so the events of one request form one cross-worker timeline:
  ``serve.route`` (worker choice) → ``serve.submitted`` →
  prefill spans → ``serve.handoff`` span (src/dst) → decode
  ``serve.token`` deliveries → ``serve.evicted`` (finish).  Tier-level
  metrics: ``serve.handoffs`` counter, ``serve.handoff_ms`` histogram
  (prefill-finish → decode-inject, queueing included),
  ``serve.rerouted`` counter, ``serve.worker_dead`` counter.

Why the split: prefill chunks are compute-bound and decode ticks
weight-read bound, so the two pools are sized against different
bottlenecks — the N:M ratio trades prefill queueing (TTFT) against
decode slots (tokens/s).
"""

from __future__ import annotations

import itertools
import time
import warnings
from typing import Dict, List, Optional, Tuple, Union

from ... import faults
from ...obs import events
from ...obs import flight as obs_flight
from ...obs import record as obs_record
from ...obs import trace as obs_trace
from ...obs.events import _Hist
from ...utils import failure
from ..engine import EngineClosed
from ..scheduler import QUEUED, QueueFull, Request, RequestHandle
from .handoff import HandoffPackage
from .worker import Worker

__all__ = ["Router", "SLOClass", "QuotaExceeded", "TierMetrics"]


class QuotaExceeded(QueueFull):
    """Admission refused at the tier door: the tenant is at its
    in-flight quota.  A subclass of :class:`QueueFull` so open-loop
    load generators count it as the overload outcome it is."""


class SLOClass:
    """One named service level: requests submitted under it inherit
    its deadline (seconds; None = no deadline, the batch class), which
    the existing deadline-eviction + shed machinery then enforces —
    SLO classes are POLICY over the scheduler, not new mechanism."""

    def __init__(self, name: str, deadline_s: Optional[float]):
        self.name = str(name)
        if deadline_s is not None and float(deadline_s) <= 0:
            raise ValueError(
                f"SLO class {name!r}: deadline_s must be positive or "
                f"None, got {deadline_s}")
        self.deadline_s = None if deadline_s is None else float(deadline_s)

    def __repr__(self) -> str:
        return f"SLOClass({self.name!r}, deadline_s={self.deadline_s})"


def _merged_summary(hists: List[_Hist]) -> Optional[dict]:
    """Percentile summary across per-worker histograms: exact while
    every worker's observation count fits its sample ring (loadgen-
    scale runs), nearest-rank over the merged recent windows beyond."""
    m = _Hist()
    for h in hists:
        for v in h.samples:
            m.observe(v)
    return m.summary()


class TierMetrics:
    """Tier-wide view: the router's own counters (handoffs, reroutes,
    quota/door rejections, worker deaths) plus aggregation over every
    worker's :class:`~singa_tpu_torch.serve.metrics.ServeMetrics` — so
    ``snapshot()`` has the same shape a single engine's does, with the
    tier extras on top."""

    def __init__(self, router: "Router"):
        self._router = router
        self.handoffs = 0
        self.reroutes = 0
        self.quota_rejected = 0
        self.door_rejected = 0
        self.worker_deaths = 0
        self.steps = 0
        self._handoff = _Hist()

    # -- router-side events ------------------------------------------------
    def on_handoff(self, wait_ms: float) -> None:
        self.handoffs += 1
        self._handoff.observe(wait_ms)
        events.counter("serve.handoffs", 1)
        events.histogram("serve.handoff_ms", wait_ms)

    def on_reroute(self) -> None:
        self.reroutes += 1
        events.counter("serve.rerouted", 1)

    def on_quota_reject(self, tenant: str) -> None:
        self.quota_rejected += 1
        events.counter("serve.rejected", 1, reason="quota",
                       tenant=tenant)

    def on_door_reject(self) -> None:
        self.door_rejected += 1
        events.counter("serve.rejected", 1, reason="tier_full")

    def on_worker_death(self, worker: str) -> None:
        self.worker_deaths += 1
        events.counter("serve.worker_dead", 1, worker=worker)

    def on_step(self) -> None:
        self.steps += 1

    def handoff_summary(self) -> Optional[dict]:
        return self._handoff.summary()

    # -- tier aggregation --------------------------------------------------
    def snapshot(self) -> dict:
        workers = self._router.prefill + self._router.decode
        snaps = [w.engine.metrics.snapshot() for w in workers]

        def total(key: str) -> int:
            return sum(s[key] for s in snaps)

        def merge(key: str) -> Dict[str, int]:
            out: Dict[str, int] = {}
            for s in snaps:
                for k, v in s[key].items():
                    out[k] = out.get(k, 0) + v
            return out

        spec_proposed = total("spec_proposed")
        disp = sum(s["slot_dispatches"] for s in snaps)
        disp_tokens = sum(s["slot_dispatch_tokens"] for s in snaps)
        return {
            "submitted": total("submitted"),
            # speculative decoding: tier-wide accept/dispatch
            # accounting — decode workers carry the draft, so the tier
            # headline aggregates their verify rounds
            "spec_rounds": total("spec_rounds"),
            "spec_proposed": spec_proposed,
            "spec_accepted": total("spec_accepted"),
            "spec_fallbacks": total("spec_fallbacks"),
            "accept_rate": (total("spec_accepted") / spec_proposed
                            if spec_proposed else None),
            "tokens_per_dispatch": (disp_tokens / disp if disp else None),
            "admitted": total("admitted"),
            # rejections are counted at the TIER door only: a worker's
            # own rejected counter ticks on every QueueFull the router
            # absorbs while trying the next worker, so summing those
            # would count one refused request once per attempted worker
            "rejected": self.quota_rejected + self.door_rejected,
            "evicted": merge("evicted"),
            "retries": merge("retries"),
            "quarantined": total("quarantined"),
            "recoveries": total("recoveries"),
            "preempted": total("preempted"),
            "prefix_hits": total("prefix_hits"),
            "prefix_hit_tokens": total("prefix_hit_tokens"),
            "steps": self.steps,
            "ttft_ms": _merged_summary(
                [w.engine.metrics._ttft for w in workers]),
            "token_ms": _merged_summary(
                [w.engine.metrics._token for w in workers]),
            "handoffs": self.handoffs,
            "handoff_ms": self.handoff_summary(),
            "reroutes": self.reroutes,
            "worker_deaths": self.worker_deaths,
        }


class Router:
    """Front door + tick loop of a prefill/decode worker tier; see the
    module docstring for the architecture.

        pw, dw = build_pools(model, 3, 1, num_slots=4, max_len=64)
        tier = Router(pw, dw,
                      slo_classes={"interactive": SLOClass("interactive",
                                                           5.0)},
                      tenant_quota=8)
        h = tier.submit(prompt, max_new_tokens=32, tenant="acme",
                        slo="interactive")
        tier.run_until_idle()
    """

    def __init__(self, prefill_workers: List[Worker],
                 decode_workers: List[Worker], *,
                 slo_classes: Optional[Dict[str, SLOClass]] = None,
                 tenant_quota: Union[None, int, Dict[str, int]] = None,
                 record_store: Optional[str] = None,
                 run_id: Optional[str] = None):
        self.prefill = list(prefill_workers)
        self.decode = list(decode_workers)
        if not self.prefill or not self.decode:
            raise ValueError("a tier needs at least one prefill and one "
                             "decode worker")
        names = [w.name for w in self.prefill + self.decode]
        if len(set(names)) != len(names):
            raise ValueError(f"worker names must be unique, got {names}")
        self.slo_classes = dict(slo_classes or {})
        for name, cls in self.slo_classes.items():
            if not isinstance(cls, SLOClass):
                raise ValueError(f"slo_classes[{name!r}] must be an "
                                 f"SLOClass, got {type(cls).__name__}")
        self.tenant_quota = tenant_quota
        self.record_store = record_store
        self.run_id = run_id or obs_record.new_run_id("tier")
        self.metrics = TierMetrics(self)
        self._seq = itertools.count()
        self._incident_seq = itertools.count()
        # the router's own host-side mirror of where every live request
        # is — worker death re-routes from HERE, never by reaching into
        # a dead engine (in a real deployment the dead worker's state
        # is simply gone; the mirror is what survives)
        self._handles: Dict[int, Tuple[RequestHandle,
                                       Optional[str]]] = {}
        self._where: Dict[int, Worker] = {}
        self._ready_at: Dict[int, float] = {}   # rid -> prefill-done t
        self._tick_ewma: Optional[float] = None
        self._draining = False
        self._closed = False

    # -- introspection -----------------------------------------------------
    @property
    def pending(self) -> int:
        """Requests queued or running anywhere in the tier (dead
        workers excluded — their requests were re-routed)."""
        return sum(w.engine.pending
                   for w in self.prefill + self.decode if w.alive)

    def worker(self, name: str) -> Worker:
        for w in self.prefill + self.decode:
            if w.name == name:
                return w
        raise KeyError(f"no worker named {name!r} "
                       f"(have: {[w.name for w in self.prefill + self.decode]})")

    def tier_stats(self) -> dict:
        """The per-pool ``serve_load`` record fields (obs/schema.py
        ``_SERVE_TIER_FIELDS``)."""
        summ = self.metrics.handoff_summary() or {}
        return {
            "prefill_workers": len(self.prefill),
            "decode_workers": len(self.decode),
            "handoffs": self.metrics.handoffs,
            "handoff_p99_ms": round(summ.get("p99", 0.0), 3),
        }

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids, *, max_new_tokens: int,
               tenant: Optional[str] = None,
               slo: Optional[str] = None,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_token=None) -> RequestHandle:
        """Admit one request into the tier.  ``slo`` names a registered
        :class:`SLOClass` (its deadline applies unless ``deadline_s``
        overrides); ``tenant`` is the quota key.  Raises
        :class:`QuotaExceeded` at the tenant quota, :class:`QueueFull`
        when every prefill worker's queue refuses (the scheduler's
        admission backpressure, surfaced through the tier door), and
        ``ValueError`` for an unregistered SLO class."""
        if self._closed:
            raise EngineClosed("submit() on a closed tier")
        if self._draining:
            raise EngineClosed("tier is draining — new submissions are "
                               "refused while in-flight requests complete")
        faults.fire("serve.router", tenant=tenant or "", slo=slo or "")
        if slo is not None:
            cls = self.slo_classes.get(slo)
            if cls is None:
                raise ValueError(
                    f"unknown SLO class {slo!r} (registered: "
                    f"{sorted(self.slo_classes)})")
            if deadline_s is None:
                deadline_s = cls.deadline_s
        if tenant is not None:
            quota = self._quota_for(tenant)
            if quota is not None and self._tenant_live(tenant) >= quota:
                self.metrics.on_quota_reject(tenant)
                raise QuotaExceeded(
                    f"tenant {tenant!r} is at its in-flight quota "
                    f"({quota}); request rejected")
        trace_id = f"{self.run_id}/q{next(self._seq)}"
        for w in self._route_order(self._prefill_pool()):
            try:
                h = w.engine.submit(prompt_ids,
                                    max_new_tokens=max_new_tokens,
                                    deadline_s=deadline_s, eos_id=eos_id,
                                    on_token=on_token, trace_id=trace_id)
            except QueueFull:
                continue
            with obs_trace.activate(trace_id):
                events.counter("serve.route", 1, worker=w.name,
                               role=w.role)
            self._handles[h.rid] = (h, tenant)
            self._where[h.rid] = w
            return h
        self.metrics.on_door_reject()
        raise QueueFull(
            "every prefill worker's queue is at capacity; request "
            "rejected — shed load, raise max_queue, or add workers")

    def _quota_for(self, tenant: str) -> Optional[int]:
        q = self.tenant_quota
        if q is None:
            return None
        if isinstance(q, dict):
            return q.get(tenant)
        return int(q)

    def _tenant_live(self, tenant: str) -> int:
        return sum(1 for h, t in self._handles.values()
                   if t == tenant and not h.done)

    def _prefill_pool(self) -> List[Worker]:
        """Workers that accept new prompts: the alive prefill pool, or
        (degraded: prefill pool gone) the alive decode pool — every
        engine keeps both compiled programs, so a collapsed tier keeps
        serving co-located instead of wedging."""
        alive = [w for w in self.prefill if w.alive]
        return alive or [w for w in self.decode if w.alive]

    @staticmethod
    def _route_order(pool: List[Worker]) -> List[Worker]:
        """Least-loaded first; name breaks ties so routing is
        deterministic for a given tier state."""
        return sorted(pool, key=lambda w: (w.load, w.name))

    # -- the tier round ----------------------------------------------------
    def step(self) -> int:
        """One tier round: prefill ticks → handoffs → decode ticks →
        cadence hint.  Returns tokens delivered across the tier."""
        if self._closed:
            raise EngineClosed("step() on a closed tier")
        t0 = time.monotonic()
        delivered = 0
        with events.span("serve.tier_step"):
            self._prune()
            decode_alive = [w for w in self.decode if w.alive]
            for w in [p for p in self.prefill if p.alive]:
                # degraded co-location: with the decode pool gone, the
                # prefill workers decode their own slots
                delivered += self._step_worker(w, decode=not decode_alive)
            self._drain_prefills()
            for w in decode_alive:
                if w.alive:
                    delivered += self._step_worker(w, decode=True)
            if not any(w.alive for w in self.prefill + self.decode) \
                    and self.pending:
                raise RuntimeError(
                    "every worker in the tier is dead; cannot serve "
                    "the remaining requests")
            dt = time.monotonic() - t0
            self._tick_ewma = dt if self._tick_ewma is None else \
                0.8 * self._tick_ewma + 0.2 * dt
            # the shed eta's admission cadence is the ROUTER round, not
            # one worker's own tick (scheduler.eta_first_token)
            for w in self.prefill + self.decode:
                w.engine.tick_hint_s = self._tick_ewma
            self.metrics.on_step()
        return delivered

    def _step_worker(self, w: Worker, decode: bool) -> int:
        try:
            return w.engine.step(decode=decode)
        except (RuntimeError, OSError) as e:
            if isinstance(e, failure.FailureDetected):
                raise
            # the engine exhausted its OWN retry/recovery budget — at
            # the tier level that is a worker death, not a crash
            self._worker_death(w, f"step: {type(e).__name__}: {e}")
            return 0

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        n = 0
        while self.pending:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def drain(self, max_steps: Optional[int] = None) -> None:
        """Refuse new submissions and complete everything in flight."""
        self._draining = True
        self.run_until_idle(max_steps=max_steps)

    def close(self) -> None:
        """Drain, then close every alive worker engine (dead workers'
        engines are abandoned — their requests were re-routed).
        Idempotent."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        for w in self.prefill + self.decode:
            if w.alive:
                w.engine.close()

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- handoff -----------------------------------------------------------
    def _drain_prefills(self) -> None:
        """Move every finished prefill whose KV a decode worker can
        hold; the rest stay parked (their deadline still ticks)."""
        now = time.monotonic()
        decode_alive = [w for w in self.decode if w.alive]
        if not decode_alive:
            return
        for w in [p for p in self.prefill if p.alive]:
            for slot, req in w.engine.running_items():
                if req.rid not in self._ready_at:
                    self._ready_at[req.rid] = now
                probe = HandoffPackage(
                    req=req, kv=None, pos=0,
                    n_blocks=w.engine.pool.mapped_count(slot),
                    prompt_keys=w.engine._req_keys(req)[
                        :req.prompt.size // w.engine.pool.block_size])
                dst = next(
                    (d for d in self._route_order(decode_alive)
                     if d.engine.can_accept_handoff(probe)), None)
                if dst is None:
                    continue
                self._handoff(w, slot, req, dst)

    def _handoff(self, src: Worker, slot: int, req: Request,
                 dst: Worker) -> None:
        ready = self._ready_at.get(req.rid)
        wait_ms = 0.0 if ready is None else \
            (time.monotonic() - ready) * 1e3
        try:
            with obs_trace.activate(req.trace_id):
                with events.span("serve.handoff", src=src.name,
                                 dst=dst.name, rid=req.rid):
                    faults.fire("serve.handoff", rid=req.rid,
                                src=src.name, dst=dst.name)
                    pkg = src.engine.extract_handoff(slot)
                    ok = dst.engine.inject_handoff(pkg)
        except (RuntimeError, OSError) as e:
            if isinstance(e, failure.FailureDetected):
                raise
            self._reroute(req, src,
                          f"handoff {src.name}->{dst.name}: "
                          f"{type(e).__name__}: {e}")
            return
        if not ok:
            # capacity vanished between probe and inject (defensive —
            # the tier loop is single-threaded): replay from prompt
            self._requeue_prefill(req)
            return
        self._ready_at.pop(req.rid, None)
        self._where[req.rid] = dst
        self.metrics.on_handoff(wait_ms)

    # -- re-routing + worker death ----------------------------------------
    def _reroute(self, req: Request, src: Worker, reason: str) -> None:
        """A handoff died with the KV in flight: the blocks are treated
        as lost and the request re-prefills from prompt + tokens-so-far
        on the prefill pool — greedy replay keeps its stream bitwise
        identical (the same argument as preemption/recovery)."""
        self.metrics.on_reroute()
        if req.slot is not None and src.alive:
            # the fault fired before extraction — the request is still
            # occupying its source slot; release it
            src.engine.withdraw(req.slot)
        warnings.warn(f"disagg: re-routing request {req.rid} "
                      f"({reason}); it will re-prefill from prompt",
                      stacklevel=2)
        self._requeue_prefill(req)
        self._incident("serve.handoff", reason, f"req:{req.rid}",
                       "rerouted", 0,
                       flight_ref=self._flight_dump("serve.handoff", src,
                                                    reason))

    def _requeue_prefill(self, req: Request) -> None:
        self._ready_at.pop(req.rid, None)
        pool = self._prefill_pool()
        if not pool:
            raise RuntimeError(
                f"no alive worker to re-route request {req.rid} to")
        w = self._route_order(pool)[0]
        req.state = QUEUED
        req.slot = None
        # requeue_front: the request was already admitted once — it
        # keeps its FIFO priority and bypasses max_queue backpressure
        w.engine.sched.requeue_front([req])
        self._where[req.rid] = w

    def kill_worker(self, name: str, reason: str = "killed") -> None:
        """Operations/chaos hook: declare ``name`` dead now — its
        flight ring is dumped, an incident records the death, and every
        request the router had placed on it re-routes."""
        self._worker_death(self.worker(name), reason)

    def _worker_death(self, w: Worker, reason: str) -> None:
        if not w.alive:
            return
        w.alive = False
        self.metrics.on_worker_death(w.name)
        warnings.warn(f"disagg: worker {w.name} died ({reason}); "
                      f"re-routing its in-flight requests", stacklevel=2)
        # the dead worker's ring is the incident evidence: its last-N
        # events (prefill/decode/handoff notes) travel with the record
        ref = self._flight_dump("serve.router", w,
                                f"worker {w.name} death: {reason}")
        victims = []
        for rid, (h, _) in list(self._handles.items()):
            if self._where.get(rid) is w and not h.done:
                # same-package access: the handle's request IS the
                # router's host-side mirror of the lost worker state
                victims.append(h._req)
        # requeue_front prepends, so victims are re-queued NEWEST
        # first: after the loop the oldest rid sits at the head and
        # FIFO priority survives the death (two victims landing on the
        # same survivor keep their original order)
        for req in sorted(victims, key=lambda r: r.rid, reverse=True):
            self._requeue_prefill(req)
        self._incident("serve.router", "worker_death", w.name,
                       "rerouted", len(victims), flight_ref=ref)

    def _prune(self) -> None:
        """Drop finished requests from the mirror (bounded memory over
        long-lived tiers)."""
        for rid, (h, _) in list(self._handles.items()):
            if h.done:
                self._handles.pop(rid, None)
                self._where.pop(rid, None)
                self._ready_at.pop(rid, None)

    # -- durable incident records + flight dumps ---------------------------
    def _flight_dump(self, site: str, worker: Worker,
                     reason: str) -> Optional[str]:
        """Dump ``worker``'s flight ring next to the record store and
        return the ``flight_ref`` (None without a store) — the same
        :func:`obs.flight.dump_for_store` contract as the engine's;
        literal sites at call sites stay SGL009-checkable."""
        return obs_flight.dump_for_store(worker.engine.flight, site,
                                         self.record_store, reason)

    def _incident(self, site: str, fault: str, ref, outcome: str,
                  retries: int, flight_ref: Optional[str] = None) -> None:
        """Append one ``incident`` entry (mirrors
        ``ServeEngine._incident`` — best-effort, never a crash)."""
        events.counter("serve.incident", 1, site=site, outcome=outcome)
        if not self.record_store:
            return
        try:
            platform, kind = obs_record.device_kind(
                self.prefill[0].engine._device)
            payload = {"site": site, "fault": fault, "ref": ref,
                       "outcome": outcome, "retries": int(retries),
                       "engine_run": self.run_id}
            if flight_ref:
                payload["flight_ref"] = flight_ref
            entry = obs_record.new_entry(
                "incident", platform, platform != "cuda", kind,
                run_id=f"{self.run_id}-inc{next(self._incident_seq)}",
                payload=payload)
            obs_record.RunRecord(self.record_store).append(entry)
        except Exception as e:
            warnings.warn(f"could not append incident record: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
