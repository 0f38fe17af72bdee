"""Serving telemetry: queue/slot gauges, admission counters, latency
histograms — all through the shared ``obs.events`` layer, so a single
``SINGA_OBS=/path.jsonl`` env var captures training AND serving events
in one stream.  A copy of ``singa_tpu/serve/metrics.py``: the names and
attributes are the reference's, so one query reads either package's
stream.

Metric names:

==========================  =========  ==================================
name                        kind       meaning
==========================  =========  ==================================
``serve.submitted``         counter    requests accepted by submit()
``serve.admitted``          counter    first prefill into a slot (recovery
                                       re-prefills count under
                                       ``serve.recoveries``)
``serve.rejected``          counter    refused at submit (queue full)
``serve.evicted``           counter    left the system — a slot vacated
                                       (``eos``/``length``/``deadline``)
                                       or a queued request dropped at
                                       its deadline or shed under
                                       overload (``reason`` attr)
``serve.retries``           counter    one transient dispatch failure
                                       retried with backoff (``site``)
``serve.quarantined``       counter    a request the engine gave up on
                                       (failed handle status)
``serve.recoveries``        counter    arena reset + replay of
                                       in-flight requests
``serve.preempted``         counter    a running request released its
                                       blocks to an exhausted pool and
                                       re-queued (replayed later,
                                       stream unchanged)
``serve.prefix_hits``       counter    an admission mapped >= 1 resident
                                       shared-prefix block copy-free
``serve.prefix_hit_tokens`` counter    prompt tokens whose prefill was
                                       SKIPPED via the prefix cache
``serve.queue_depth``       gauge      waiting requests, after each step
``serve.active_slots``      gauge      live slots, after each step
``serve.blocks_in_use``     gauge      referenced KV blocks, after each
                                       step (the paged-arena footprint)
``serve.blocks_in_use_bytes``  gauge   device bytes those blocks pin —
                                       target + draft arenas, int8
                                       codes AND f32 scale tensors
                                       (block counts alone under-report
                                       a quantized/speculative arena)
``serve.spilled_blocks``    counter    evicted prefix blocks whose
                                       bytes landed in the host-RAM
                                       spill tier instead of dying
``serve.prefetch_hits``     counter    spilled blocks restored into the
                                       arena on a prefix hit (one per
                                       restored block)
``serve.prefetch_wait_ms``  histogram  host-side restore orchestration
                                       per prefetched block (the copies
                                       themselves run on the stream)
``serve.step``              span       one engine step (host wall clock)
``serve.prefill``           span       one prefill dispatch (+ fetch)
``serve.decode``            span       one decode dispatch (+ fetch)
``serve.verify``            span       one speculative verify round
                                       (draft propose-k + target
                                       verify in ONE dispatch + fetch;
                                       ``k`` attr)
``serve.spec_proposed``     counter    draft tokens proposed this round
                                       (k per active slot)
``serve.spec_accepted``     counter    proposals the target's own
                                       greedy picks confirmed
``serve.spec_fallbacks``    counter    verify rounds that fell back to
                                       plain decode (``serve.verify``
                                       fault past retries)
``serve.accept_rate``       histogram  per-(slot, round) accepted / k
``serve.token``             counter    one token delivered to a request
                                       (prefill first token, decode
                                       tick, recovery/preemption replay
                                       — tokens/s is derivable from the
                                       trace by counting these)
``serve.ttft_ms``           histogram  submit → first token
``serve.token_ms``          histogram  per generated token, decode path
==========================  =========  ==================================

Counters/gauges cost one attribute check when no sink is configured.
Latency aggregation is PER ENGINE: each ServeMetrics owns its own
histogram state (``snapshot()`` reads it), so two engines in one
process never reset or pollute each other's percentiles; the emitted
``serve.ttft_ms``/``serve.token_ms`` sink lines keep the documented
names (the global ``events.histogram_summary`` view then spans every
engine — by design for a whole-process dashboard).

Trace attribution: the engine activates the request's
``obs.trace`` context around each per-request section, so every line
above that is about ONE request carries its trace id — and the same
events are noted into the engine's :class:`~singa_tpu_torch.obs.flight.
FlightRecorder` ring (pass ``flight=``), which is what an incident
dump's timeline is made of.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..obs import events
from ..obs import flight as obs_flight
# per-engine aggregation state reuses the events-layer histogram
# implementation (exact totals + bounded deterministic sample ring)
from ..obs.events import _Hist

__all__ = ["ServeMetrics"]


class ServeMetrics:
    """Thin per-engine facade: exact local totals (for snapshots/tests)
    plus pass-through emission to the shared obs sink and (when given)
    the engine's flight-recorder ring."""

    def __init__(self, flight: Optional[obs_flight.FlightRecorder] = None):
        self.flight = flight
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.evicted: Dict[str, int] = {}
        self.retries: Dict[str, int] = {}
        self.quarantined = 0
        self.recoveries = 0
        self.preempted = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.steps = 0
        # KV memory hierarchy: spill-tier pressure counters
        self.spilled_blocks = 0
        self.prefetch_hits = 0
        self.prefetch_wait_ms = 0.0
        # speculative decoding: per-(slot, round) accounting
        # for the accept rate and the tokens-per-dispatch headline —
        # slot_dispatches counts per-slot participations in a decode OR
        # verify dispatch (a plain tick is the 1-token case), so
        # tokens_per_dispatch = slot_dispatch_tokens / slot_dispatches
        # is comparable across spec and plain engines
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_fallbacks = 0
        self.slot_dispatches = 0
        self.slot_dispatch_tokens = 0
        self._accept = _Hist()
        self._ttft = _Hist()
        self._token = _Hist()

    def _note(self, kind: str, name: str, **attrs) -> None:
        """Mirror one emission into the engine's flight ring (in-memory
        only; the active trace id is stamped by the recorder)."""
        if self.flight is not None:
            self.flight.note(kind, name, **attrs)

    # -- request lifecycle ------------------------------------------------
    def on_submit(self) -> None:
        self.submitted += 1
        events.counter("serve.submitted", 1)
        self._note("counter", "serve.submitted")

    def on_reject(self) -> None:
        self.rejected += 1
        events.counter("serve.rejected", 1)
        self._note("counter", "serve.rejected")

    def on_admit(self) -> None:
        self.admitted += 1
        events.counter("serve.admitted", 1)
        self._note("counter", "serve.admitted")

    def on_evict(self, reason: str) -> None:
        self.evicted[reason] = self.evicted.get(reason, 0) + 1
        events.counter("serve.evicted", 1, reason=reason)
        self._note("counter", "serve.evicted", reason=reason)

    # -- resilience ---------------------------------------------
    def on_retry(self, site: str) -> None:
        self.retries[site] = self.retries.get(site, 0) + 1
        events.counter("serve.retries", 1, site=site)
        self._note("counter", "serve.retries", site=site)

    def on_quarantine(self) -> None:
        self.quarantined += 1
        events.counter("serve.quarantined", 1)
        self._note("counter", "serve.quarantined")

    def on_recover(self, inflight: int) -> None:
        self.recoveries += 1
        events.counter("serve.recoveries", 1, inflight=inflight)
        self._note("counter", "serve.recoveries", inflight=inflight)

    def on_preempt(self) -> None:
        self.preempted += 1
        events.counter("serve.preempted", 1)
        self._note("counter", "serve.preempted")

    # -- paged arena / prefix cache ------------------------------
    def on_prefix_hit(self, tokens: int) -> None:
        self.prefix_hits += 1
        self.prefix_hit_tokens += tokens
        events.counter("serve.prefix_hits", 1)
        events.counter("serve.prefix_hit_tokens", tokens)
        self._note("counter", "serve.prefix_hits", tokens=tokens)

    # -- KV memory hierarchy / spill tier -----------------------
    def on_spill(self, blocks: int) -> None:
        """``blocks`` evicted prefix blocks spilled to host RAM instead
        of dying (their next prefix hit restores them copy-wise)."""
        self.spilled_blocks += blocks
        events.counter("serve.spilled_blocks", blocks)
        self._note("counter", "serve.spilled_blocks", blocks=blocks)

    def on_prefetch(self, blocks: int, wait_ms: float) -> None:
        """``blocks`` spilled block(s) restored on one prefix hit (the
        pool fires this once per restored block); ``wait_ms`` is the
        host-side restore orchestration time (the device copy itself
        is async-dispatched)."""
        self.prefetch_hits += blocks
        self.prefetch_wait_ms += wait_ms
        events.counter("serve.prefetch_hits", 1, blocks=blocks)
        events.histogram("serve.prefetch_wait_ms", wait_ms)
        self._note("counter", "serve.prefetch_hits", blocks=blocks,
                   wait_ms=round(wait_ms, 3))

    # -- speculative decoding -----------------------------------
    def on_spec_round(self, proposed: int, accepted: int) -> None:
        """One (slot, verify round): ``proposed`` = k draft tokens,
        ``accepted`` = how many of them the target's own greedy picks
        confirmed (the round still delivers accepted + 1 tokens — the
        correction/bonus pick is the target's, not the draft's)."""
        self.spec_rounds += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        rate = accepted / proposed if proposed else 0.0
        self._accept.observe(rate)
        events.counter("serve.spec_proposed", proposed)
        events.counter("serve.spec_accepted", accepted)
        events.histogram("serve.accept_rate", rate)
        self._note("counter", "serve.spec_accepted", accepted=accepted,
                   proposed=proposed)

    def on_spec_fallback(self) -> None:
        """A verify round died past retries and this tick ran plain
        decode instead — stream unchanged, accept rate pays later."""
        self.spec_fallbacks += 1
        events.counter("serve.spec_fallbacks", 1)
        self._note("counter", "serve.spec_fallbacks")

    def on_slot_dispatch(self, tokens: int) -> None:
        """One slot's share of one decode/verify dispatch, yielding
        ``tokens`` delivered tokens — the denominator/numerator pair of
        the ``tokens_per_dispatch`` headline."""
        self.slot_dispatches += 1
        self.slot_dispatch_tokens += tokens

    @property
    def accept_rate(self) -> Optional[float]:
        """Overall accepted / proposed (None before any verify round)."""
        if not self.spec_proposed:
            return None
        return self.spec_accepted / self.spec_proposed

    @property
    def tokens_per_dispatch(self) -> Optional[float]:
        """Delivered tokens per per-slot dispatch participation (None
        before any decode/verify tick; exactly 1.0 for a plain
        engine)."""
        if not self.slot_dispatches:
            return None
        return self.slot_dispatch_tokens / self.slot_dispatches

    # -- latency / delivery ------------------------------------------------
    def on_first_token(self, ttft_s: float) -> None:
        self._ttft.observe(ttft_s * 1e3)
        events.histogram("serve.ttft_ms", ttft_s * 1e3)
        self._note("hist", "serve.ttft_ms", value=ttft_s * 1e3)

    def on_token(self, latency_s: float) -> None:
        self._token.observe(latency_s * 1e3)
        events.histogram("serve.token_ms", latency_s * 1e3)

    def on_deliver(self, rid: int, n: int) -> None:
        """One token handed to a request (any path: prefill first
        token, decode tick, recovery/preemption replay) — the
        trace-countable delivery event tokens/s derives from."""
        events.counter("serve.token", 1, rid=rid, n=n)
        self._note("counter", "serve.token", rid=rid, n=n)

    # -- per-step levels ---------------------------------------------------
    def on_step(self, queue_depth: int, active_slots: int,
                blocks_in_use: int = 0,
                blocks_in_use_bytes: int = 0) -> None:
        self.steps += 1
        events.gauge("serve.queue_depth", queue_depth)
        events.gauge("serve.active_slots", active_slots)
        events.gauge("serve.blocks_in_use", blocks_in_use)
        events.gauge("serve.blocks_in_use_bytes", blocks_in_use_bytes)
        self._note("gauge", "serve.step", queue_depth=queue_depth,
                   active_slots=active_slots,
                   blocks_in_use=blocks_in_use,
                   blocks_in_use_bytes=blocks_in_use_bytes)

    def snapshot(self) -> Dict[str, Any]:
        """Exact totals + THIS engine's latency summaries (None until
        observed)."""
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "rejected": self.rejected, "evicted": dict(self.evicted),
            "retries": dict(self.retries),
            "quarantined": self.quarantined,
            "recoveries": self.recoveries,
            "preempted": self.preempted,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "steps": self.steps,
            "spilled_blocks": self.spilled_blocks,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_wait_ms": self.prefetch_wait_ms,
            "spec_rounds": self.spec_rounds,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_fallbacks": self.spec_fallbacks,
            "slot_dispatches": self.slot_dispatches,
            "slot_dispatch_tokens": self.slot_dispatch_tokens,
            "accept_rate": self.accept_rate,
            "tokens_per_dispatch": self.tokens_per_dispatch,
            "accept_rate_hist": self._accept.summary(),
            "ttft_ms": self._ttft.summary(),
            "token_ms": self._token.summary(),
        }
