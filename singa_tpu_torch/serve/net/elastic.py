"""Elastic prefill/decode pool sizing for the multi-process tier,
ported from ``singa_tpu/serve/net/elastic.py``.

The :class:`ElasticPolicy` turns the supervisor's per-step signals into
:meth:`ProcRouter.resize` calls:

* **decode backpressure** — finished prefills parked because no decode
  worker can hold their KV (``router.parked``): the tier is producing
  prefills faster than the decode pool drains them → grow decode.
* **prefill pressure** — deep queues on the prefill pool (sum of
  prefill worker loads vs. slot capacity) with an idle decode pool →
  grow prefill.
* **idle** — a tier with nothing pending for ``patience`` consecutive
  checks shrinks the pool that is furthest ABOVE the target share
  toward ``min_per_pool`` (capacity follows load down, not just up).

Grow direction on ambiguous signals consults the committed autotune
knob ``serve.pool_ratio`` (the decode share of the worker budget,
:func:`target_decode_share`) — the policy nudges the tier TOWARD that
share rather than oscillating.

Decisions are debounced: signals must persist for ``patience``
consecutive checks (one check every ``check_every`` steps) before a
resize fires, and a resize resets the debounce — the supervisor's
``serve.resize`` fault site can still abort any individual resize,
which the policy simply retries at a later check.

Interaction with self-healing: a policy resize moves the
supervisor's per-role TARGET, which is also what respawn restores
toward after a worker death — so an elastic shrink that lands while a
respawn spawn is in flight is settled at adoption time (the surplus
newcomer is dismissed against the moved target, never double-adopted),
and an explicit resize hands a crash-looping role a clean slate
(breaker closed, backoff forgotten).  The policy reads ``alive``
worker counts only, so a dead-but-not-yet-pruned worker never inflates
the pool size a decision is based on.
"""

from __future__ import annotations

from typing import Dict, Optional

__all__ = ["ElasticPolicy", "target_decode_share"]


def target_decode_share(model_key: Optional[str] = None,
                        platform: str = "cuda") -> float:
    """The committed decode share of the worker budget for
    ``model_key`` on ``platform`` (the workers' device type): the
    best-config table's ``serve.pool_ratio``, else the registry's
    default of 0.5, announced once by the table.  A table that is
    present but invalid raises."""
    from ...autotune import table as _table
    knobs = _table.resolve("serve", model_key or "unknown", platform, {})
    return float(knobs["pool_ratio"])


class ElasticPolicy:
    """Debounced grow/shrink policy over a :class:`ProcRouter`; pass as
    ``ProcRouter(..., policy=ElasticPolicy(max_total=4))`` and the tier
    re-evaluates at every ``check_every``-th step."""

    def __init__(self, *, min_per_pool: int = 1, max_total: int = 4,
                 check_every: int = 8, patience: int = 2,
                 decode_share: Optional[float] = None):
        if min_per_pool < 1:
            raise ValueError(f"min_per_pool must be >= 1, "
                             f"got {min_per_pool}")
        if max_total < 2 * min_per_pool:
            raise ValueError(
                f"max_total={max_total} cannot hold {min_per_pool} "
                f"worker(s) per pool")
        self.min_per_pool = int(min_per_pool)
        self.max_total = int(max_total)
        self.check_every = max(1, int(check_every))
        self.patience = max(1, int(patience))
        self._share = decode_share
        self._steps = 0
        self._parked_checks = 0
        self._queued_checks = 0
        self._idle_checks = 0

    def decode_share(self, router) -> float:
        if self._share is None:
            fabric = getattr(router, "fabric", None)
            self._share = target_decode_share(
                getattr(router, "model_key", None),
                getattr(fabric, "device", "cuda"))
        return self._share

    def decide(self, router) -> Optional[Dict[str, int]]:
        """Called by the supervisor once per tier step; returns resize
        kwargs (``{"n_decode": 3}``) or None."""
        self._steps += 1
        if self._steps % self.check_every:
            return None
        n_p = len([w for w in router.prefill if w.alive])
        n_d = len([w for w in router.decode if w.alive])
        total = n_p + n_d
        parked = getattr(router, "parked", 0)
        queued = sum(w.load for w in router.prefill if w.alive)
        pending = router.pending

        self._parked_checks = self._parked_checks + 1 if parked else 0
        self._queued_checks = (self._queued_checks + 1
                               if queued > 2 * n_p else 0)
        self._idle_checks = self._idle_checks + 1 if not pending else 0

        if self._parked_checks >= self.patience:
            self._parked_checks = 0
            if total < self.max_total:
                return {"n_decode": n_d + 1}
            if n_p > self.min_per_pool and \
                    n_d / total < self.decode_share(router):
                # at the budget: trade a prefill worker for decode
                # capacity, but only while below the committed share
                return {"n_prefill": n_p - 1, "n_decode": n_d + 1}
            return None
        if self._queued_checks >= self.patience:
            self._queued_checks = 0
            if total < self.max_total:
                return {"n_prefill": n_p + 1}
            return None
        if self._idle_checks >= self.patience:
            self._idle_checks = 0
            share = self.decode_share(router)
            # shrink whichever pool is further above the committed
            # share (ties shrink decode — prefill is the front door)
            over_d = n_d - max(self.min_per_pool,
                               round(share * (total - 1)))
            if n_d > self.min_per_pool and over_d >= 0:
                return {"n_decode": n_d - 1}
            if n_p > self.min_per_pool:
                return {"n_prefill": n_p - 1}
        return None
