"""Runtime attribution: the per-program dispatch-time ledger, ported
from ``singa_tpu/obs/attr.py``.

Every guarded dispatch — the train step (``model._StepExecutor``), the
serve engine's prefill and decode (``ServeEngine._dispatch``) — can be
timed host-side with ``time.perf_counter`` around its existing call
seam, outside any captured graph.  Observations accumulate per program
key as exact count/total/min/max plus the bounded-ring nearest-rank
percentile estimator of :class:`singa_tpu_torch.obs.events._Hist`.
:func:`attribution_payload` joins a snapshot against per-program
analytic features (flops, HBM bytes) into a ``perf_attr`` payload.

Zero-overhead-when-off contract: the instrumented seams read the
module-global ledger ONCE per dispatch; with no ledger installed that
read is the entire cost — no clock read, no allocation, no event, and
no device synchronisation.  Installation is explicit (:func:`install`).

A CUDA-graph replay or kernel launch returns before the card has run
it, so a seam that times one synchronises the device before and after
the call, and only while a ledger is installed: the noted duration is
then the dispatch's wall time, host enqueue included.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .events import _Hist

__all__ = ["Ledger", "install", "uninstall", "get", "note",
           "attribution_payload", "NOMINAL_FLOPS_PER_S",
           "NOMINAL_HBM_BYTES_PER_S"]

#: the reference roofline the achieved fraction is computed against:
#: deliberately generous single-core-class ceilings (1 TFLOP/s, 100
#: GB/s) so the fraction reads as "share of a nominal box" and stays
#: below 1 on a CPU host.  The absolute value is not gated (box speed
#: varies); a fraction that is non-positive is the signature of a
#: broken clock or a garbage join, not of a slow machine.
NOMINAL_FLOPS_PER_S = 1.0e12
NOMINAL_HBM_BYTES_PER_S = 100.0e9


class Ledger:
    """Per-program dispatch-time accumulator.

    One :class:`~singa_tpu_torch.obs.events._Hist` per program key: exact
    count/total/min/max over every observation, nearest-rank p50/p99
    over the bounded ring (deterministic — same observation order,
    same summary).  Thread-safe: engines may tick from worker
    threads, so :meth:`note` takes the ledger lock the
    same way the event layer's histogram registry does."""

    __slots__ = ("_hists", "_lock", "installed_at")

    def __init__(self):
        self._hists: Dict[str, _Hist] = {}
        self._lock = threading.Lock()
        #: ``perf_counter`` stamp of :func:`install` — the enclosing
        #: window's start, so ``window_s`` in the record payload is the
        #: ledger's own lifetime unless the caller measures a tighter one
        self.installed_at: Optional[float] = None

    def note(self, program: str, dur_s: float) -> None:
        """One dispatch of ``program`` took ``dur_s`` seconds."""
        with self._lock:
            h = self._hists.get(program)
            if h is None:
                h = self._hists[program] = _Hist()
            h.observe(float(dur_s))

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """``{program: {count, total_s, min_s, max_s, p50_s, p99_s}}``
        — count/total/min/max exact, percentiles from the retained
        ring (see ``_Hist.summary`` for the determinism contract)."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            items = list(self._hists.items())
        for program, h in items:
            s = h.summary()
            if s is None:
                continue
            out[program] = {"count": s["count"], "total_s": s["sum"],
                            "min_s": s["min"], "max_s": s["max"],
                            "p50_s": s["p50"], "p99_s": s["p99"]}
        return out

    def reset(self) -> None:
        """Drop every accumulated program (a bench isolating its
        measured window calls this, then re-stamps the window)."""
        with self._lock:
            self._hists.clear()
        self.installed_at = time.perf_counter()


#: the module-global the dispatch seams read ONCE per call — ``None``
#: (the default) means the seam costs a single global load and nothing
#: else: no clock read, no allocation (the overhead-honesty test pins
#: this with an allocation probe)
_LEDGER: Optional[Ledger] = None


def install(ledger: Optional[Ledger] = None) -> Ledger:
    """Install ``ledger`` (or a fresh one) as the process-wide
    attribution target and return it.  Re-installing replaces the
    previous ledger (the old one keeps its accumulated state — callers
    that snapshot after uninstall still see their window)."""
    global _LEDGER
    led = ledger if ledger is not None else Ledger()
    led.installed_at = time.perf_counter()
    _LEDGER = led
    return led


def uninstall() -> Optional[Ledger]:
    """Remove the installed ledger (returning it, so the caller can
    snapshot the closed window); the dispatch seams fall back to the
    zero-overhead path."""
    global _LEDGER
    led = _LEDGER
    _LEDGER = None
    return led


def get() -> Optional[Ledger]:
    """The installed ledger, or None."""
    return _LEDGER


def note(program: str, dur_s: float) -> None:
    """Module-level note: forwards to the installed ledger, no-op
    without one.  Instrumented seams should instead snapshot
    ``attr.get()`` BEFORE their ``perf_counter`` read so the off path
    never touches the clock — this helper is for call sites where a
    duration already exists for other reasons."""
    led = _LEDGER
    if led is not None:
        led.note(program, dur_s)


def _achieved(row: Dict[str, float], feat: Dict[str, Any]
              ) -> Dict[str, float]:
    """The measured-vs-modeled join for one program: achieved FLOP/s
    and HBM bytes/s from the mean dispatch time, and the
    achieved-roofline fraction — the analytic minimum time (compute or
    memory bound, whichever dominates at the nominal box) over the
    measured mean.  Pure arithmetic on the snapshot row and the
    feature row, so a frozen record re-derives bit-equal."""
    mean_s = row["total_s"] / row["count"]
    flops = float(feat.get("flops", 0) or 0)
    hbm = float(feat.get("hbm_bytes", 0) or 0)
    modeled_min_s = max(flops / NOMINAL_FLOPS_PER_S,
                        hbm / NOMINAL_HBM_BYTES_PER_S)
    return {
        "modeled_flops": flops,
        "modeled_hbm_bytes": hbm,
        "achieved_flops_per_s": flops / mean_s if mean_s > 0 else 0.0,
        "achieved_hbm_gbps": hbm / mean_s / 1e9 if mean_s > 0 else 0.0,
        "achieved_flops_frac": (modeled_min_s / mean_s
                                if mean_s > 0 else 0.0),
    }


def attribution_payload(snapshot: Dict[str, Dict[str, float]],
                        features: Dict[str, Dict[str, Any]],
                        window_s: float) -> Dict[str, Any]:
    """The ``perf_attr`` record payload (obs.schema): every snapshot
    program that has an analytic feature row, joined.

    Programs WITHOUT a feature row (an eval step, the eager grad-sync
    key) are dropped — the schema requires program keys to be a subset
    of the flagship set, and a program the cost model never lowered has
    no modeled side to reconcile; they stay visible in the live view
    (:meth:`Ledger.snapshot`).  ``attributed_s`` sums the
    *included* programs' totals against the caller's enclosing
    ``window_s``, so the completeness invariant reads
    directly off the record."""
    programs: Dict[str, Dict[str, float]] = {}
    attributed = 0.0
    for name in sorted(snapshot):
        if name not in features:
            continue
        row = dict(snapshot[name])
        row.update(_achieved(snapshot[name], features[name]))
        programs[name] = row
        attributed += snapshot[name]["total_s"]
    return {
        "window_s": float(window_s),
        "attributed_s": attributed,
        "attributed_frac": (attributed / window_s
                            if window_s > 0 else 0.0),
        "programs": programs,
    }
