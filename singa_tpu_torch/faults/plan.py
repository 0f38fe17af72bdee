"""FaultSpec / FaultPlan — deterministic, seeded fault schedules.

A plan is a list of specs, each binding one registered injection site
(:mod:`singa_tpu_torch.faults.sites`) to one fault kind and one trigger rule.
Trigger decisions are pure functions of ``(seed, site, spec index,
call index)`` — no wall clock, no global RNG — so a chaos run replays
bit-identically under the same plan, which is what lets the chaos
suite assert token-identical serving output against a fault-free run.

Fault kinds:

* ``error``      — raise :class:`InjectedFault` (a ``RuntimeError``):
                   the transient-failure shape every retry path in the
                   repo catches;
* ``hang``       — sleep ``delay_s`` inside the site: long enough
                   relative to a Heartbeat timeout, this exercises hang
                   detection and the recovery paths behind it;
* ``torn_write`` — truncate the file named by the site's ``path``
                   context (checkpoint torn-write simulation);
* ``torn_frame`` — truncate the BYTES payload flowing past the site
                   (wire torn-frame simulation, applied by
                   :func:`faults.tear` — the in-memory analogue of
                   ``torn_write`` for transport seams);
* ``nan``        — replace float array values flowing past the site
                   with NaN (applied by :func:`faults.corrupt`).

Env syntax (parsed by :meth:`FaultPlan.parse`, activated at import by
``SINGA_FAULTS``; seed via ``SINGA_FAULTS_SEED``)::

    SINGA_FAULTS="serve.decode=error:every=3,times=2;serve.prefill=hang:at=1,delay=0.5"

i.e. ``;``-separated specs of ``<site>=<kind>[:key=val[,key=val...]]``
with keys ``at`` (1-based call index), ``every`` (every Kth call),
``p`` (probability per call, seeded-deterministic), ``times`` (cap on
fires), ``delay`` (hang seconds).
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Dict, List, Optional, Tuple

from . import sites as _sites

__all__ = ["KINDS", "InjectedFault", "FaultSpec", "FaultPlan"]

KINDS = ("error", "hang", "torn_write", "torn_frame", "nan")


class InjectedFault(RuntimeError):
    """The transient error the injector raises for kind ``error`` — a
    plain RuntimeError subclass, so it takes exactly the retry paths a
    real transient dispatch failure would."""


def _det_uniform(seed: int, site: str, spec_idx: int, n: int) -> float:
    """Deterministic uniform in [0, 1): stable across processes and
    PYTHONHASHSEED (blake2b, not hash())."""
    h = hashlib.blake2b(f"{seed}:{site}:{spec_idx}:{n}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


class FaultSpec:
    """One (site, kind, trigger) rule.  Exactly one of ``at`` /
    ``every`` / ``p`` selects calls (none given = every call); ``times``
    caps total fires (defaults to 1 for ``at``, unlimited otherwise)."""

    __slots__ = ("site", "kind", "at", "every", "p", "times", "delay_s")

    def __init__(self, site: str, kind: str, *, at: Optional[int] = None,
                 every: Optional[int] = None, p: Optional[float] = None,
                 times: Optional[int] = None, delay_s: float = 0.25):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {KINDS})")
        if not _sites.is_known(site):
            raise ValueError(
                f"unknown injection site {site!r} (registered: "
                f"{sorted(_sites.SITES)})")
        if kind not in _sites.supported_kinds(site):
            raise ValueError(
                f"site {site!r} does not support kind {kind!r} "
                f"(supports: {_sites.supported_kinds(site)})")
        ntrig = sum(v is not None for v in (at, every, p))
        if ntrig > 1:
            raise ValueError("at / every / p are mutually exclusive "
                             f"(got at={at}, every={every}, p={p})")
        if at is not None and at < 1:
            raise ValueError(f"at is a 1-based call index, got {at}")
        if every is not None and every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if p is not None and not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        if delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {delay_s}")
        self.site = site
        self.kind = kind
        self.at = at
        self.every = every
        self.p = p
        self.times = times if times is not None else (
            1 if at is not None else None)
        self.delay_s = float(delay_s)

    def triggers(self, seed: int, spec_idx: int, n: int) -> bool:
        """Pure trigger decision for the site's ``n``-th call (1-based);
        the ``times`` cap is the plan's job (it owns the fire count)."""
        if self.at is not None:
            return n == self.at
        if self.every is not None:
            return n % self.every == 0
        if self.p is not None:
            return _det_uniform(seed, self.site, spec_idx, n) < self.p
        return True

    def __repr__(self) -> str:
        trig = (f"at={self.at}" if self.at is not None
                else f"every={self.every}" if self.every is not None
                else f"p={self.p}" if self.p is not None else "always")
        return (f"FaultSpec({self.site}={self.kind}:{trig}"
                f"{f',times={self.times}' if self.times else ''})")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` rules plus the mutable firing
    state (per-site call counters, per-spec fire counts, a log of every
    fired fault).  Activate with ``faults.active(plan)`` (context
    manager) or ``faults.install(plan)``; an EMPTY plan is the
    site-call-count probe the overhead tests use — it fires nothing but
    still counts every ``fire()``/``corrupt()`` that reaches it."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None,
                 seed: int = 0):
        self.specs: List[FaultSpec] = list(specs or [])
        self.seed = int(seed)
        self.calls: Dict[str, int] = {}      # site -> calls observed
        self.fired: List[Dict[str, Any]] = []  # log of fired faults
        self._fires: Dict[int, int] = {}     # spec idx -> fires so far
        self._lock = threading.Lock()

    # -- construction ------------------------------------------------------
    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the ``SINGA_FAULTS`` syntax (see module docstring)."""
        specs = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"bad fault spec {part!r}: expected "
                    f"<site>=<kind>[:key=val,...]")
            site, rhs = part.split("=", 1)
            kind, _, opts = rhs.partition(":")
            kw: Dict[str, Any] = {}
            for opt in filter(None, (o.strip() for o in opts.split(","))):
                if "=" not in opt:
                    raise ValueError(f"bad fault option {opt!r} in "
                                     f"{part!r}: expected key=val")
                k, v = opt.split("=", 1)
                k = k.strip()
                if k in ("at", "every", "times"):
                    kw[k] = int(v)
                elif k == "p":
                    kw[k] = float(v)
                elif k == "delay":
                    kw["delay_s"] = float(v)
                else:
                    raise ValueError(
                        f"unknown fault option {k!r} in {part!r} "
                        f"(known: at, every, p, times, delay)")
            specs.append(FaultSpec(site.strip(), kind.strip(), **kw))
        return cls(specs, seed=seed)

    # -- firing state ------------------------------------------------------
    def match(self, site: str, kinds: Tuple[str, ...],
              count: bool = True) -> List[Tuple[int, FaultSpec]]:
        """Advance ``site``'s call counter (when ``count``) and return
        the (spec_idx, spec) pairs of the given kinds that fire on this
        call, respecting each spec's ``times`` cap."""
        with self._lock:
            if count:
                n = self.calls[site] = self.calls.get(site, 0) + 1
            else:
                n = self.calls.get(site, 0)
            out = []
            for i, s in enumerate(self.specs):
                if s.site != site or s.kind not in kinds:
                    continue
                if s.times is not None and self._fires.get(i, 0) >= s.times:
                    continue
                if s.triggers(self.seed, i, n):
                    self._fires[i] = self._fires.get(i, 0) + 1
                    self.fired.append({"site": site, "kind": s.kind,
                                       "call": n, "spec": i})
                    out.append((i, s))
            return out

    def fire_count(self, site: Optional[str] = None) -> int:
        """Fired faults so far (optionally for one site)."""
        with self._lock:
            return len([f for f in self.fired
                        if site is None or f["site"] == site])

    def __repr__(self) -> str:
        return (f"FaultPlan(seed={self.seed}, specs={self.specs}, "
                f"fired={len(self.fired)})")
