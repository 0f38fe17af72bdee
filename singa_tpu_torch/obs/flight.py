"""Flight recorder — a bounded in-memory ring of recent structured
events, dumped to disk only when something goes wrong; ported from
``singa_tpu/obs/flight.py``.

A :class:`FlightRecorder` is a fixed-capacity deque of the last N event
dicts that costs one dict build + one append per note, does ZERO file
I/O on the hot path, and is active even when ``SINGA_OBS`` is unset —
so when a fault fires, a request is quarantined or recovery runs, the
owning component can :meth:`~FlightRecorder.dump` the ring atomically
to ``<record dir>/incidents/<ts>-<site>.jsonl`` and reference it from
the durable ``incident`` record (``flight_ref``).

Design points:

* **per-component rings** — each ``ServeEngine`` owns a recorder (like
  ``ServeMetrics``): two engines in one process never interleave ring
  contents, and no global state leaks across tests.
* **trace-stamped** — every note records the active
  :mod:`singa_tpu_torch.obs.trace` id, so a dump slices cleanly per
  request.
* **registered dump sites** — ``dump()`` refuses a site name that is
  not a registered fault site (:data:`singa_tpu_torch.faults.sites.SITES`)
  or incident site (:data:`~singa_tpu_torch.faults.sites.INCIDENT_SITES`).
* **fault fires are broadcast** — :func:`singa_tpu_torch.faults.fire`
  calls :func:`broadcast` for every *fired* fault (never per guarded
  call), so each live ring carries the injected-fault line in its
  timeline.  Registration is a WeakSet: a garbage-collected engine's
  ring drops out on its own.
* **dumps are gated by a record store** — components only dump when
  they have a ``record_store`` to reference the file from; the
  no-sink/no-store path performs zero file writes.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from . import trace

__all__ = ["FlightRecorder", "register", "broadcast", "dump_for_store",
           "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 256

#: live rings that want fault-fire notes; weak so a dead engine's ring
#: is dropped by the collector, not by an explicit lifecycle hook
_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()

#: guards _RECORDERS against mutation-during-iteration: register()
#: runs on whatever thread builds an engine/runner while broadcast()
#: snapshots the set from the thread a fault fires on — an unguarded
#: ``add`` landing mid-``list(...)`` raises "Set changed size during
#: iteration" on the BROADCASTING thread, i.e. inside faults.fire on
#: the step path.  Notes are delivered OUTSIDE the lock: each
#: ring serializes its own appends, and holding the registry lock
#: across them would couple every engine's hot path to the slowest
#: ring.
_registry_lock = threading.Lock()

#: distinguishes dumps landing within the same second+site+pid
_dump_seq = itertools.count()


def register(rec: "FlightRecorder") -> "FlightRecorder":
    """Subscribe ``rec`` to fault-fire broadcasts (weakly held)."""
    with _registry_lock:
        _RECORDERS.add(rec)
    return rec


def broadcast(kind: str, name: str, **attrs: Any) -> None:
    """Note one event into every registered ring — called by
    ``faults.fire`` for each FIRED fault only, so the no-fault path
    never reaches here."""
    with _registry_lock:
        recorders = list(_RECORDERS)
    for rec in recorders:
        rec.note(kind, name, **attrs)


def dump_for_store(recorder: "FlightRecorder", site: str,
                   record_store: Optional[str],
                   reason: str) -> Optional[str]:
    """The one dump-next-to-the-record-store contract shared by
    components that own a recorder: write the ring to
    ``<store dir>/incidents/`` and return the REF — the dump path
    relative to the store's directory, what the record carries as
    ``flight_ref``.  None (and zero file writes) when ``record_store``
    is unset; best-effort like the record itself (an OSError degrades
    to a warning, never a crash on the incident path)."""
    if not record_store:
        return None
    store_dir = os.path.dirname(os.path.abspath(record_store))
    try:
        path = recorder.dump(site, os.path.join(store_dir, "incidents"),
                             reason=reason)
        return os.path.relpath(path, start=store_dir)
    except OSError as e:
        import warnings
        warnings.warn(f"could not dump flight recorder: "
                      f"{type(e).__name__}: {e}", stacklevel=2)
        return None


class FlightRecorder:
    """Bounded ring of the last ``capacity`` structured events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        # notes arrive from the step thread AND (via broadcast/Heartbeat
        # callbacks) monitor threads; the lock keeps dump() snapshots
        # internally consistent
        self._lock = threading.Lock()

    def note(self, kind: str, name: str, **attrs: Any) -> None:
        """Append one event (hot path: dict build + deque append; no
        I/O).  The active trace id is stamped automatically."""
        # wall-clock stamps correlate with the JSONL sink's events
        ev: Dict[str, Any] = {"t": time.time(), "kind": kind,
                              "name": name}
        tid = trace.current_trace_id()
        if tid is not None:
            ev["trace"] = tid
        ev.update(attrs)
        with self._lock:
            self._ring.append(ev)

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring's events, oldest first (a copy)."""
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def dump(self, site: str, directory: str,
             reason: Optional[str] = None) -> str:
        """Atomically write the ring to
        ``<directory>/<ts>-<site>-<pid>-<seq>.jsonl`` and return the
        file's absolute path.  ``site`` must be a registered fault or
        incident site (typos fail loudly here).  The write is temp + ``os.replace`` — a crash mid-dump
        never leaves a half-written incident file."""
        from ..faults import sites as fault_sites
        if not fault_sites.is_incident_site(site):
            raise ValueError(
                f"unknown flight-dump site {site!r} (registered fault "
                f"sites: {sorted(fault_sites.SITES)}; incident sites: "
                f"{sorted(fault_sites.INCIDENT_SITES)})")
        import json
        os.makedirs(directory, exist_ok=True)
        fname = (f"{time.strftime('%Y%m%d-%H%M%S')}-{site}-"
                 f"{os.getpid()}-{next(_dump_seq)}.jsonl")
        path = os.path.join(os.path.abspath(directory), fname)
        events = self.snapshot()
        if reason is not None:
            events = events + [{"t": time.time(), "kind": "dump",
                                "name": site, "reason": reason}]
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for ev in events:
                f.write(json.dumps(ev, sort_keys=True, default=repr)
                        + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
