"""singa_tpu_torch.faults — deterministic fault injection, ported from
``singa_tpu/faults``.

Every failure path the port claims to survive — serve-engine retry,
quarantine and arena recovery, hang detection — is exercisable through
NAMED injection sites wired at the real failure seams (:mod:`.sites`),
driven by a seeded :class:`~singa_tpu_torch.faults.plan.FaultPlan`
(:mod:`.plan`).

Usage::

    from singa_tpu_torch import faults
    plan = faults.FaultPlan([
        faults.FaultSpec("serve.decode", "error", every=3, times=2),
        faults.FaultSpec("serve.prefill", "hang", at=2, delay_s=1.0),
    ], seed=42)
    with faults.active(plan):
        engine.run_until_idle()
    assert plan.fire_count() == 3

or from the environment (no code changes)::

    SINGA_FAULTS="device.execute=error:every=50" python train.py

Design contract:

* **zero overhead when off** — :func:`fire`/:func:`corrupt` are a
  single module-global ``None`` check when no plan is active; sites
  live on the host, outside every captured CUDA graph, so activating a
  plan never changes a captured program, and with no plan active no
  obs event is ever emitted.
* **deterministic** — trigger decisions are pure functions of
  ``(seed, site, spec index, call index)``; a chaos run replays
  bit-identically, and fires on the same calls as the JAX package's
  plan of the same seed.
* **observable** — every fired fault emits a ``fault.injected``
  counter through :mod:`singa_tpu_torch.obs.events` (site, kind, call).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Optional

from .plan import KINDS, FaultPlan, FaultSpec, InjectedFault
from .sites import SITES

__all__ = ["KINDS", "SITES", "FaultPlan", "FaultSpec", "InjectedFault",
           "fire", "corrupt", "tear", "active", "install", "uninstall",
           "get_active"]

_active: Optional[FaultPlan] = None


def get_active() -> Optional[FaultPlan]:
    return _active


def install(plan: Optional[FaultPlan]) -> None:
    """Make ``plan`` the process-wide active plan (None deactivates).
    Prefer the :func:`active` context manager in tests."""
    global _active
    _active = plan


def uninstall() -> None:
    install(None)


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Activate ``plan`` for the dynamic extent of the block."""
    global _active
    if _active is not None:
        raise RuntimeError("a FaultPlan is already active — nested "
                           "activation would make firing ambiguous")
    _active = plan
    try:
        yield plan
    finally:
        _active = None


def _emit(site: str, kind: str, call: int) -> None:
    from ..obs import events, flight
    # attr is fault_kind, not kind: event attrs merge into the sink
    # line, and a bare "kind" would clobber the event's own kind field
    events.counter("fault.injected", 1, site=site, fault_kind=kind,
                   call=call)
    # every FIRED fault also lands in the live flight-recorder rings
    # (each ServeEngine's), so an incident dump's timeline shows
    # the injected fault next to the retries/quarantine it caused; the
    # no-fault path never reaches here (zero-overhead contract)
    flight.broadcast("counter", "fault.injected", site=site,
                     fault_kind=kind, call=call)


def fire(site: str, **ctx: Any) -> None:
    """The injection hook: a no-op unless an active plan says this call
    of ``site`` faults.  Kind ``error`` raises :class:`InjectedFault`,
    ``hang`` sleeps the spec's ``delay_s`` (so a Heartbeat watching the
    caller fires), ``torn_write`` truncates the file at ``ctx['path']``.
    When several specs fire on the same call, hangs and truncations are
    applied first and an error is raised last."""
    plan = _active
    if plan is None:
        return
    hits = plan.match(site, ("error", "hang", "torn_write"))
    if not hits:
        return
    err: Optional[FaultSpec] = None
    for _, spec in hits:
        _emit(site, spec.kind, plan.calls.get(site, 0))
        if spec.kind == "hang":
            time.sleep(spec.delay_s)
        elif spec.kind == "torn_write":
            _truncate(ctx.get("path"))
        else:
            err = spec
    if err is not None:
        raise InjectedFault(
            f"injected transient fault at {site} "
            f"(call {plan.calls.get(site, 0)}, ctx {ctx or '{}'})")


def corrupt(site: str, value: Any) -> Any:
    """NaN-corruption hook: returns ``value`` unchanged unless a ``nan``
    spec fires, in which case every float array in it is replaced with
    NaNs.  Does not advance the site's call counter — by convention a
    ``nan``-capable site calls :func:`fire` first (pre-dispatch) and
    ``corrupt`` on the same logical call's output."""
    plan = _active
    if plan is None:
        return value
    hits = plan.match(site, ("nan",), count=False)
    if not hits:
        return value
    for _, spec in hits:
        _emit(site, spec.kind, plan.calls.get(site, 0))
    return _nanify(value)


def tear(site: str, data: bytes) -> bytes:
    """Torn-frame hook for byte payloads: returns ``data`` unchanged
    unless a ``torn_frame`` spec fires, in which case only the first
    half survives — the in-memory analogue of a ``torn_write`` for
    transport seams, where the payload is bytes on a wire rather than
    a file on disk.  Does not advance the site's call counter — by
    convention a transport site calls :func:`fire` first (pre-send)
    and ``tear`` on the same logical call's payload, mirroring the
    :func:`corrupt` convention."""
    plan = _active
    if plan is None:
        return data
    hits = plan.match(site, ("torn_frame",), count=False)
    if not hits:
        return data
    for _, spec in hits:
        _emit(site, spec.kind, plan.calls.get(site, 0))
    return data[:len(data) // 2]


def _truncate(path: Optional[str]) -> None:
    """Tear a file the way an interrupted write would: keep the first
    half, drop the rest.  (A site offering torn_write passes ``path``.)"""
    if not path or not os.path.exists(path):
        return
    size = os.path.getsize(path)
    if size < 2:
        return
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _nanify(value: Any) -> Any:
    """``value`` with every floating tensor or array in it (through
    nested lists, tuples and dicts) replaced by a NaN-filled one of the
    same shape, dtype and device; everything else is kept."""
    import numpy as np
    import torch

    if isinstance(value, torch.Tensor):
        return (torch.full_like(value, float("nan"))
                if value.is_floating_point() else value)
    if isinstance(value, np.ndarray):
        return (np.full_like(value, np.nan)
                if np.issubdtype(value.dtype, np.floating) else value)
    if isinstance(value, dict):
        return {k: _nanify(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_nanify(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_nanify(v) for v in value)
    return value


def _init_from_env() -> None:
    text = os.environ.get("SINGA_FAULTS")
    if not text:
        return
    seed = int(os.environ.get("SINGA_FAULTS_SEED", "0") or 0)
    # a malformed plan must fail LOUDLY: the whole point of env
    # activation is a chaos run — silently injecting nothing would
    # report "survived" without ever being tested
    install(FaultPlan.parse(text, seed=seed))


_init_from_env()
