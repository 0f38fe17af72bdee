"""Sweep driver, ported from ``singa_tpu/autotune/sweep.py``: knob
points -> measured ``autotune_sweep`` records.

It takes a list of knob dicts and a ``measure`` callable (the engine
and train-step glue lives in ``singa_tpu_torch/tools/autotune.py``),
runs each point, and appends ONE validated ``autotune_sweep`` entry per
point under a shared ``sweep_id`` to the port's record store
(``obs.record``; ``obs.schema`` validates each entry on the way in).

The fit step reads the points back (:func:`sweep_points_from_store`),
fits the predictor, and appends a FIT record — same kind, same
``sweep_id``, ``point = -1`` — carrying the leave-one-out error
report, so the store holds both the measurements and the number that
says how much to trust interpolating between them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import record as obs_record
from . import knobs as _knobs

__all__ = ["new_sweep_id", "append_point", "append_fit", "run_sweep",
           "sweep_points_from_store", "FIT_POINT"]

#: the fit record's ``point`` index — measurement points are >= 0
FIT_POINT = -1


def new_sweep_id() -> str:
    return obs_record.new_run_id("atsweep")


def _entry(store_path: str, payload: Dict[str, Any], platform: str,
           device: str, smoke: bool) -> Dict[str, Any]:
    entry = obs_record.new_entry(
        "autotune_sweep", platform, smoke, device,
        run_id=obs_record.new_run_id("at"), payload=payload)
    obs_record.RunRecord(store_path).append(entry)
    return entry


def append_point(store_path: str, *, domain: str, model: str,
                 platform: str, device: str, sweep_id: str, point: int,
                 knobs: Dict[str, Any], objective: float,
                 smoke: bool = True,
                 features: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
    """Append one measured sweep point (validated on the way in)."""
    _knobs.require_knobs(domain, knobs, ctx=f"{domain} sweep point")
    objective_name, _ = _knobs.OBJECTIVES[domain]
    payload: Dict[str, Any] = {
        "domain": domain, "model": model,
        "objective_name": objective_name, "sweep_id": sweep_id,
        "point": int(point), "objective": float(objective),
        "knobs": dict(knobs),
    }
    if features:
        payload["features"] = {k: float(v)
                               for k, v in sorted(features.items())}
    if extra:
        payload.update(extra)
    return _entry(store_path, payload, platform, device, smoke)


def append_fit(store_path: str, *, domain: str, model: str,
               platform: str, device: str, sweep_id: str,
               best: Dict[str, Any], report: Dict[str, Any],
               smoke: bool = True,
               spec_evidence: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Append the fit-summary record (``point = FIT_POINT``): the
    measured argbest knobs + objective, and the predictor's
    leave-one-out report — the committed trustworthiness number the
    acceptance tests bound."""
    objective_name, _ = _knobs.OBJECTIVES[domain]
    payload: Dict[str, Any] = {
        "domain": domain, "model": model,
        "objective_name": objective_name, "sweep_id": sweep_id,
        "point": FIT_POINT,
        "objective": float(best["objective"]),
        "knobs": dict(best["knobs"]),
        "loo_rel_err": float(report["loo_rel_err"]),
        "loo_rel_err_max": float(report["loo_rel_err_max"]),
        "n_points": int(report["n"]),
    }
    if spec_evidence:
        payload["spec_k_evidence_run"] = str(spec_evidence["run_id"])
    return _entry(store_path, payload, platform, device, smoke)


def run_sweep(domain: str, model: str,
              points: Sequence[Dict[str, Any]],
              measure: Callable[[Dict[str, Any]],
                                Tuple[float, Dict[str, Any]]],
              store_path: str, *, platform: str, device: str,
              smoke: bool = True, sweep_id: Optional[str] = None,
              log: Optional[Callable[[str], None]] = None
              ) -> Tuple[str, List[Dict[str, Any]]]:
    """Measure every knob point and append its record; returns
    ``(sweep_id, entries)``.

    ``measure(knobs)`` returns ``(objective, features)`` — features
    may be ``{}``.  A point that RAISES aborts the sweep loudly (a
    partial sweep is still a valid record group; the fit step sees
    exactly the points that were measured), but knob validation
    happens for ALL points up front so a typo'd grid never burns
    minutes measuring before failing."""
    pts = list(points)
    if not pts:
        raise _knobs.KnobError(f"{domain} sweep: no points")
    for i, knobs in enumerate(pts):
        _knobs.require_knobs(domain, knobs, ctx=f"{domain} sweep "
                                                f"point {i}")
    sid = sweep_id or new_sweep_id()
    entries: List[Dict[str, Any]] = []
    for i, knobs in enumerate(pts):
        objective, features = measure(knobs)
        entries.append(append_point(
            store_path, domain=domain, model=model, platform=platform,
            device=device, sweep_id=sid, point=i, knobs=knobs,
            objective=objective, smoke=smoke, features=features))
        if log is not None:
            log(f"point {i + 1}/{len(pts)} {knobs} -> "
                f"{_knobs.OBJECTIVES[domain][0]}={objective:.3f}")
    return sid, entries


def sweep_points_from_store(store_path: str, domain: str,
                            model: Optional[str] = None,
                            platform: Optional[str] = None,
                            sweep_id: Optional[str] = None
                            ) -> Tuple[str, List[Dict[str, Any]],
                                       Optional[Dict[str, Any]]]:
    """Read one sweep group back: ``(sweep_id, point payloads in point
    order, fit payload or None)``.  With no ``sweep_id`` the NEWEST
    matching group (by append order) is used.  No matching records is
    loud — an empty store must not fit an empty predictor."""
    groups: Dict[str, List[Dict[str, Any]]] = {}
    order: List[str] = []
    for e in obs_record.RunRecord(store_path).entries():
        if e["kind"] != "autotune_sweep":
            continue
        p = e["payload"]
        if p["domain"] != domain:
            continue
        if model is not None and p["model"] != model:
            continue
        if platform is not None and e["platform"] != platform:
            continue
        sid = p["sweep_id"]
        if sid not in groups:
            groups[sid] = []
            order.append(sid)
        # the entry-level identity rides along so a later fit record
        # can stamp the SAME device as the points it summarizes
        groups[sid].append({**p, "run_id": e["run_id"],
                            "device": e["device"]})
    if sweep_id is None:
        if not order:
            raise LookupError(
                f"no {domain!r} autotune_sweep records"
                + (f" for model {model!r}" if model else "")
                + f" in {store_path} — run `python -m singa_tpu_torch."
                  f"tools.autotune sweep` first")
        sweep_id = order[-1]
    elif sweep_id not in groups:
        raise LookupError(f"no autotune_sweep records with sweep_id "
                          f"{sweep_id!r} in {store_path}")
    rows = groups[sweep_id]
    fit = next((r for r in rows if r["point"] == FIT_POINT), None)
    pts = sorted((r for r in rows if r["point"] >= 0),
                 key=lambda r: r["point"])
    return sweep_id, pts, fit
