"""Record-fitted performance predictor, ported from
``singa_tpu/autotune/predictor.py`` (numpy only, the same arithmetic).

The feature vector of a sweep point is the knob values plus the
point's measured analytic quantities (on the card: the captured
step's FLOPs and graph pool bytes, the communicator's wire-byte
model).  At this scale the right learner is a closed-form one:

* **ridge regression** over standardized (knob + feature) columns —
  deterministic (``numpy.linalg.solve`` on a fixed design matrix; no
  iterative optimizer, no seed), and its leave-one-out error is cheap
  enough to compute exactly;
* **nearest-neighbor** lookup as the companion: on a measured point it
  returns the measurement itself.

Trustworthiness is a number: :func:`fit_points` returns a leave-one-out
relative-error report beside the predictor, and the fit record commits
it to the store (``loo_rel_err``).  An empty point set, an unknown knob
name or ragged knob keys raise with the offending name.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import knobs as _knobs

__all__ = ["Predictor", "fit_points", "best_point", "point_vector"]


def _check_points(domain: str,
                  points: Sequence[Dict[str, Any]]) -> Tuple[List[str],
                                                             List[str]]:
    """Validate a sweep-point list and return the (knob_names,
    feature_names) column order shared by every point."""
    if not points:
        raise ValueError(
            f"autotune predictor: no {domain!r} sweep points to fit — "
            f"run `python -m singa_tpu_torch.tools.autotune sweep` "
            f"first (empty store)")
    first_knobs = sorted(points[0].get("knobs", {}))
    feature_names = sorted(points[0].get("features", {}) or {})
    for i, p in enumerate(points):
        _knobs.require_knobs(domain, p.get("knobs"),
                             ctx=f"sweep point {i}")
        if sorted(p["knobs"]) != first_knobs:
            raise ValueError(
                f"autotune predictor: sweep point {i} knobs "
                f"{sorted(p['knobs'])} differ from point 0's "
                f"{first_knobs} — a ragged sweep cannot share one "
                f"design matrix")
        if sorted(p.get("features", {}) or {}) != feature_names:
            raise ValueError(
                f"autotune predictor: sweep point {i} features differ "
                f"from point 0's {feature_names}")
        y = p.get("objective")
        if not isinstance(y, (int, float)) or isinstance(y, bool):
            raise ValueError(f"autotune predictor: sweep point {i} has "
                             f"no numeric objective (got {y!r})")
    return first_knobs, feature_names


def point_vector(point: Dict[str, Any], knob_names: Sequence[str],
                 feature_names: Sequence[str]) -> np.ndarray:
    """One point's raw (unstandardized) feature row, knob columns then
    analytic-feature columns, in the fit's fixed order."""
    vals = [float(point["knobs"][k]) for k in knob_names]
    feats = point.get("features", {}) or {}
    vals += [float(feats[f]) for f in feature_names]
    return np.asarray(vals, dtype=np.float64)


class Predictor:
    """A fitted ridge model over one (domain, model, platform) sweep.

    Holds the standardization constants and the measured points, so
    :meth:`predict` answers for unseen knob settings and
    :meth:`nearest` returns the closest MEASURED point (normalized
    L2 over the same columns) when the honest answer is a lookup."""

    def __init__(self, domain: str, knob_names: List[str],
                 feature_names: List[str], mean: np.ndarray,
                 scale: np.ndarray, weights: np.ndarray, bias: float,
                 points: List[Dict[str, Any]]):
        self.domain = domain
        self.knob_names = knob_names
        self.feature_names = feature_names
        self._mean = mean
        self._scale = scale
        self._weights = weights
        self._bias = bias
        self.points = points

    def _row(self, knobs: Dict[str, Any],
             features: Optional[Dict[str, Any]] = None) -> np.ndarray:
        _knobs.require_knobs(self.domain, knobs, ctx="predict")
        missing = [k for k in self.knob_names if k not in knobs]
        if missing:
            raise ValueError(f"autotune predictor: predict() missing "
                             f"fitted knob(s) {missing}")
        point = {"knobs": knobs, "features": features or {}}
        if sorted(point["features"]) != self.feature_names:
            raise ValueError(
                f"autotune predictor: predict() features "
                f"{sorted(point['features'])} do not match the fitted "
                f"columns {self.feature_names}")
        raw = point_vector(point, self.knob_names, self.feature_names)
        return (raw - self._mean) / self._scale

    def predict(self, knobs: Dict[str, Any],
                features: Optional[Dict[str, Any]] = None) -> float:
        """Ridge estimate of the objective at ``knobs`` (+ analytic
        ``features`` when the fit used any)."""
        return float(self._row(knobs, features) @ self._weights
                     + self._bias)

    def nearest(self, knobs: Dict[str, Any],
                features: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """The measured point closest to ``knobs`` in standardized
        space — exact on any point that was actually swept."""
        row = self._row(knobs, features)
        best_i, best_d = 0, float("inf")
        for i, p in enumerate(self.points):
            raw = point_vector(p, self.knob_names, self.feature_names)
            d = float(np.sum(((raw - self._mean) / self._scale - row)
                             ** 2))
            if d < best_d:
                best_i, best_d = i, d
        return self.points[best_i]


def _standardize(X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, scale) per column; zero-variance columns get scale 1 so
    they standardize to a constant 0 and contribute nothing (an
    analytic feature that never varies across the sweep — e.g. flops
    at fixed shapes — is carried but inert, by construction)."""
    mean = X.mean(axis=0)
    std = X.std(axis=0)
    scale = np.where(std > 0, std, 1.0)
    return mean, scale


def _ridge(Xs: np.ndarray, y: np.ndarray,
           l2: float) -> Tuple[np.ndarray, float]:
    yc = y - y.mean()
    n_cols = Xs.shape[1]
    A = Xs.T @ Xs + l2 * np.eye(n_cols)
    w = np.linalg.solve(A, Xs.T @ yc)
    return w, float(y.mean())


def fit_points(domain: str, points: Sequence[Dict[str, Any]], *,
               l2: float = 1e-2
               ) -> Tuple[Predictor, Dict[str, Any]]:
    """Fit the ridge predictor and compute its exact leave-one-out
    report: ``{"loo_rel_err": mean, "loo_rel_err_max": max, "n": N}``.

    With fewer than 3 points LOO is meaningless; the report then
    carries ``loo_rel_err = 1.0`` (maximally untrustworthy) rather
    than a flattering NaN — a 2-point smoke sweep must never look
    better calibrated than the committed 6-point one."""
    pts = list(points)
    knob_names, feature_names = _check_points(domain, pts)
    X = np.stack([point_vector(p, knob_names, feature_names)
                  for p in pts])
    y = np.asarray([float(p["objective"]) for p in pts],
                   dtype=np.float64)
    mean, scale = _standardize(X)
    Xs = (X - mean) / scale
    w, b = _ridge(Xs, y, l2)
    pred = Predictor(domain, knob_names, feature_names, mean, scale,
                     w, b, pts)

    n = len(pts)
    if n < 3:
        report = {"loo_rel_err": 1.0, "loo_rel_err_max": 1.0, "n": n}
        return pred, report
    rel_errs: List[float] = []
    idx = np.arange(n)
    for i in range(n):
        keep = idx != i
        m_i, s_i = _standardize(X[keep])
        w_i, b_i = _ridge((X[keep] - m_i) / s_i, y[keep], l2)
        est = float((X[i] - m_i) / s_i @ w_i + b_i)
        denom = max(abs(y[i]), 1e-12)
        rel_errs.append(abs(est - y[i]) / denom)
    report = {"loo_rel_err": float(np.mean(rel_errs)),
              "loo_rel_err_max": float(np.max(rel_errs)), "n": n}
    return pred, report


def best_point(domain: str,
               points: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The MEASURED argbest point under the domain's objective
    direction — what the committed table records (the predictor ranks
    unmeasured candidates; the table never claims more than what was
    measured)."""
    pts = list(points)
    _check_points(domain, pts)
    _, direction = _knobs.OBJECTIVES[domain]
    key = lambda p: float(p["objective"])  # noqa: E731 - local sort key
    return (min if direction == "min" else max)(pts, key=key)
