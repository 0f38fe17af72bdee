"""The comparison that decides `correct`: each number that the cell's
limits file names, beside its limit.

A number passes when it is at most its limit; a cell with no limits yet
never reads correct."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List


def rel_gap(got: float, want: float, floor: float) -> float:
    """|got − want| over the larger of |want| and `floor`."""
    return abs(got - want) / max(abs(want), floor)


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   names) -> tuple:
    """(the widest gap of a leaf's norm, that leaf) over `names`: the
    program's norm against the reference's, each measured against the
    larger of the reference's norm of that leaf and of the median leaf."""
    names = list(names)
    med = statistics.median(want[n] for n in names)
    worst, at = 0.0, None
    for n in names:
        g = rel_gap(got[n], want[n], med)
        if not math.isfinite(g) or g > worst:
            worst, at = (math.inf if not math.isfinite(g) else g), n
            if worst == math.inf:
                break
    return worst, at


def moved_leaves(ref_grads: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is at least `share` of the
    median leaf's: the others move by round-off alone."""
    med = statistics.median(ref_grads.values())
    return [n for n, g in ref_grads.items() if g >= share * med]


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> tuple:
    """(correct, checks): the numbers the cell's limits name, each
    [name, value, limit] in the limits' order; a cell without limits
    lists every number with no limit and is not correct."""
    names = list(limits) if limits else list(numbers)
    checks: List[list] = []
    ok = bool(limits)
    for name in names:
        value = numbers.get(name)
        lim = limits.get(name, {}).get("limit")
        passed = (lim is not None and value is not None
                  and math.isfinite(value) and value <= lim)
        ok = ok and passed
        checks.append([name, value, lim])
    return ok, checks
