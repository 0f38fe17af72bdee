"""obsq — the query CLI over the port's obs artifacts, ported from the
JAX package's ``tools/obsq.py``.

The port's obs layer emits events (``SINGA_OBS`` JSONL sink,
trace-stamped), dumps incident flight rings (``runs/torch/incidents/``)
and appends durable records (``runs/torch/records.jsonl``); obsq
answers questions over them.  It runs as ``python -m
singa_tpu_torch.tools.obsq`` (``obsq`` below):

    # one request's (or one train run's) full timeline; a glob merges a
    # process tier's per-worker sink files (serve.net writes one per
    # process) into one ordered timeline
    obsq trace serve-...-e0/r7 --events ev.jsonl
    obsq trace mptier-...-q0 --events 'ev.jsonl*'

    # recompute a serve_load record's SLO numbers from raw traces and
    # assert they match (--check: exit 1 on a mismatch)
    obsq slo --records runs/torch/records.jsonl \
        --events ev.jsonl --check

    # metric trajectory across the last N records of one kind
    obsq diff serve_load --fields tokens_per_s,ttft_p99_ms

    # one sweep group's points (autotune_sweep or loadgen ratio-sweep
    # records) with the knob columns flattened in
    obsq diff --sweep atsweep-20260804-...

    # trajectory tripwire: exit 1 when the newest record's field moved
    # more than the bound against its predecessor (green with fewer
    # than two records)
    obsq diff perf_attr --assert-last "attributed_s<=+75%"

    # flight dumps under the store's incidents/ and whether a record
    # links each one
    obsq incidents

    # the runtime-attribution table of a perf_attr record (or a payload
    # dump from the load generator's --perf-attr PATH)
    obsq attr
    obsq attr /tmp/perf_attr.json

What ``slo`` recomputes, and from what:

* **TTFT p50/p99** — the ``serve.ttft_ms`` histogram observations are
  emitted as individual trace-stamped events; obsq replays them through
  the SAME bounded-ring nearest-rank estimator the live histograms use
  (``singa_tpu_torch.obs.events._Hist``), so when the events file covers
  the record's run the recomputed percentiles equal the recorded ones up
  to the record's 3-decimal rounding.
* **tokens/s** — every delivered token is a ``serve.token`` counter
  event (all delivery paths: prefill first token, decode ticks,
  recovery/preemption replays); obsq divides the count by the event
  stream's time span.  The span excludes the load generator's pre-first-
  arrival and post-last-token slack, so this match is tolerance-based
  (``--tps-tol-pct``, default 30), not exact: the check catches a record
  whose throughput claim the traces cannot support, not clock skew.

Importable: :func:`load_events`, :func:`expand_event_paths`,
:func:`derive_slo`, :func:`compare_slo`, :func:`trace_events`,
:func:`render_trace`, :func:`diff_rows`, :func:`assert_last`,
:func:`attr_rows`, :func:`incidents_rows`, :func:`main`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..obs import record as obs_record
from ..obs.events import _Hist

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: the port's record store, never the JAX package's runs/records.jsonl
_STORE = os.path.join(_REPO, obs_record.DEFAULT_STORE)


# ---------------------------------------------------------------------------
# event loading
# ---------------------------------------------------------------------------

def expand_event_paths(patterns: Sequence[str]) -> List[str]:
    """Resolve ``--events`` arguments to concrete files, expanding glob
    patterns — a multi-process serve tier (``serve.net``) writes ONE
    sink file per worker process (``ev.jsonl.p0-mp0``, ...), so the
    natural invocation is ``--events 'ev.jsonl*'``.  Literal paths pass
    through untouched (missing ones surface as open() errors, naming
    the file); a glob pattern matching nothing raises — a trace
    silently rendered from zero of its per-process files would read as
    an empty timeline, not a wrong invocation."""
    import glob as _glob
    out: List[str] = []
    for pat in patterns:
        if any(ch in pat for ch in "*?["):
            hits = sorted(_glob.glob(pat))
            if not hits:
                raise ValueError(
                    f"--events pattern {pat!r} matches no files")
            out.extend(hits)
        else:
            out.append(pat)
    return out


def load_events(*paths: str) -> List[Dict[str, Any]]:
    """Parse one or more JSONL event files (a sink file, its ``.1``
    rollover, a flight dump, or every per-process sink of a
    multi-process run) into a single time-ordered list.  A malformed
    line raises ValueError naming file and line — a truncated trace
    must fail loudly, not read as a shorter run."""
    out: List[Dict[str, Any]] = []
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for i, ln in enumerate(f, 1):
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    ev = json.loads(ln)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{path}:{i}: not a valid event line ({e.msg})")
                if not isinstance(ev, dict):
                    raise ValueError(
                        f"{path}:{i}: event line is not an object")
                out.append(ev)
    out.sort(key=lambda e: e.get("t", 0.0))
    return out


def trace_events(events: Sequence[Dict[str, Any]],
                 trace_id: str) -> List[Dict[str, Any]]:
    """The subset of ``events`` stamped with ``trace_id`` (time order
    preserved)."""
    return [e for e in events if e.get("trace") == trace_id]


def render_trace(events: Sequence[Dict[str, Any]], trace_id: str) -> str:
    """Human timeline of one trace: relative-ms offsets, kind/name,
    and the attrs that matter, followed by a derived summary (TTFT,
    token count, span of the trace)."""
    evs = trace_events(events, trace_id)
    if not evs:
        return f"obsq: no events for trace {trace_id!r}"
    t0 = evs[0].get("t", 0.0)
    lines = [f"trace {trace_id}  ({len(evs)} events)"]
    skip = {"t", "kind", "name", "trace"}
    for e in evs:
        rel = (e.get("t", t0) - t0) * 1e3
        attrs = " ".join(f"{k}={e[k]}" for k in sorted(e) if k not in skip)
        lines.append(f"  +{rel:9.3f} ms  {e.get('kind', '?'):<8}"
                     f"{e.get('name', '?'):<24}{attrs}")
    ttft = [e["value"] for e in evs
            if e.get("name") == "serve.ttft_ms" and "value" in e]
    tokens = sum(1 for e in evs if e.get("name") == "serve.token")
    span_ms = (evs[-1].get("t", t0) - t0) * 1e3
    lines.append(f"  -- summary: ttft="
                 f"{f'{ttft[0]:.3f} ms' if ttft else 'n/a'}"
                 f" tokens={tokens} span={span_ms:.3f} ms")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# slo — recompute a serve_load record from raw traces
# ---------------------------------------------------------------------------

def derive_slo(events: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Trace-derived SLO quantities: TTFT percentiles via the live
    histograms' own estimator, token count from ``serve.token``
    deliveries, wall span from the serve event stream."""
    hist = _Hist()
    ttft_traces = []
    tokens = 0
    ts: List[float] = []
    for e in events:
        name = e.get("name", "")
        if not str(name).startswith("serve."):
            continue
        if "t" in e:
            ts.append(e["t"])
        if name == "serve.ttft_ms" and "value" in e:
            hist.observe(float(e["value"]))
            ttft_traces.append(e.get("trace"))
        elif name == "serve.token":
            tokens += 1
    summ = hist.summary() or {}
    wall = (max(ts) - min(ts)) if len(ts) >= 2 else 0.0
    return {
        "requests_with_first_token": int(hist.count),
        "ttft_p50_ms": summ.get("p50"),
        "ttft_p99_ms": summ.get("p99"),
        "tokens": tokens,
        "wall_s": wall,
        "tokens_per_s": tokens / wall if wall > 0 else 0.0,
        "ttft_traces": ttft_traces,
    }


def compare_slo(derived: Dict[str, Any], payload: Dict[str, Any], *,
                tol_pct: float = 1.0,
                tps_tol_pct: float = 30.0) -> List[str]:
    """Mismatches between trace-derived quantities and a ``serve_load``
    payload ([] = the record is reproducible from the traces).
    Percentiles compare within ``tol_pct`` percent (plus the record's
    3-decimal rounding); tokens/s within ``tps_tol_pct`` (see module
    docstring for why throughput is tolerance-based)."""
    errors: List[str] = []

    def close(a: float, b: float, pct: float, abs_slack: float) -> bool:
        return abs(a - b) <= abs_slack + pct / 100.0 * max(abs(a), abs(b))

    for field in ("ttft_p50_ms", "ttft_p99_ms"):
        want = payload.get(field)
        got = derived.get(field)
        if want is None:
            errors.append(f"record has no {field}")
        elif got is None:
            errors.append(f"traces contain no serve.ttft_ms events to "
                          f"derive {field} from")
        elif not close(float(got), float(want), tol_pct, 2e-3):
            errors.append(
                f"{field}: trace-derived {got:.3f} vs recorded "
                f"{want} (tolerance {tol_pct}%)")
    want_tps = payload.get("tokens_per_s")
    got_tps = derived.get("tokens_per_s", 0.0)
    if want_tps is None:
        errors.append("record has no tokens_per_s")
    elif not derived.get("tokens"):
        errors.append("traces contain no serve.token delivery events to "
                      "derive tokens_per_s from")
    elif not close(float(got_tps), float(want_tps), tps_tol_pct, 0.05):
        errors.append(
            f"tokens_per_s: trace-derived {got_tps:.1f} vs recorded "
            f"{want_tps} (tolerance {tps_tol_pct}%)")
    return errors


def _pick_record(store_path: str, run_id: Optional[str],
                 kind: str = "serve_load") -> Dict[str, Any]:
    entries = [e for e in obs_record.RunRecord(store_path).entries()
               if e["kind"] == kind
               and (run_id is None or e["run_id"] == run_id)]
    if not entries:
        raise LookupError(
            f"no {kind} record"
            f"{f' with run_id {run_id!r}' if run_id else ''} in "
            f"{store_path}")
    return entries[-1]            # file order: newest append wins


# ---------------------------------------------------------------------------
# diff — metric trajectory across records
# ---------------------------------------------------------------------------

def _flat_payload_items(payload: Dict[str, Any]):
    """Numeric payload items, with one level of ``knobs.<name>`` /
    ``features.<name>`` flattening so a sweep point's knob settings
    render as columns next to its objective."""
    for k, v in sorted(payload.items()):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            yield k, v
        elif k in ("knobs", "features") and isinstance(v, dict):
            for kk, vv in sorted(v.items()):
                if isinstance(vv, (int, float)) and \
                        not isinstance(vv, bool):
                    yield f"{k}.{kk}", vv


def _flat_get(payload: Dict[str, Any], key: str) -> Any:
    if "." in key:
        head, tail = key.split(".", 1)
        sub = payload.get(head)
        return sub.get(tail) if isinstance(sub, dict) else None
    return payload.get(key)


def diff_rows(store_path: str, kind: Optional[str], last: int = 5,
              fields: Optional[List[str]] = None,
              sweep: Optional[str] = None
              ) -> Tuple[List[str], List[List[Any]]]:
    """(header, rows) of the numeric-payload trajectory across the last
    ``last`` records of ``kind`` (file order = append order).  Columns
    are ``fields`` or every numeric payload key seen; the final row is
    the relative change of the newest record vs its predecessor — the
    table the record-driven autotuner consumes.

    With ``sweep`` set, rows are instead the ENTIRE record group whose
    payload carries that ``sweep_id`` (any kind unless one is named —
    autotune_sweep points and loadgen ratio-sweep serve_load entries
    both qualify), with ``knobs.<name>`` columns flattened in — the
    autotuner's own debugging front door (``obsq diff --sweep <id>``)."""
    entries = [e for e in obs_record.RunRecord(store_path).entries()
               if (kind is None or e["kind"] == kind)
               and (sweep is None
                    or e.get("payload", {}).get("sweep_id") == sweep)]
    if not entries:
        what = (f"records with sweep_id {sweep!r}" if sweep
                else f"{kind!r} records")
        raise LookupError(f"no {what} in {store_path}")
    if sweep is None:
        entries = entries[-max(1, int(last)):]
    if fields is None:
        keys: List[str] = []
        for e in entries:
            for k, _v in _flat_payload_items(e.get("payload", {})):
                if k not in keys:
                    keys.append(k)
    else:
        keys = list(fields)
    header = ["run_id"] + keys
    rows: List[List[Any]] = []
    for e in entries:
        payload = e.get("payload", {})
        rows.append([e["run_id"]]
                    + [_flat_get(payload, k) for k in keys])
    if len(rows) >= 2 and sweep is None:
        # a trajectory's newest-vs-previous delta is the question diff
        # answers; a sweep's points are parallel measurements, where a
        # neighbor delta would just compare unrelated knob settings
        delta: List[Any] = ["Δ last vs prev"]
        for k in keys:
            new, old = rows[-1][1 + keys.index(k)], \
                rows[-2][1 + keys.index(k)]
            if isinstance(new, (int, float)) and isinstance(
                    old, (int, float)) and old:
                delta.append(f"{100.0 * (new - old) / abs(old):+.1f}%")
            else:
                delta.append("-")
        rows.append(delta)
    return header, rows


#: --assert-last spec: FIELD OP SIGNED_PERCENT%  (e.g. "total_s<=+50%",
#: "tokens_per_s>=-10%") — the bound is on the newest record's
#: relative change vs its predecessor
_ASSERT_RE = re.compile(
    r"^\s*([A-Za-z0-9_.]+)\s*(<=|>=)\s*([+-]?\d+(?:\.\d+)?)\s*%\s*$")


def assert_last(store_path: str, kind: str, spec: str) -> Optional[str]:
    """Trajectory tripwire: check the newest ``kind``
    record's relative change vs its predecessor against ``spec``
    ("field<=+X%" / "field>=-X%").  Returns the violation message or
    None — and None (trivially green) with fewer than two records,
    so a fresh store never fails CI on an empty trajectory.  A spec
    naming a field either record lacks IS an error: a tripwire
    watching a typo'd field would read as permanently green."""
    m = _ASSERT_RE.match(spec)
    if not m:
        raise ValueError(
            f"--assert-last spec {spec!r} is not FIELD<=+X% / "
            f"FIELD>=-X% (e.g. \"attributed_s<=+75%\")")
    field, op, bound = m.group(1), m.group(2), float(m.group(3))
    entries = [e for e in obs_record.RunRecord(store_path).entries()
               if e["kind"] == kind]
    if len(entries) < 2:
        return None
    new = _flat_get(entries[-1].get("payload", {}), field)
    old = _flat_get(entries[-2].get("payload", {}), field)
    for name, v in (("newest", new), ("previous", old)):
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(
                f"--assert-last: the {name} {kind} record has no "
                f"numeric field {field!r}")
    if old == 0:
        return None                     # relative change is undefined
    change = 100.0 * (new - old) / abs(old)
    ok = change <= bound if op == "<=" else change >= bound
    if ok:
        return None
    return (f"{kind}.{field} moved {change:+.1f}% "
            f"({old:.6g} -> {new:.6g}) vs bound {op}{bound:+g}% "
            f"(newest {entries[-1]['run_id']} vs "
            f"{entries[-2]['run_id']})")


# ---------------------------------------------------------------------------
# attr — the runtime-attribution table
# ---------------------------------------------------------------------------

def attr_rows(payload: Dict[str, Any]
              ) -> Tuple[List[str], List[List[Any]]]:
    """(header, rows) of one ``perf_attr`` payload: per program the
    dispatch count, p50/p99 in ms, the achieved-roofline fraction, and
    the measured-vs-modeled slowdown (mean dispatch over the analytic
    minimum at the nominal box — the reciprocal of the fraction, which
    reads naturally as "Nx off the modeled roofline")."""
    header = ["program", "count", "p50_ms", "p99_ms", "total_s",
              "achieved_frac", "vs_model"]
    rows: List[List[Any]] = []
    for name in sorted(payload.get("programs", {})):
        row = payload["programs"][name]
        frac = row.get("achieved_flops_frac")
        rows.append([
            name, int(row["count"]),
            round(float(row["p50_s"]) * 1e3, 3),
            round(float(row["p99_s"]) * 1e3, 3),
            round(float(row["total_s"]), 4),
            round(float(frac), 6) if frac is not None else None,
            (f"x{1.0 / frac:.1f}" if frac else "-"),
        ])
    return header, rows


def _load_attr_payload(source: Optional[str],
                       store_path: str) -> Tuple[str, Dict[str, Any]]:
    """(label, payload) for the attr table: ``source`` is a payload
    dump file (the load generator's --perf-attr PATH) when it names an existing
    .json, a run_id into the store otherwise; default is the store's
    newest perf_attr record."""
    if source and os.path.exists(source):
        with open(source, encoding="utf-8") as f:
            doc = json.load(f)
        if isinstance(doc, dict) and "programs" not in doc \
                and isinstance(doc.get("payload"), dict):
            doc = doc["payload"]
        if not isinstance(doc, dict) or "programs" not in doc:
            raise ValueError(f"{source}: not a perf_attr payload")
        return source, doc
    entry = _pick_record(store_path, source, kind="perf_attr")
    return (f"perf_attr {entry['run_id']} "
            f"({os.path.basename(store_path)})",
            entry.get("payload", {}))


def incidents_rows(store_path: str, last: int = 20
                   ) -> Tuple[List[str], List[List[Any]]]:
    """The newest ``last`` flight dumps under ``<store dir>/incidents/``
    — site and timestamp parsed from the dump filename
    (``<ts>-<site>-<pid>-<seq>.jsonl``), trace ids read from the dump's
    event lines, and ``linked`` answering the REVERSE of a record's
    ``flight_ref`` (which points at a dump): whether each dump on disk
    is pointed AT by some record, so an orphaned dump (its record append
    failed, or it predates the store) is visible instead of silently
    unreachable from any postmortem."""
    base = os.path.dirname(os.path.abspath(store_path))
    inc_dir = os.path.join(base, "incidents")
    if not os.path.isdir(inc_dir):
        raise OSError(f"no incidents directory at {inc_dir} (nothing "
                      f"has dumped next to {store_path})")
    linked = set()
    if os.path.exists(store_path):
        with open(store_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except ValueError:
                    continue
                ref = (entry.get("payload") or {}).get("flight_ref")
                if isinstance(ref, str) and ref:
                    linked.add(os.path.normpath(ref))
    names = sorted(n for n in os.listdir(inc_dir)
                   if n.endswith(".jsonl"))     # ts prefix: chronological
    header = ["dump", "site", "timestamp", "trace", "linked"]
    rows: List[List[Any]] = []
    for name in names[-max(0, last):]:
        parts = name[:-len(".jsonl")].split("-")
        # <%Y%m%d>-<%H%M%S>-<site>-<pid>-<seq>; site never contains "-"
        # today, but join defensively rather than misparse a future one
        site = "-".join(parts[2:-2]) if len(parts) >= 5 else "?"
        ts = "-".join(parts[:2]) if len(parts) >= 5 else "?"
        traces: List[str] = []
        try:
            with open(os.path.join(inc_dir, name),
                      encoding="utf-8") as f:
                for line in f:
                    try:
                        tid = json.loads(line).get("trace")
                    except ValueError:
                        continue
                    if tid and tid not in traces:
                        traces.append(tid)
        except OSError:
            pass
        shown = ("-" if not traces else
                 traces[0] + (f" (+{len(traces) - 1})"
                              if len(traces) > 1 else ""))
        is_linked = os.path.normpath(
            os.path.join("incidents", name)) in linked
        rows.append([name, site, ts, shown,
                     "yes" if is_linked else "NO"])
    return header, rows


def _render_table(header: List[str], rows: List[List[Any]]) -> str:
    def fmt(v: Any) -> str:
        if isinstance(v, float):
            return f"{v:.6g}"
        return "-" if v is None else str(v)
    cells = [header] + [[fmt(v) for v in r] for r in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(len(header))]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(r, widths))
                     for r in cells)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m singa_tpu_torch.tools.obsq",
        description="query the obs layer: request/run timelines, "
                    "trace-derived SLO checks, record trajectories")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_trace = sub.add_parser(
        "trace", help="render one trace's timeline from event files")
    p_trace.add_argument("trace_id")
    p_trace.add_argument("--events", nargs="+", required=True,
                         metavar="FILE",
                         help="event JSONL files (sink output, its .1 "
                              "rollover, and/or a flight dump); glob "
                              "patterns expand, merging a multi-"
                              "process run's per-worker sinks "
                              "('ev.jsonl*') into one timeline")

    p_slo = sub.add_parser(
        "slo", help="recompute a serve_load record's TTFT p50/p99 and "
                    "tokens/s from raw trace events")
    p_slo.add_argument("--events", nargs="+", required=True,
                       metavar="FILE")
    p_slo.add_argument("--records", default=_STORE)
    p_slo.add_argument("--run-id", default=None,
                       help="which serve_load record (default: newest)")
    p_slo.add_argument("--check", action="store_true",
                       help="exit 1 unless the derived numbers match "
                            "the record within tolerance")
    p_slo.add_argument("--tol-pct", type=float, default=1.0,
                       help="percentile tolerance, percent (default 1)")
    p_slo.add_argument("--tps-tol-pct", type=float, default=30.0,
                       help="tokens/s tolerance, percent (default 30)")

    p_diff = sub.add_parser(
        "diff", help="numeric-payload trajectory across the last N "
                     "records of one kind, or one sweep group's "
                     "points (--sweep)")
    p_diff.add_argument("kind", nargs="?", default=None)
    p_diff.add_argument("--sweep", default=None, metavar="SWEEP_ID",
                        help="render every record whose payload "
                             "carries this sweep_id (autotune_sweep "
                             "points, loadgen ratio-sweep entries) "
                             "with knob columns flattened in")
    p_diff.add_argument("--last", type=int, default=5)
    p_diff.add_argument("--records", default=_STORE)
    p_diff.add_argument("--fields", default=None,
                        help="comma-separated payload fields (default: "
                             "every numeric field seen)")
    p_diff.add_argument("--assert-last", default=None, metavar="SPEC",
                        help="exit 1 when the newest record's relative "
                             "change vs its predecessor violates SPEC "
                             "(\"field<=+X%%\" / \"field>=-X%%\"); "
                             "trivially green with <2 records")

    p_inc = sub.add_parser(
        "incidents", help="list flight dumps under the store's "
                          "incidents/ directory: site, timestamp, "
                          "trace id, and whether any record's "
                          "flight_ref links back")
    p_inc.add_argument("--last", type=int, default=20,
                       help="newest N dumps (default 20)")
    p_inc.add_argument("--records", default=_STORE)

    p_attr = sub.add_parser(
        "attr", help="runtime-attribution table of a perf_attr record "
                     "(default: newest in the store) or a payload dump "
                     "from the load generator's --perf-attr")
    p_attr.add_argument("source", nargs="?", default=None,
                        help="payload dump .json file, or a run_id in "
                             "the store (default: newest perf_attr)")
    p_attr.add_argument("--records", default=_STORE)
    args = parser.parse_args(argv)

    try:
        if args.cmd == "trace":
            paths = expand_event_paths(args.events)
            print(render_trace(load_events(*paths), args.trace_id))
            return 0
        if args.cmd == "slo":
            entry = _pick_record(args.records, args.run_id)
            derived = derive_slo(
                load_events(*expand_event_paths(args.events)))
            payload = entry.get("payload", {})
            print(f"serve_load {entry['run_id']} "
                  f"({os.path.basename(args.records)}):")
            for field in ("ttft_p50_ms", "ttft_p99_ms", "tokens_per_s"):
                print(f"  {field:<14} recorded={payload.get(field)!r:>12} "
                      f"trace-derived={derived.get(field)}")
            print(f"  (derived from {derived['requests_with_first_token']}"
                  f" first tokens, {derived['tokens']} deliveries over "
                  f"{derived['wall_s']:.3f} s of events)")
            errors = compare_slo(derived, payload,
                                 tol_pct=args.tol_pct,
                                 tps_tol_pct=args.tps_tol_pct)
            for e in errors:
                print(f"obsq: MISMATCH: {e}", file=sys.stderr)
            if errors:
                return 1
            print("obsq: record reproducible from traces")
            return 0
        if args.cmd == "diff":
            if args.kind is None and args.sweep is None:
                parser.error("diff needs a record kind and/or --sweep "
                             "SWEEP_ID")
            if args.assert_last is not None:
                if args.kind is None:
                    parser.error("--assert-last needs a record kind")
                viol = assert_last(args.records, args.kind,
                                   args.assert_last)
                if viol:
                    print(f"obsq: ASSERT FAILED: {viol}",
                          file=sys.stderr)
                    return 1
                print(f"obsq: assert ok: {args.kind} "
                      f"{args.assert_last!r}")
                return 0
            fields = ([f.strip() for f in args.fields.split(",")
                       if f.strip()] if args.fields else None)
            header, rows = diff_rows(args.records, args.kind,
                                     last=args.last, fields=fields,
                                     sweep=args.sweep)
            print(_render_table(header, rows))
            return 0
        if args.cmd == "incidents":
            header, rows = incidents_rows(args.records, last=args.last)
            print(_render_table(header, rows))
            unlinked = sum(1 for r in rows if r[-1] == "NO")
            if unlinked:
                print(f"obsq: {unlinked}/{len(rows)} dumps have no "
                      f"flight_ref back-link from "
                      f"{os.path.basename(args.records)}",
                      file=sys.stderr)
            return 0
        if args.cmd == "attr":
            label, payload = _load_attr_payload(args.source,
                                                args.records)
            print(f"runtime attribution — {label}")
            header, rows = attr_rows(payload)
            print(_render_table(header, rows))
            w = payload.get("window_s")
            af = payload.get("attributed_frac")
            if isinstance(w, (int, float)):
                print(f"  window={w:.3f} s  attributed="
                      f"{payload.get('attributed_s', 0.0):.3f} s"
                      + (f"  ({100.0 * af:.1f}% of window)"
                         if isinstance(af, (int, float)) else ""))
            return 0
    except (OSError, ValueError, LookupError) as e:
        print(f"obsq: {e}", file=sys.stderr)
        return 1
    parser.error(f"unknown command {args.cmd!r}")
    return 2


if __name__ == "__main__":
    import signal
    if hasattr(signal, "SIGPIPE"):
        signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    raise SystemExit(main())
