"""Run-record schema, ported from ``singa_tpu/obs/schema.py``:
versioned field contracts for the telemetry records the port writes.

Every consumer of a record goes through :func:`require`, so a missing
field fails loudly with its *name* and the context it was needed in,
and :func:`validate_entry` checks whole entries so a stale or
truncated record is caught at write time.  The contracts are the
reference's, field for field, so a record either package writes is
judged the same way by both.

Three record shapes are covered:

* **v1 entries** — what :class:`singa_tpu_torch.obs.record.RunRecord`
  stores: one JSON object per run, keyed by ``(run_id, platform,
  smoke)``, with ``schema_version`` stamped.  Strictly validated.
* **legacy session docs** — pre-v1 session documents (a bare
  ``{"stages": ..., "device": ...}`` object).  Structurally validated;
  grandfathered fields are not retro-required.
* **bench records** — ``BENCH_rNN.json`` /
  ``MULTICHIP_rNN.json``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SCHEMA_VERSION", "SchemaError", "require", "validate_entry",
           "validate_stage", "validate_session_doc", "validate_bench_doc",
           "validate_multichip_doc", "validate_serve_payload",
           "validate_serve_load_payload", "validate_train_run_payload",
           "validate_incident_payload", "validate_chaos_campaign_payload",
           "validate_hlo_audit_payload",
           "validate_autotune_sweep_payload", "validate_perf_attr_payload",
           "validate_wire_byte_fields", "validate_flight_ref",
           "validate_serve_tier_fields", "validate_spec_fields",
           "validate_serve_spill_fields", "validate_serve_arena_fields",
           "validate_serve_transport_fields", "entry_key"]

#: bump when entry fields change incompatibly; validators dispatch on it
SCHEMA_VERSION = 1

_KINDS = ("session", "bench", "serve_throughput", "serve_load",
          "train_run", "incident", "hlo_audit", "autotune_sweep",
          "perf_attr", "chaos_campaign")

#: required numeric payload fields of a serve_throughput entry — the
#: serving bench's headline quantities (tools/record_check.py lints
#: committed serving records against these alongside the training ones)
_SERVE_FIELDS = ("tokens_per_s", "speedup_vs_sequential", "ttft_p50_ms",
                 "ttft_p99_ms", "requests")

#: required numeric payload fields of a serve_load entry — what one
#: tools/loadgen.py open-loop traffic run commits: the offered load,
#: how much of it survived, the SLO percentiles, and the overload
#: outcomes (shed + rejected), so scheduler/paging changes are judged
#: on p99 TTFT and tokens/s under overload rather than on unit tests
_SERVE_LOAD_FIELDS = ("requests", "completed", "shed", "rejected",
                      "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms")

#: the disaggregated-tier pool fields (tools/loadgen.py driving a
#: serve.disagg Router): how the tier was shaped (worker counts per
#: pool), how many KV handoffs crossed it, and the handoff p99 wait
#: (prefill-finish -> decode-inject, decode-capacity queueing
#: included).  OPTIONAL on serve_load payloads — a single-engine run
#: has no pools — but a record carrying ANY of them must carry ALL,
#: numeric (a ratio-sweep point whose worker counts went missing could
#: not support the independent-scaling claim the sweep exists to make)
_SERVE_TIER_FIELDS = ("prefill_workers", "decode_workers", "handoffs",
                      "handoff_p99_ms")

#: the speculative-decoding pair (ServeEngine(draft_model=, spec_k=) /
#: tools/loadgen.py --spec-k / bench.py --serve): the draft accept rate
#: and the delivered tokens per per-slot program dispatch (1.0 for a
#: plain engine by definition).  OPTIONAL on serve_load AND
#: serve_throughput payloads — but a record carrying EITHER must carry
#: BOTH, numeric (an accept rate with no dispatch-density evidence, or
#: vice versa, cannot support the tokens-per-dispatch claim
#: speculation exists to make)
_SPEC_FIELDS = ("accept_rate", "tokens_per_dispatch")

#: the KV spill-tier trio (ServeEngine(spill_blocks=) /
#: tools/loadgen.py --spill-blocks): evicted prefix blocks spilled to
#: host RAM, spilled blocks restored on prefix hits, and the cumulative
#: host-side restore wait.  OPTIONAL on serve_load payloads — a run
#: with no spill tier has nothing to report — but a record carrying ANY
#: of them must carry ALL, numeric (spill pressure with no restore
#: evidence, or hits with no wait cost, cannot support the
#: TTFT-on-re-hit claim the tier exists to make)
_SERVE_SPILL_FIELDS = ("spilled_blocks", "prefetch_hits",
                       "prefetch_wait_ms")

#: the multi-process transport trio (tools/loadgen.py --procs driving a
#: serve.net ProcRouter): KV bytes the handoff wire actually carried,
#: the p99 serialize+deserialize cost per handoff, and how many elastic
#: pool resizes the run performed.  OPTIONAL on serve_load payloads —
#: an in-process tier has no wire — but a record carrying ANY of them
#: must carry ALL, numeric (a multi-process tokens/s claim without its
#: wire-cost evidence cannot support the handoff-over-sockets story;
#: see docs/serving.md, "Multi-process serving")
_SERVE_TRANSPORT_FIELDS = ("handoff_wire_bytes", "handoff_ser_ms_p99",
                           "resizes")

#: the KV-arena memory-hierarchy compare (bench.py --serve
#: --arena-compare): peak measured concurrency of an f32 paged arena
#: and of an int8 QuantKV arena holding the SAME HBM byte budget (both
#: byte totals on the record), against the fixed-arena slot ceiling
#: that budget buys.  OPTIONAL on serve_throughput payloads — the
#: plain serving bench has no quantized arena — but a record carrying
#: ANY of the int8-side fields (``_SERVE_ARENA_TRIGGERS``) must carry
#: ALL FIVE, numeric: a quantized peak without the equal-bytes
#: evidence (or without the f32 peak it beats) cannot support the
#: concurrency-per-byte claim the int8 tier exists to make (see
#: docs/serving.md, "KV memory hierarchy").  The fixed/paged pair
#: alone stays valid — the paged-vs-fixed compare predates the int8
#: tier.
_SERVE_ARENA_FIELDS = ("fixed_max_concurrent", "paged_peak_concurrent",
                       "quant_peak_concurrent", "arena_bytes_f32",
                       "arena_bytes_int8")
_SERVE_ARENA_TRIGGERS = ("quant_peak_concurrent", "arena_bytes_f32",
                         "arena_bytes_int8")

#: required numeric payload fields of a train_run entry — what the
#: training orchestrator (singa_tpu.train.TrainRunner) commits for
#: every run: how far it got, how long it took, how many checkpoints
#: it landed, and where it resumed from (-1 = fresh start)
_TRAIN_RUN_FIELDS = ("steps", "wall_s", "ckpt_count", "resumed_from")

#: the gradient-sync wire-byte pair (DistOpt compression="int8_ring" /
#: bench.py --quantized): per-participant bytes the wire actually
#: carried vs what f32 collectives would have cost.  OPTIONAL on
#: train_run and bench payloads — but a record carrying either must
#: carry BOTH as numerics (a lone "compressed" number with no f32
#: reference cannot support a reduction claim), linted exactly like the
#: required fields
_WIRE_BYTE_FIELDS = ("wire_bytes_compressed", "wire_bytes_f32_equiv")

#: required numeric payload fields of an hlo_audit entry — one run of
#: the compiled-program invariant gates (tools/lint/hlo.py structure +
#: tools/lint/cost.py cost): how many flagship programs were lowered,
#: how many findings drifted, the aggregate structural quantities
#: (fusions, collectives, while loops) AND the analytic cost numerics
#: (total flops / HBM traffic / collective wire bytes, max per-program
#: peak live bytes) whose trajectory the drift history tracks next to
#: the perf records — the bench trajectory accumulates cost history
#: for the record-driven autotuner (ROADMAP item 4).  The cost fields
#: joined the required set WITHOUT a SCHEMA_VERSION bump because no
#: committed store anywhere carried an hlo_audit entry yet (verified at
#: the time of the change) — were one to exist, this would need the
#: version dance instead
_HLO_AUDIT_FIELDS = ("programs", "drifted", "fusions", "collectives",
                     "while_loops", "flops", "hbm_bytes", "peak_bytes",
                     "wire_bytes")

#: required payload fields of an autotune_sweep entry — one measured
#: point (point >= 0) or the fit summary (point == -1) of a knob sweep
#: (singa_tpu.autotune.sweep): which domain/model the sweep tuned,
#: which sweep group the point belongs to, what was measured.  The
#: ``knobs`` dict is structurally validated here (non-empty, numeric
#: values); knob-NAME reality against the registry is the dynamic
#: audit's job (``python -m tools.lint --records`` imports
#: singa_tpu.autotune.knobs), keeping this module free of an
#: autotune import cycle.  A fit record must carry ``loo_rel_err`` —
#: a committed best config without its trustworthiness number is a
#: vibe
_AUTOTUNE_STR_FIELDS = ("domain", "model", "objective_name", "sweep_id")
_AUTOTUNE_NUM_FIELDS = ("objective", "point")
_AUTOTUNE_DOMAINS = ("train", "serve")

#: required numeric payload fields of a perf_attr entry —
#: the enclosing measured window and how much of it the ledger
#: attributed to programs; ``programs`` itself is validated
#: per-program (``_PERF_ATTR_PROGRAM_FIELDS``)
_PERF_ATTR_FIELDS = ("window_s", "attributed_s", "attributed_frac")

#: required numerics per program of a perf_attr payload: the exact
#: dispatch count/total, the ring percentiles, and the
#: achieved-roofline fraction joined from the analytic cost model
#: (singa_tpu_torch.obs.attr.attribution_payload) — a program row missing
#: its achieved fraction is a clock with no model to reconcile
#: against, which is the gap this record kind exists to close
_PERF_ATTR_PROGRAM_FIELDS = ("count", "total_s", "p50_s", "p99_s",
                             "achieved_flops_frac")

#: required string payload fields of an incident entry — one fired
#: fault or recovery action (singa_tpu_torch.faults / ServeEngine resilience):
#: which seam (site), what happened there (fault), what the system did
#: about it (outcome); ``ref`` (step or request id) and numeric
#: ``retries`` are validated separately in validate_incident_payload
_INCIDENT_STR_FIELDS = ("site", "fault", "outcome")

#: required numeric payload fields of a chaos_campaign entry — one
#: seeded chaos campaign against a live multi-process tier
#: (tools/chaosd.py): the seed that makes the event sequence
#: reproducible, the event counts by kind (kills / hangs / injected
#: fault plans / resizes), what the self-healing layer did about them
#: (respawns adopted, requests rerouted, worker deaths declared), and
#: the traffic served across it all.  ``bitwise_ok`` — every stream
#: matched its single-engine reference — is validated separately as a
#: STRICT bool (the campaign's headline claim must never lint as a
#: numeric measurement, nor a number as the claim)
_CHAOS_CAMPAIGN_FIELDS = ("seed", "events", "kills", "hangs",
                          "fault_plans", "resizes", "respawns",
                          "reroutes", "worker_deaths", "requests",
                          "completed")


class SchemaError(ValueError):
    """A record failed validation.  ``field`` names the offending field
    so consumers/CI report *what* is missing, never a raw KeyError."""

    def __init__(self, message: str, field: Optional[str] = None):
        super().__init__(message)
        self.field = field


def require(mapping: Any, field: str, ctx: str = "record") -> Any:
    """Named-field access: ``mapping[field]`` that raises
    :class:`SchemaError` ("<ctx>: missing required field '<field>'")
    instead of KeyError, and rejects non-dict containers loudly."""
    if not isinstance(mapping, dict):
        raise SchemaError(f"{ctx}: expected an object with field "
                          f"{field!r}, got {type(mapping).__name__}",
                          field=field)
    if field not in mapping:
        raise SchemaError(f"{ctx}: missing required field {field!r} "
                          f"(present: {sorted(mapping)})", field=field)
    return mapping[field]


def _expect(cond: bool, msg: str, field: Optional[str] = None) -> None:
    if not cond:
        raise SchemaError(msg, field=field)


def entry_key(entry: Dict[str, Any]) -> Tuple[str, str, bool]:
    """The store key: ``(run_id, platform, smoke)``."""
    return (str(require(entry, "run_id", "entry")),
            str(require(entry, "platform", "entry")),
            bool(require(entry, "smoke", "entry")))


def validate_stage(name: str, stage: Any, ctx: str = "record") -> None:
    """One session stage: exactly one of ``skipped``, ``ok: true`` (with
    optional ``s``/``result``), or ``ok: false`` + ``error``."""
    c = f"{ctx}: stage {name!r}"
    _expect(isinstance(stage, dict),
            f"{c}: expected an object, got {type(stage).__name__}")
    if stage.get("skipped"):
        return
    ok = require(stage, "ok", c)
    _expect(isinstance(ok, bool), f"{c}: 'ok' must be a bool, got {ok!r}",
            field="ok")
    if not ok:
        err = require(stage, "error", c)
        _expect(isinstance(err, str) and err,
                f"{c}: failed stage needs a non-empty 'error' string",
                field="error")


def validate_entry(entry: Any, ctx: str = "entry") -> None:
    """Strict validation of a v1 store entry."""
    _expect(isinstance(entry, dict),
            f"{ctx}: expected an object, got {type(entry).__name__}")
    ver = require(entry, "schema_version", ctx)
    _expect(ver == SCHEMA_VERSION,
            f"{ctx}: schema_version {ver!r} is not the supported "
            f"{SCHEMA_VERSION}", field="schema_version")
    run_id = require(entry, "run_id", ctx)
    _expect(isinstance(run_id, str) and run_id,
            f"{ctx}: 'run_id' must be a non-empty string, got {run_id!r}",
            field="run_id")
    kind = require(entry, "kind", ctx)
    _expect(kind in _KINDS,
            f"{ctx}: 'kind' must be one of {_KINDS}, got {kind!r}",
            field="kind")
    platform = require(entry, "platform", ctx)
    _expect(isinstance(platform, str) and platform,
            f"{ctx}: 'platform' must be a non-empty string, got "
            f"{platform!r}", field="platform")
    smoke = require(entry, "smoke", ctx)
    _expect(isinstance(smoke, bool),
            f"{ctx}: 'smoke' must be a bool, got {smoke!r}", field="smoke")
    device = require(entry, "device", ctx)
    _expect(isinstance(device, str),
            f"{ctx}: 'device' must be a string, got {device!r}",
            field="device")
    created = require(entry, "created_at", ctx)
    _expect(isinstance(created, (int, float)) and not isinstance(
        created, bool),
            f"{ctx}: 'created_at' must be a unix timestamp, got "
            f"{created!r}", field="created_at")
    if kind == "session":
        stages = require(entry, "stages", ctx)
        _expect(isinstance(stages, dict),
                f"{ctx}: 'stages' must be an object, got "
                f"{type(stages).__name__}", field="stages")
        for sname, stage in stages.items():
            validate_stage(sname, stage, ctx)
    else:
        payload = require(entry, "payload", ctx)
        _expect(isinstance(payload, dict),
                f"{ctx}: 'payload' must be an object, got "
                f"{type(payload).__name__}", field="payload")
        if kind == "serve_throughput":
            validate_serve_payload(payload, f"{ctx}: serve payload")
        elif kind == "serve_load":
            validate_serve_load_payload(payload,
                                        f"{ctx}: serve_load payload")
        elif kind == "train_run":
            validate_train_run_payload(payload, f"{ctx}: train_run payload")
        elif kind == "incident":
            validate_incident_payload(payload, f"{ctx}: incident payload")
        elif kind == "hlo_audit":
            validate_hlo_audit_payload(payload, f"{ctx}: hlo_audit payload")
        elif kind == "autotune_sweep":
            validate_autotune_sweep_payload(
                payload, f"{ctx}: autotune_sweep payload")
        elif kind == "perf_attr":
            validate_perf_attr_payload(payload,
                                       f"{ctx}: perf_attr payload")
        elif kind == "chaos_campaign":
            validate_chaos_campaign_payload(
                payload, f"{ctx}: chaos_campaign payload")
        elif kind == "bench":
            validate_wire_byte_fields(payload, f"{ctx}: bench payload")


def _require_numeric_fields(payload: Any, fields: Tuple[str, ...],
                            ctx: str) -> None:
    """One definition of "a numeric payload field" for every kind that
    carries headline quantities (bools are NOT numbers here — a record
    field accidentally set to True must not lint as a measurement)."""
    for f in fields:
        v = require(payload, f, ctx)
        _expect(isinstance(v, (int, float)) and not isinstance(v, bool),
                f"{ctx}: {f!r} must be numeric, got {v!r}", field=f)


def validate_serve_payload(payload: Any, ctx: str = "serve payload") -> None:
    """The serving bench's headline quantities: every field in
    ``_SERVE_FIELDS`` present and numeric (a serving record with a
    missing TTFT percentile is a silently truncated record).  The optional speculative-decoding pair
    (``_SPEC_FIELDS``) and the optional KV-arena compare group
    (``_SERVE_ARENA_FIELDS``) are linted whenever any of them
    appear."""
    _require_numeric_fields(payload, _SERVE_FIELDS, ctx)
    validate_spec_fields(payload, ctx)
    validate_serve_arena_fields(payload, ctx)


def validate_serve_arena_fields(payload: Any,
                                ctx: str = "payload") -> None:
    """The optional KV-arena memory-hierarchy compare: a payload
    carrying ANY of the int8-side fields (``_SERVE_ARENA_TRIGGERS``)
    must carry all five of ``_SERVE_ARENA_FIELDS``, numeric — a
    quantized concurrency peak stripped of its equal-bytes evidence
    (or of the f32 peak it is measured against) cannot support the
    concurrency-per-byte claim the int8 KV tier exists to make.  The
    fixed/paged pair on its own is NOT a trigger."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _SERVE_ARENA_TRIGGERS):
        _require_numeric_fields(payload, _SERVE_ARENA_FIELDS, ctx)


def validate_serve_load_payload(payload: Any,
                                ctx: str = "serve_load payload") -> None:
    """One loadgen traffic run's outcome: every field in
    ``_SERVE_LOAD_FIELDS`` present and numeric — an overload run whose
    shed/rejected counts went missing would let 'survived the chaos
    run' masquerade as 'served every request'.  The optional
    disaggregated-tier pool fields (``_SERVE_TIER_FIELDS``), the
    optional speculative-decoding pair (``_SPEC_FIELDS``), the optional
    KV spill-tier trio (``_SERVE_SPILL_FIELDS``) and the optional
    multi-process transport trio (``_SERVE_TRANSPORT_FIELDS``) are
    linted whenever any of them appear."""
    _require_numeric_fields(payload, _SERVE_LOAD_FIELDS, ctx)
    validate_serve_tier_fields(payload, ctx)
    validate_spec_fields(payload, ctx)
    validate_serve_spill_fields(payload, ctx)
    validate_serve_transport_fields(payload, ctx)


def validate_serve_spill_fields(payload: Any,
                                ctx: str = "payload") -> None:
    """The optional KV spill-tier trio: a payload carrying ANY of
    ``_SERVE_SPILL_FIELDS`` must carry all three, numeric — spill
    pressure without restore evidence (or hits without their wait
    cost) cannot support the TTFT-on-re-hit claim the spill tier
    exists to make (see docs/serving.md, "KV memory hierarchy")."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _SERVE_SPILL_FIELDS):
        _require_numeric_fields(payload, _SERVE_SPILL_FIELDS, ctx)


def validate_serve_transport_fields(payload: Any,
                                    ctx: str = "payload") -> None:
    """The optional multi-process transport trio: a payload carrying
    ANY of ``_SERVE_TRANSPORT_FIELDS`` must carry all three, numeric —
    a multi-process throughput point whose wire-byte or serialization
    evidence went missing cannot support the KV-handoff-over-sockets
    claim the transport exists to make (see docs/serving.md,
    "Multi-process serving")."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _SERVE_TRANSPORT_FIELDS):
        _require_numeric_fields(payload, _SERVE_TRANSPORT_FIELDS, ctx)


def validate_spec_fields(payload: Any, ctx: str = "payload") -> None:
    """The optional speculative-decoding pair: a payload carrying
    EITHER of ``_SPEC_FIELDS`` must carry both, numeric — an accept
    rate without its tokens-per-dispatch consequence (or vice versa)
    cannot support the dispatch-density claim speculation exists to
    make (see docs/serving.md, "Speculative decoding")."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _SPEC_FIELDS):
        _require_numeric_fields(payload, _SPEC_FIELDS, ctx)


def validate_serve_tier_fields(payload: Any, ctx: str = "payload") -> None:
    """The optional disaggregated-tier pool quartet: a payload carrying
    ANY of ``_SERVE_TIER_FIELDS`` must carry all four, numeric — a
    worker-ratio point without its handoff evidence (or vice versa)
    cannot support the independent-scaling claim (see
    docs/serving.md, "Disaggregated tier")."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _SERVE_TIER_FIELDS):
        _require_numeric_fields(payload, _SERVE_TIER_FIELDS, ctx)


def validate_wire_byte_fields(payload: Any, ctx: str = "payload") -> None:
    """The optional gradient-sync wire-byte pair: a payload carrying
    EITHER of ``_WIRE_BYTE_FIELDS`` must carry both, numeric — a
    compressed byte count without its f32-equivalent reference (or vice
    versa) cannot support the reduction claim the pair exists to make."""
    if not isinstance(payload, dict):
        return
    if any(f in payload for f in _WIRE_BYTE_FIELDS):
        _require_numeric_fields(payload, _WIRE_BYTE_FIELDS, ctx)


def validate_flight_ref(payload: Any, ctx: str = "payload") -> None:
    """The optional flight-recorder dump reference: when an
    incident/train_run payload carries ``flight_ref`` it must be a
    non-empty string — the dump path relative to the record store's
    directory.  A ref that exists but is empty/mistyped would point the
    postmortem at nothing; ``python -m tools.lint --records``
    additionally checks the referenced file exists and parses."""
    if not isinstance(payload, dict) or "flight_ref" not in payload:
        return
    v = payload["flight_ref"]
    _expect(isinstance(v, str) and bool(v),
            f"{ctx}: 'flight_ref' must be a non-empty string (dump path "
            f"relative to the record store), got {v!r}",
            field="flight_ref")


def validate_train_run_payload(payload: Any,
                               ctx: str = "train_run payload") -> None:
    """The orchestrator's run outcome: every field in
    ``_TRAIN_RUN_FIELDS`` present and numeric, so a run that aborted
    mid-write can never masquerade as a complete record; the optional
    wire-byte pair (``wire_bytes_compressed`` / ``wire_bytes_f32_equiv``,
    quantized-sync runs) and the optional ``flight_ref`` (fatal/hung
    runs dump their flight ring) are linted whenever they appear."""
    _require_numeric_fields(payload, _TRAIN_RUN_FIELDS, ctx)
    validate_wire_byte_fields(payload, ctx)
    validate_flight_ref(payload, ctx)


def validate_hlo_audit_payload(payload: Any,
                               ctx: str = "hlo_audit payload") -> None:
    """One compiled-program audit run: every field in
    ``_HLO_AUDIT_FIELDS`` present and numeric — a drift-history entry
    whose counts went missing could not answer 'when did the fusion
    count change' later, which is the entire point of keeping it."""
    _require_numeric_fields(payload, _HLO_AUDIT_FIELDS, ctx)


def validate_autotune_sweep_payload(payload: Any,
                                    ctx: str = "autotune_sweep payload"
                                    ) -> None:
    """One autotune sweep point or fit summary: the string quartet
    (``domain``/``model``/``objective_name``/``sweep_id``) non-empty
    with a registered domain, ``objective``/``point`` numeric, and a
    non-empty all-numeric ``knobs`` object.  A fit record (``point ==
    -1``) must additionally carry its numeric ``loo_rel_err`` — the
    predictor's committed trustworthiness; a measurement point
    carrying one by accident is equally rejected (it would read as a
    calibration claim no fit produced)."""
    for f in _AUTOTUNE_STR_FIELDS:
        v = require(payload, f, ctx)
        _expect(isinstance(v, str) and v,
                f"{ctx}: {f!r} must be a non-empty string, got {v!r}",
                field=f)
    _expect(payload["domain"] in _AUTOTUNE_DOMAINS,
            f"{ctx}: 'domain' must be one of {_AUTOTUNE_DOMAINS}, got "
            f"{payload['domain']!r}", field="domain")
    _require_numeric_fields(payload, _AUTOTUNE_NUM_FIELDS, ctx)
    knobs = require(payload, "knobs", ctx)
    _expect(isinstance(knobs, dict) and bool(knobs),
            f"{ctx}: 'knobs' must be a non-empty object, got {knobs!r}",
            field="knobs")
    for name, value in knobs.items():
        _expect(isinstance(value, (int, float))
                and not isinstance(value, bool),
                f"{ctx}: knob {name!r} must be numeric, got {value!r}",
                field="knobs")
    features = payload.get("features")
    if features is not None:
        _expect(isinstance(features, dict),
                f"{ctx}: 'features' must be an object, got "
                f"{features!r}", field="features")
        for name, value in features.items():
            _expect(isinstance(value, (int, float))
                    and not isinstance(value, bool),
                    f"{ctx}: feature {name!r} must be numeric, got "
                    f"{value!r}", field="features")
    if int(payload["point"]) == -1:
        _require_numeric_fields(payload, ("loo_rel_err",), ctx)
    else:
        _expect("loo_rel_err" not in payload,
                f"{ctx}: 'loo_rel_err' belongs to the fit record "
                f"(point == -1), not a measurement point",
                field="loo_rel_err")


def validate_perf_attr_payload(payload: Any,
                               ctx: str = "perf_attr payload") -> None:
    """One runtime-attribution window: the measured window
    and attributed totals numeric, and a non-empty ``programs`` object
    whose every row carries ``_PERF_ATTR_PROGRAM_FIELDS`` numeric — a
    ledger row whose count or achieved fraction went missing could not
    support the measured-vs-modeled reconciliation later, which is the
    record's entire reason to exist.  Program-key REALITY (subset of
    the flagship set the cost model lowers) is the dynamic audit's job
    (``python -m tools.lint --records`` imports tools.lint.hlo),
    keeping this module free of a tools import."""
    _require_numeric_fields(payload, _PERF_ATTR_FIELDS, ctx)
    programs = require(payload, "programs", ctx)
    _expect(isinstance(programs, dict) and bool(programs),
            f"{ctx}: 'programs' must be a non-empty object, got "
            f"{programs!r}", field="programs")
    for name, row in programs.items():
        _expect(isinstance(name, str) and name,
                f"{ctx}: program keys must be non-empty strings, got "
                f"{name!r}", field="programs")
        _require_numeric_fields(row, _PERF_ATTR_PROGRAM_FIELDS,
                                f"{ctx}: program {name!r}")


def validate_incident_payload(payload: Any,
                              ctx: str = "incident payload") -> None:
    """One fired fault / recovery action in the durable store: ``site``
    (injection-site or subsystem seam), ``fault`` (what fired), and
    ``outcome`` (``retried`` / ``quarantined`` / ``recovered`` /
    ``unrecoverable`` / ...) as non-empty strings; ``ref`` — the step or
    request id the incident is about (string or number); ``retries`` —
    how many attempts were burned, numeric, so postmortems can
    aggregate retry pressure without re-parsing prose."""
    for f in _INCIDENT_STR_FIELDS:
        v = require(payload, f, ctx)
        _expect(isinstance(v, str) and v,
                f"{ctx}: {f!r} must be a non-empty string, got {v!r}",
                field=f)
    ref = require(payload, "ref", ctx)
    _expect(isinstance(ref, (str, int, float)) and not isinstance(ref, bool),
            f"{ctx}: 'ref' must be a step/request id (string or number), "
            f"got {ref!r}", field="ref")
    _require_numeric_fields(payload, ("retries",), ctx)
    validate_flight_ref(payload, ctx)


def validate_chaos_campaign_payload(
        payload: Any, ctx: str = "chaos_campaign payload") -> None:
    """One seeded chaos campaign's invariant summary (tools/chaosd.py):
    every count in ``_CHAOS_CAMPAIGN_FIELDS`` present and numeric, plus
    ``bitwise_ok`` as a STRICT bool — the campaign's headline claim
    ("every stream across every kill/hang/resize matched its
    single-engine reference bit for bit") must be a verdict, not a
    number that happens to be truthy.  A campaign record whose seed or
    event counts went missing could not be re-derived and re-asserted
    from the frozen record, which is the determinism contract the
    campaign exists to honor (docs/robustness.md, "Self-healing")."""
    _require_numeric_fields(payload, _CHAOS_CAMPAIGN_FIELDS, ctx)
    ok = require(payload, "bitwise_ok", ctx)
    _expect(isinstance(ok, bool),
            f"{ctx}: 'bitwise_ok' must be a bool, got {ok!r}",
            field="bitwise_ok")
    validate_flight_ref(payload, ctx)


def validate_session_doc(doc: Any, ctx: str = "session record") -> None:
    """A session document: a v1 entry (when ``schema_version`` is
    stamped) or a legacy session document (structural check only —
    grandfathered records cannot be re-measured without a chip)."""
    _expect(isinstance(doc, dict),
            f"{ctx}: expected an object, got {type(doc).__name__}")
    if "schema_version" in doc:
        validate_entry(doc, ctx)
        return
    stages = require(doc, "stages", ctx)
    _expect(isinstance(stages, dict),
            f"{ctx}: 'stages' must be an object, got "
            f"{type(stages).__name__}", field="stages")
    for sname, stage in stages.items():
        validate_stage(sname, stage, ctx)


def validate_bench_doc(doc: Any, ctx: str = "bench record") -> None:
    """A ``BENCH_rNN.json`` record: run metadata + the parsed headline.

    ``parsed`` may be null — that honestly records a round whose
    headline never made it into the run's tail capture.
    When present it must be a complete numeric headline."""
    _expect(isinstance(doc, dict),
            f"{ctx}: expected an object, got {type(doc).__name__}")
    for f in ("n", "cmd", "rc", "tail"):
        require(doc, f, ctx)
    parsed = require(doc, "parsed", ctx)
    if parsed is None:
        return
    c = f"{ctx}: 'parsed' headline"
    for f in ("metric", "value", "unit", "vs_baseline"):
        require(parsed, f, c)
    val = parsed["value"]
    _expect(isinstance(val, (int, float)) and not isinstance(val, bool),
            f"{c}: 'value' must be numeric, got {val!r}", field="value")


def validate_multichip_doc(doc: Any, ctx: str = "multichip record") -> None:
    """A ``MULTICHIP_rNN.json`` smoke result."""
    _expect(isinstance(doc, dict),
            f"{ctx}: expected an object, got {type(doc).__name__}")
    for f in ("n_devices", "ok", "rc"):
        require(doc, f, ctx)


def collect_errors(validator, doc, ctx: str) -> List[str]:
    """Run a validator, returning [] or the error messages (never raises
    — for lint-style reporting over many files)."""
    try:
        validator(doc, ctx)
        return []
    except SchemaError as e:
        return [str(e)]
