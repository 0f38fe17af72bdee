"""The committed best-config table, ported from
``singa_tpu/autotune/table.py``: what the autotuner measured on the
card, in a form ``ServeEngine``, the elastic policy and the load driver
consult by default.

One JSON document, the port's own
(``singa_tpu_torch/autotune/data/best.json``; the JAX package's table is
never read by default), rewritten by ``python -m
singa_tpu_torch.tools.autotune fit --update-best`` and reviewed in the
diff, never edited by hand:

.. code-block:: json

    {"schema_version": 1,
     "configs": {
       "serve/llama-d2048-L2/cuda": {
         "knobs": {"num_slots": 8, "block_size": 32, "spec_k": 0},
         "objective_name": "tokens_per_s", "objective": 123.4,
         "sweep_id": "atsweep-...", "run_id": "at-...-3",
         "loo_rel_err": 0.12,
         "card": "NVIDIA H100 80GB HBM3, 700.00 W"}}}

An entry may carry more fields than the schema requires (``card``:
the card's name and power limit as nvidia-smi reports them).

Resolution precedence, everywhere a consumer asks (:func:`resolve`):

1. an explicit kwarg or CLI value always wins;
2. else the table's entry for ``(domain, model, platform)``, the
   platform being the consumer's device type (``"cuda"`` or
   ``"cpu"``);
3. else the constant the consumer shipped with, announced once per
   process per reason on stderr.

Every ``run_id`` the table cites must exist in the port's record store
(``runs/torch/records.jsonl``; :func:`validate_table` checks it when
given the store's ids), and a table whose ``schema_version`` trails the
obs schema fails validation.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

from ..obs import schema as obs_schema
from . import knobs as _knobs

__all__ = ["DEFAULT_TABLE", "ENV_TABLE", "table_path", "load_table",
           "validate_table", "config_key", "model_key", "arch_key",
           "platform_of",
           "best_knobs", "resolve", "resolve_spec_k", "pick_spec_k",
           "update_table", "SPEC_K_FALLBACK"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

#: committed location, repo-relative (package data of singa_tpu_torch)
DEFAULT_TABLE = os.path.join("singa_tpu_torch", "autotune", "data",
                             "best.json")

#: env override for tests and ad-hoc tables
ENV_TABLE = "SINGA_AUTOTUNE_TABLE"

#: the constant ServeEngine(spec_k=None) falls back to when no table
#: entry decides k (the reference's)
SPEC_K_FALLBACK = 3

#: warn-once registry: one stderr line per distinct reason per process
_WARNED: set = set()


def _warn_once(reason: str) -> None:
    if reason in _WARNED:
        return
    _WARNED.add(reason)
    print(f"autotune: {reason}", file=sys.stderr)


def table_path(path: Optional[str] = None) -> str:
    """Resolve the table location: explicit arg > ``SINGA_AUTOTUNE_TABLE``
    env > the committed repo default."""
    if path:
        return path
    env = os.environ.get(ENV_TABLE)
    if env:
        return env
    return os.path.join(_REPO_ROOT, DEFAULT_TABLE)


def config_key(domain: str, model: str, platform: str) -> str:
    return f"{domain}/{model}/{platform}"


def model_key(model: Any) -> str:
    """Deterministic per-architecture identity for table keys: class
    name plus the width/depth that shape every compiled program.  Two
    models with the same key compile the same programs, which is the
    granularity the table's knobs apply at."""
    return arch_key(type(model).__name__, getattr(model, "cfg", None))


def arch_key(name: str, cfg: Any) -> str:
    """:func:`model_key` of a model of class ``name`` over ``cfg``,
    without building it."""
    dim = getattr(cfg, "dim", None)
    layers = getattr(cfg, "num_layers", None)
    if isinstance(dim, int) and isinstance(layers, int):
        return f"{name.lower()}-d{dim}-L{layers}"
    return name.lower()


def validate_table(doc: Any, ctx: str = "best.json",
                   store_run_ids: Optional[set] = None) -> List[str]:
    """Error strings ([] = valid).  Checks shape, the schema-version
    staleness guard, knob-name reality per entry, and — when the
    caller supplies the store's run_id set — that every cited record
    exists (``python -m singa_tpu_torch.tools.autotune check`` passes
    it)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"{ctx}: expected an object, got {type(doc).__name__}"]
    ver = doc.get("schema_version")
    if ver != obs_schema.SCHEMA_VERSION:
        return [f"{ctx}: schema_version {ver!r} does not match the "
                f"current obs schema {obs_schema.SCHEMA_VERSION} — the "
                f"table is stale; re-run `python -m singa_tpu_torch."
                f"tools.autotune fit --update-best` against a fresh "
                f"sweep"]
    configs = doc.get("configs")
    if not isinstance(configs, dict) or not configs:
        return [f"{ctx}: 'configs' must be a non-empty object, got "
                f"{configs!r}"]
    for key, entry in sorted(configs.items()):
        c = f"{ctx}: configs[{key!r}]"
        parts = str(key).split("/")
        if len(parts) != 3 or not all(parts):
            errors.append(f"{c}: key must be 'domain/model/platform'")
            continue
        domain = parts[0]
        if not isinstance(entry, dict):
            errors.append(f"{c}: expected an object")
            continue
        errors.extend(_knobs.validate_knobs(domain, entry.get("knobs"),
                                            ctx=c))
        for field in ("objective_name", "sweep_id", "run_id"):
            v = entry.get(field)
            if not isinstance(v, str) or not v:
                errors.append(f"{c}: {field!r} must be a non-empty "
                              f"string, got {v!r}")
        for field in ("objective", "loo_rel_err"):
            v = entry.get(field)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                errors.append(f"{c}: {field!r} must be numeric, got "
                              f"{v!r}")
        ev = entry.get("spec_evidence")
        if ev is not None:
            if not isinstance(ev, dict) or not isinstance(
                    ev.get("run_id"), str) or not ev.get("run_id"):
                errors.append(f"{c}: 'spec_evidence' must carry the "
                              f"winning record's 'run_id'")
        if store_run_ids is not None:
            cited = [entry.get("run_id")]
            if isinstance(ev, dict):
                cited.append(ev.get("run_id"))
            for rid in cited:
                if isinstance(rid, str) and rid and \
                        rid not in store_run_ids:
                    errors.append(
                        f"{c}: cites run_id {rid!r} which does not "
                        f"exist in the record store — a best point "
                        f"must reference its measured evidence")
    return errors


def load_table(path: Optional[str] = None, *,
               required: bool = False) -> Optional[Dict[str, Any]]:
    """Parse + validate the table.  Missing file: None (or raise when
    ``required``).  An INVALID table always raises — consumers must
    fall back only on absence, never on quiet corruption."""
    p = table_path(path)
    if not os.path.exists(p):
        if required:
            raise FileNotFoundError(
                f"autotune: no best-config table at {p} — run "
                f"`python -m singa_tpu_torch.tools.autotune sweep` then "
                f"`fit --update-best`")
        return None
    with open(p, encoding="utf-8") as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{p}: not valid JSON ({e.msg} at line "
                             f"{e.lineno})") from e
    errors = validate_table(doc, ctx=p)
    if errors:
        raise ValueError("; ".join(errors))
    return doc


def best_knobs(domain: str, model: str, platform: str,
               path: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The committed knob dict for ``(domain, model, platform)``, or
    None — with the loud-once fallback announcements the resolution
    contract promises."""
    doc = load_table(path)
    if doc is None:
        _warn_once(f"no best-config table at {table_path(path)}; "
                   f"{domain} consumers fall back to built-in defaults")
        return None
    entry = doc["configs"].get(config_key(domain, model, platform))
    if entry is None:
        _warn_once(f"best-config table has no entry for "
                   f"{config_key(domain, model, platform)}; falling "
                   f"back to built-in defaults")
        return None
    return dict(entry["knobs"])


def resolve(domain: str, model: str, platform: str,
            explicit: Dict[str, Any],
            defaults: Optional[Dict[str, Any]] = None,
            path: Optional[str] = None) -> Dict[str, Any]:
    """One resolved knob dict: ``explicit`` (non-None values) beats the
    table beats ``defaults`` (falling back to the registry's
    :data:`~singa_tpu_torch.autotune.knobs.DEFAULTS`).  The returned dict
    covers exactly the union of the inputs' knob names."""
    base = dict(_knobs.DEFAULTS.get(domain, {}))
    if defaults:
        base.update(defaults)
    table = best_knobs(domain, model, platform, path) or {}
    out: Dict[str, Any] = {}
    for name in sorted(set(base) | set(table)
                       | {k for k, v in explicit.items()
                          if v is not None}):
        if explicit.get(name) is not None:
            out[name] = explicit[name]
        elif name in table:
            out[name] = table[name]
        else:
            out[name] = base[name]
    return out


def platform_of(model: Any) -> str:
    """The table platform of a port model: its device's type
    (``"cuda"`` or ``"cpu"``)."""
    from ..model import model_device
    return model_device(model).torch_device.type


def resolve_spec_k(model: Any, platform: Optional[str] = None,
                   path: Optional[str] = None) -> int:
    """The verify-k window for ``ServeEngine(draft_model=..,
    spec_k=None)``: the table's committed ``spec_k`` for this (model,
    platform) when it decides speculation is worth it (k >= 1), else
    :data:`SPEC_K_FALLBACK` — announced once.  The caller already
    chose TO speculate by passing a draft model; the table only picks
    HOW DEEP.  ``platform`` defaults to the model's device type."""
    if platform is None:
        platform = platform_of(model)
    knobs = best_knobs("serve", model_key(model), platform, path) or {}
    k = knobs.get("spec_k")
    if isinstance(k, (int, float)) and not isinstance(k, bool) and \
            int(k) >= 1:
        return int(k)
    if k is not None:
        _warn_once(f"best-config table advises spec_k={int(k)} (no "
                   f"speculation win) for {model_key(model)}/{platform} "
                   f"but a draft_model was supplied; using the "
                   f"fallback spec_k={SPEC_K_FALLBACK}")
    else:
        _warn_once(f"no committed spec_k for {model_key(model)}/"
                   f"{platform}; using the fallback spec_k="
                   f"{SPEC_K_FALLBACK}")
    return SPEC_K_FALLBACK


def pick_spec_k(entries: List[Dict[str, Any]], platform: str,
                model: Optional[str] = None
                ) -> Optional[Dict[str, Any]]:
    """Choose ``spec_k`` from committed ``accept_rate`` /
    ``tokens_per_dispatch`` record fields, per (model, platform).

    Scans the load driver's ``--spec-compare`` pair records
    (``serve_load`` entries sharing a ``spec_pair_id``): a speculative
    side qualifies only when it BEAT its paired plain run on tokens/s —
    dispatch density alone is not a win if wall-clock lost.  Among
    qualifying ks the LARGEST tokens/s win over its own paired plain
    run wins (the serve domain's declared objective; the ratio rather than raw
    tokens/s because different pairs may have run different
    workloads) — ``accept_rate`` / ``tokens_per_dispatch`` are the
    qualifying evidence carried into ``spec_evidence``, not the
    ranking metric.  With ``model`` set the match is STRICT: only
    records stamped with that payload ``model`` key count (records
    without a stamp are skipped — a pair measured on one architecture
    must never decide another's k).
    Returns ``{"spec_k", "accept_rate", "tokens_per_dispatch",
    "tokens_per_s_win", "run_id", "pair_id"}`` or None when no
    committed pair shows a win."""
    pairs: Dict[str, List[Dict[str, Any]]] = {}
    for e in entries:
        if e.get("kind") != "serve_load" or e.get("platform") != platform:
            continue
        p = e.get("payload") or {}
        if model is not None and p.get("model") != model:
            continue
        if p.get("spec_pair_id"):
            pairs.setdefault(p["spec_pair_id"], []).append(e)
    best: Optional[Dict[str, Any]] = None
    for pair_id, group in sorted(pairs.items()):
        plain = [e for e in group
                 if not e["payload"].get("spec_k")]
        spec = [e for e in group
                if e["payload"].get("spec_k")
                and "accept_rate" in e["payload"]
                and "tokens_per_dispatch" in e["payload"]]
        if not plain or not spec:
            continue
        plain_tps = max(float(e["payload"]["tokens_per_s"])
                        for e in plain)
        for e in spec:
            p = e["payload"]
            if float(p["tokens_per_s"]) <= plain_tps:
                continue
            cand = {"spec_k": int(p["spec_k"]),
                    "accept_rate": float(p["accept_rate"]),
                    "tokens_per_dispatch":
                        float(p["tokens_per_dispatch"]),
                    "tokens_per_s_win":
                        float(p["tokens_per_s"]) / plain_tps,
                    "run_id": e["run_id"], "pair_id": pair_id}
            if best is None or cand["tokens_per_s_win"] > \
                    best["tokens_per_s_win"]:
                best = cand
    return best


def update_table(key: str, entry: Dict[str, Any],
                 path: Optional[str] = None) -> str:
    """Insert/replace one config entry (the ``fit --update-best``
    flow) and atomically rewrite the table.  Returns the path.

    A STALE or invalid existing table is discarded (announced) and
    rebuilt fresh rather than raised on: ``fit --update-best`` is the
    documented remedy the stale-table error points at, so it must be
    able to run — and after a schema bump every entry in the old doc
    is stale by definition (the version stamp is document-level),
    so each domain re-fits from its own sweep records."""
    p = table_path(path)
    doc = None
    if os.path.exists(p):
        try:
            doc = load_table(p)
        except ValueError as e:
            _warn_once(f"discarding invalid best-config table at {p} "
                       f"({e}); rebuilding from this fit")
    if doc is None:
        doc = {"schema_version": obs_schema.SCHEMA_VERSION,
               "configs": {}}
    doc["configs"][key] = entry
    errors = validate_table(doc, ctx=p)
    if errors:
        raise ValueError("; ".join(errors))
    os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
    tmp = f"{p}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, p)
    return p
