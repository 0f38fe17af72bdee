"""RunRecord — a durable, schema-versioned, append-only run-record
store, ported from ``singa_tpu/obs/record.py``.

One JSONL file; each line is one immutable v1 entry (see
``singa_tpu_torch.obs.schema``) keyed by ``(run_id, platform, smoke)``.
The invariants this class enforces:

* **append-only** — writing never rewrites other runs' lines: existing
  lines are carried to the new file *byte-for-byte*.  The only in-place
  operation allowed is a run superseding ITS OWN entry (same full key).
* **smoke can never clobber chip** — the key includes ``smoke``, so a
  smoke entry structurally cannot replace an on-card line; and
  :meth:`latest` never returns a smoke entry unless the caller asked
  for smoke explicitly.
* **atomic durability** — every write goes to a temp file in the same
  directory, is fsync'ed, then ``os.replace``d over the store.
* **fail loudly** — entries are validated on the way in and on the way
  out; a malformed line names its line number and field.

The port's entries carry ``platform`` ``"cuda"`` (``"cpu"`` when the
caller asked for the host) and are smoke unless the platform is
``"cuda"``.  Its default store is ``runs/torch/records.jsonl``, apart
from the JAX package's ``runs/records.jsonl``, so no reader of the
reference's records ever meets a port entry.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from . import schema

__all__ = ["RunRecord", "new_entry", "new_run_id", "is_onchip_session_doc",
           "device_kind", "DEFAULT_STORE"]

#: store location relative to a repo root: the port's own, never the
#: JAX package's ``runs/records.jsonl``
DEFAULT_STORE = os.path.join("runs", "torch", "records.jsonl")


#: per-process uniquifier: wallclock has SECOND resolution, so two ids
#: minted by the same process in the same second (a loadgen sweep whose
#: points finish in under a second, the --spec-compare pair) would
#: collide — and the store treats an equal (run_id, platform, smoke)
#: key as self-supersede, silently replacing the earlier entry
_RUN_SEQ = itertools.count()


def new_run_id(prefix: str = "run") -> str:
    """Collision-resistant id: wallclock + pid + per-process sequence
    (the sequence is what makes two same-second ids from one process
    distinct — see ``_RUN_SEQ``)."""
    return (f"{prefix}-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"
            f"-{next(_RUN_SEQ)}")


def device_kind(device) -> Tuple[str, str]:
    """(platform, device kind) of a torch device, as an entry records
    them: ``"cuda"`` and the card's name, or ``"cpu"`` twice."""
    import torch     # the obs package imports without torch otherwise
    device = torch.device(device)
    if device.type == "cuda":
        return "cuda", torch.cuda.get_device_name(device)
    return device.type, device.type


def new_entry(kind: str, platform: str, smoke: bool, device: str,
              run_id: Optional[str] = None, *,
              stages: Optional[Dict[str, Any]] = None,
              payload: Optional[Dict[str, Any]] = None,
              extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble (and validate) a v1 entry."""
    entry: Dict[str, Any] = {
        "schema_version": schema.SCHEMA_VERSION,
        "run_id": run_id or new_run_id(kind),
        "kind": kind,
        "platform": platform,
        "smoke": bool(smoke),
        "device": device,
        # a wall-clock stamp that correlates across hosts, not a duration
        "created_at": time.time(),
    }
    if kind == "session":
        entry["stages"] = stages if stages is not None else {}
    else:
        entry["payload"] = payload if payload is not None else {}
    if extra:
        entry.update(extra)
    schema.validate_entry(entry)
    return entry


def _dumps(entry: Dict[str, Any]) -> str:
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@contextlib.contextmanager
def _store_lock(path: str):
    """Exclusive advisory lock serializing read-modify-rename cycles:
    concurrent appenders (bench.py vs a session's incremental _finish)
    must not lose each other's lines.  Sidecar lock file, because the
    store itself is replaced by rename.  Falls back to unlocked on
    platforms without fcntl."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    try:
        import fcntl
    except ImportError:  # pragma: no cover - non-posix
        yield
        return
    with open(os.path.join(d, f".{os.path.basename(path)}.lock"), "w") as lf:
        fcntl.flock(lf.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lf.fileno(), fcntl.LOCK_UN)


class RunRecord:
    """The append-only store over one JSONL file."""

    def __init__(self, path: str):
        self.path = path

    # -- reading ----------------------------------------------------------
    def raw_lines(self) -> List[str]:
        """The file's lines verbatim (no trailing newlines), [] when the
        store doesn't exist yet."""
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [ln for ln in f.read().splitlines() if ln.strip()]

    def entries(self) -> List[Dict[str, Any]]:
        """All entries in file order.  Malformed lines raise SchemaError
        naming the line number."""
        out = []
        for i, ln in enumerate(self.raw_lines(), 1):
            try:
                e = json.loads(ln)
            except json.JSONDecodeError as exc:
                raise schema.SchemaError(
                    f"{self.path}:{i}: not valid JSON ({exc.msg})") from exc
            schema.validate_entry(e, ctx=f"{self.path}:{i}")
            out.append(e)
        return out

    def validate(self) -> List[str]:
        """Lint the whole store: every line parses + validates, and no
        two lines share a key.  Returns error strings ([] when clean)."""
        errors: List[str] = []
        seen: Dict[tuple, int] = {}
        for i, ln in enumerate(self.raw_lines(), 1):
            ctx = f"{self.path}:{i}"
            try:
                e = json.loads(ln)
            except json.JSONDecodeError as exc:
                errors.append(f"{ctx}: not valid JSON ({exc.msg})")
                continue
            try:
                schema.validate_entry(e, ctx=ctx)
                key = schema.entry_key(e)
            except schema.SchemaError as exc:
                errors.append(str(exc))
                continue
            if key in seen:
                errors.append(f"{ctx}: duplicate key {key} "
                              f"(first at line {seen[key]})")
            else:
                seen[key] = i
        return errors

    def latest(self, kind: Optional[str] = None,
               platform: Optional[str] = None,
               smoke: bool = False) -> Optional[Dict[str, Any]]:
        """Newest matching entry, or None.

        Smoke entries are returned ONLY when ``smoke=True`` was asked
        for — a smoke run can never shadow an on-chip record."""
        best = None
        for e in self.entries():
            if bool(e["smoke"]) != bool(smoke):
                continue
            if kind is not None and e["kind"] != kind:
                continue
            if platform is not None and e["platform"] != platform:
                continue
            if best is None or e["created_at"] >= best["created_at"]:
                best = e
        return best

    # -- writing ----------------------------------------------------------
    def append(self, entry: Dict[str, Any]) -> None:
        """Validate + durably append ``entry``.

        If a line with the SAME full key ``(run_id, platform, smoke)``
        exists, it is superseded in place (a run checkpointing itself);
        every other line is preserved byte-for-byte.  Keys differing in
        any component — including ``smoke`` — always append a new line,
        so a smoke entry structurally cannot overwrite an on-chip one.

        The read-modify-rename cycle runs under an exclusive file lock
        so concurrent appenders cannot lose each other's lines."""
        schema.validate_entry(entry)
        key = schema.entry_key(entry)
        with _store_lock(self.path):
            lines = self.raw_lines()
            replaced = False
            for i, ln in enumerate(lines):
                try:
                    existing_key = schema.entry_key(json.loads(ln))
                except (json.JSONDecodeError, schema.SchemaError) as exc:
                    raise schema.SchemaError(
                        f"{self.path}:{i + 1}: refusing to append over a "
                        f"corrupt store line ({exc}); fix or quarantine "
                        f"the store first") from exc
                if existing_key == key:
                    lines[i] = _dumps(entry)
                    replaced = True
                    break
            if not replaced:
                lines.append(_dumps(entry))
            _atomic_write(self.path, "\n".join(lines) + "\n")


def is_onchip_session_doc(doc: Any) -> bool:
    """Heuristic for legacy (pre-schema) session documents: does this
    look like an on-chip record that must be protected from overwrite?

    v1 entries answer from their own fields; legacy docs infer from the
    probe stage's detected platform and the recorded device kind."""
    if not isinstance(doc, dict):
        return False
    if "schema_version" in doc:
        return (not doc.get("smoke", False)
                and str(doc.get("platform", "")).lower() != "cpu")
    stages = doc.get("stages")
    if isinstance(stages, dict):
        probe = stages.get("probe")
        if isinstance(probe, dict):
            platform = probe.get("result")
            if isinstance(platform, str):
                return platform.lower() != "cpu"
    device = doc.get("device")
    if isinstance(device, str) and device:
        return "cpu" not in device.lower()
    return False
