"""AsyncCheckpointManager — crash-consistent checkpoints off the step
thread, ported from ``singa_tpu/train/ckpt.py``.

Write protocol (the commit-marker contract
``python -m singa_tpu_torch.tools.ckpt_fsck`` audits):

1. **snapshot** (step thread): params/buffers/optimizer moments are
   copied to host arrays (``utils.checkpoint._collect``: a blocking
   ``.cpu()`` a tensor) — this is the only part the training step waits
   for, and it must run on the step thread: the copy is ordered on the
   stream a captured step replays on, so it reads the parameters after
   the last replay wrote them and before the next one does (and with a
   process group the slot gather is a collective).
2. **serialize** (writer thread): the snapshot is written via
   :func:`singa_tpu_torch.utils.checkpoint.save_arrays` — temp file,
   fsync, atomic rename — so a crash mid-write never leaves a partial
   ``ckpt_<step>.npz`` under the final name.
3. **commit** (writer thread): a sidecar ``ckpt_<step>.npz.commit``
   marker is written (same temp+fsync+rename dance) carrying the
   npz's sha256 and size.  *Only checkpoints with a valid marker are
   ever loadable*: a torn npz (crash between 2 and 3, bit rot, manual
   truncation) fails the sha check and restore falls back to the
   previous commit.
4. **retain** (writer thread): keep-last-N plus keep-every-M GC; the
   marker is deleted before the npz so GC interrupted mid-way
   degrades to an uncommitted (ignored) file, never a committed
   marker pointing at nothing.

The files are the JAX package's ``.npz`` format, markers included, so
either package's restore path and fsck read the other's directory.

Telemetry: the snapshot emits a ``train.ckpt.snapshot`` span on the
step thread and the writer emits ``train.ckpt.write`` — overlapping
``train.step``/``train.ckpt.write`` spans are the observable proof
that serialization never blocked training.

Multi-process runs (a ``torch.distributed`` group) write
synchronously: the end-of-save barrier is a collective that must not
interleave with training collectives — the same rule as
``utils.checkpoint.CheckpointManager``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import warnings
from typing import Dict, List, Optional

from ..obs import events
from ..obs import trace as obs_trace
from ..utils import checkpoint
from .state import AUX_RUN_STATE, RunState

__all__ = ["AsyncCheckpointManager", "CheckpointCorrupt", "COMMIT_SUFFIX",
           "read_marker", "sha256_file"]

COMMIT_SUFFIX = ".commit"


class CheckpointCorrupt(RuntimeError):
    """The checkpoint file exists but is not loadable (no/invalid commit
    marker, sha mismatch, torn npz, manifest mismatch)."""


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def read_marker(path: str) -> Dict:
    """Parse a commit marker; raises CheckpointCorrupt on garbage."""
    try:
        with open(path) as f:
            doc = json.loads(f.read())
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable commit marker ({e})")
    if not isinstance(doc, dict) or "sha256" not in doc or "size" not in doc:
        raise CheckpointCorrupt(f"{path}: commit marker missing sha256/size")
    return doc


class AsyncCheckpointManager:
    """Stepped, crash-consistent checkpoints with a background writer.

        ckpt = AsyncCheckpointManager("ckpts", keep_last=3, keep_every=50,
                                      save_every=10)
        aux = ckpt.restore_latest(model)            # None when fresh
        ...
        ckpt.save(completed_steps, model, run_state=rs)
        ...
        ckpt.close()                                # final write lands

    ``save_every`` gates periodic saves (``force=True`` bypasses);
    ``keep_last`` newest commits are retained plus every commit whose
    step is a multiple of ``keep_every`` (0 disables the keep-every
    rule)."""

    def __init__(self, directory: str, keep_last: int = 3,
                 keep_every: int = 0, save_every: int = 1):
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        if keep_every < 0:
            raise ValueError(f"keep_every must be >= 0, got {keep_every}")
        self.dir = directory
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.save_every = max(1, save_every)
        self.committed_count = 0   # commits performed by THIS manager
        self._pending = None
        self._executor = None
        os.makedirs(directory, exist_ok=True)

    # -- layout ------------------------------------------------------------
    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:012d}.npz")

    def marker_path(self, step: int) -> str:
        return self.path(step) + COMMIT_SUFFIX

    def steps(self) -> List[int]:
        """Committed steps only (a marker must exist; its validity is
        checked at load time), ascending."""
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz" + COMMIT_SUFFIX):
                try:
                    out.append(int(f[5:-len(".npz" + COMMIT_SUFFIX)]))
                except ValueError:
                    pass
        return sorted(out)

    # -- saving ------------------------------------------------------------
    def save(self, step: int, model, run_state: Optional[RunState] = None,
             aux: Optional[Dict] = None, force: bool = False,
             block: bool = False) -> Optional[str]:
        """Snapshot now (step thread), write in the background.

        ``step`` is the number of COMPLETED steps the snapshot
        represents (the RunState convention).  Returns the target path,
        or None when gated by ``save_every``.  At most one write is in
        flight: a new save first waits for the previous one (bounding
        host memory to one snapshot), which only blocks when the save
        cadence outruns the disk."""
        if not force and step % self.save_every:
            return None
        self.wait()                    # one in-flight snapshot at a time
        a = dict(aux or {})
        a["step"] = int(step)
        if run_state is not None:
            a[AUX_RUN_STATE] = run_state.to_aux()
        with events.span("train.ckpt.snapshot", step=step):
            arrays, full_aux = checkpoint._collect(model, a)
        if block or checkpoint._process_count() > 1:
            self._write(step, arrays, full_aux)
        else:
            if self._executor is None:
                from concurrent.futures import ThreadPoolExecutor
                # non-daemon single worker: joined at interpreter exit,
                # so the final write always lands (file IO cannot wedge
                # the way a dead device can — cf. Heartbeat, which IS
                # a daemon for exactly the opposite reason)
                self._executor = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="singa-train-ckpt")
            # the writer INHERITS the saving step's trace context
            # (threads never inherit contextvars implicitly): the
            # train.ckpt.write span belongs to the run/step whose
            # snapshot it serializes, so the overlap is visible inside
            # ONE trace instead of as an orphan span
            ctx = obs_trace.capture()
            self._pending = self._executor.submit(
                self._write_traced, ctx, step, arrays, full_aux)
        return self.path(step)

    def _write_traced(self, ctx, step: int, arrays: Dict,
                      aux: Dict) -> None:
        with obs_trace.attach(ctx):
            self._write(step, arrays, aux)

    def _write(self, step: int, arrays: Dict, aux: Dict) -> None:
        from .. import faults
        with events.span("train.ckpt.write", step=step):
            if checkpoint._process_index() == 0:
                # "ckpt.write" fires before any bytes land, so an
                # injected error surfaces through wait() exactly like
                # ENOSPC would — the caller's _save_checked fatal path
                faults.fire("ckpt.write", step=step, path=self.path(step))
                checkpoint.save_arrays(arrays, self.path(step), aux)
                self._commit(step)
                # "ckpt.torn" tears the npz AFTER its commit marker
                # landed: the sha-checked restore path must skip it
                faults.fire("ckpt.torn", step=step, path=self.path(step))
                self._gc()
            checkpoint._barrier()
        events.counter("train.ckpt.committed", 1, step=step)

    def _commit(self, step: int) -> None:
        path = self.path(step)
        doc = {"step": int(step), "sha256": sha256_file(path),
               "size": os.path.getsize(path)}
        checkpoint.atomic_write(self.marker_path(step),
                                lambda f: json.dump(doc, f), mode="w")
        # sole writer: the one-worker executor; readers (ckpt_count in
        # the run record) tolerate a stale count
        self.committed_count += 1

    def _gc(self) -> None:
        steps = self.steps()
        protected = set(steps[-self.keep_last:])
        if self.keep_every:
            protected |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s in protected:
                continue
            # marker first: an interruption here leaves an uncommitted
            # npz (ignored at load), never a dangling commit
            with contextlib.suppress(OSError):
                os.unlink(self.marker_path(s))
            with contextlib.suppress(OSError):
                os.unlink(self.path(s))
        events.gauge("train.ckpt.retained", len(self.steps()))

    def wait(self) -> None:
        """Block until the in-flight write lands; re-raises a background
        write failure."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Flush the writer; safe to call repeatedly."""
        try:
            self.wait()
        finally:
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    # -- loading -----------------------------------------------------------
    def verify(self, step: int) -> None:
        """Commit-marker + sha check; CheckpointCorrupt when torn."""
        path = self.path(step)
        marker = self.marker_path(step)
        if not os.path.exists(marker):
            raise CheckpointCorrupt(f"{path}: no commit marker — the write "
                                    f"never committed")
        doc = read_marker(marker)
        if not os.path.exists(path):
            raise CheckpointCorrupt(f"{path}: committed but missing")
        size = os.path.getsize(path)
        if size != int(doc["size"]):
            raise CheckpointCorrupt(
                f"{path}: size {size} != committed {doc['size']} (torn)")
        sha = sha256_file(path)
        if sha != doc["sha256"]:
            raise CheckpointCorrupt(
                f"{path}: sha256 mismatch vs commit marker (torn/corrupt)")

    def load_step(self, step: int, model) -> Dict:
        """Load one committed checkpoint into ``model``; returns its aux.

        Raises CheckpointCorrupt for torn/unreadable files; a checkpoint
        that reads fine but does not FIT the model (optimizer signature
        or shape mismatch) raises ValueError — silently skipping past it
        would restart training from an older trajectory."""
        self.verify(step)
        try:
            arrays, aux = checkpoint.load_arrays(self.path(step))
        except Exception as e:
            raise CheckpointCorrupt(
                f"{self.path(step)}: committed but undecodable ({e})") from e
        checkpoint._apply(model, arrays, aux)
        return aux

    def restore_latest(self, model) -> Optional[Dict]:
        """Restore the newest intact commit; returns its aux dict (with
        ``aux['step']`` = completed steps and ``aux['run_state']`` when
        the orchestrator saved one), or None when starting fresh.  Torn
        commits are warned about and skipped, falling back to the
        previous one."""
        try:
            self.wait()
        except Exception as e:
            warnings.warn(
                f"a background checkpoint write had failed "
                f"({type(e).__name__}: {e}); restoring from the commits "
                f"on disk", stacklevel=2)
        for step in reversed(self.steps()):
            try:
                aux = self.load_step(step, model)
            except CheckpointCorrupt as e:
                warnings.warn(f"skipping torn checkpoint at step {step}: "
                              f"{e}", stacklevel=2)
                continue
            events.counter("train.ckpt.restored", 1, step=step)
            return aux
        return None

    def __enter__(self) -> "AsyncCheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
