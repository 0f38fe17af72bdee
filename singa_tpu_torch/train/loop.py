"""TrainRunner — the run orchestrator: owns a training run end to end,
ported from ``singa_tpu/train/loop.py``.

``Model.train_step`` steps the model; everything around it that turns
"a script that trains" into "a run that survives" lives here:

* **resume** — restore the newest intact checkpoint (params, optimizer
  moments, RNG trajectory, data cursor) and continue the uninterrupted
  trajectory bit-for-bit;
* **liveness** — a :class:`~singa_tpu_torch.utils.failure.Heartbeat`
  watches for wedged steps (hung collective, wedged card) and converts
  silence into a recorded abort instead of an indefinite hang;
* **retry** — transient device errors (RuntimeError/OSError from the
  step) are retried with bounded exponential backoff and an active
  :func:`~singa_tpu_torch.utils.failure.device_liveness_check` probe of
  the model's device between attempts; repeated failure takes a final
  emergency checkpoint, writes the run record, and invokes ``on_fatal``
  (default :func:`~singa_tpu_torch.utils.failure.clean_abort`);
* **preemption** — SIGTERM/SIGINT request checkpoint-and-exit at the
  next step boundary (:mod:`singa_tpu_torch.train.preempt`);
* **observability** — ``train.*`` spans/counters/gauges through
  :mod:`singa_tpu_torch.obs.events`, and a ``train_run`` record appended
  to the durable store on completion/preemption/abort, with the
  platform and device kind of the model's device (``"cuda"`` and the
  card's name on the card).

Retry scope: a retry re-dispatches the SAME step.  That is sound for
dispatch-level transient errors (a failed launch before the step ran);
a mid-execution device loss leaves the parameters half-updated and is
exactly what checkpoint-restart recovery is for — the fatal path, not
the retry path.

On the card a batch becomes tensors on the model's device (token ids
stay int32).  A compiled model's step is captured as a CUDA graph from
its third call; a resume drops the captured step (the restore replaces
the optimizer's slots), so the resumed incarnation steps eagerly twice
and captures again, and each of those calls makes the bits a replay
would.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from ..obs import attr as obs_attr
from ..obs import events
from ..obs import flight as obs_flight
from ..obs import record as obs_record
from ..obs import trace as obs_trace
from ..utils import failure
from .ckpt import AsyncCheckpointManager
from .preempt import PreemptionHandler
from .state import AUX_RUN_STATE, RunState

__all__ = ["TrainRunner", "TrainResult", "TrainAborted"]


class TrainAborted(RuntimeError):
    """Raised (after the emergency checkpoint and run record land) when
    repeated step failure exhausts the retry budget and ``on_fatal``
    declined to end the process."""


@dataclasses.dataclass
class TrainResult:
    outcome: str          # "completed" | "preempted"
    steps: int            # total completed steps (including pre-resume)
    start_step: int       # first step index this incarnation executed
    resumed_from: int     # checkpoint step resumed from, -1 when fresh
    wall_s: float
    ckpt_count: int       # commits performed by this incarnation
    run_id: str


class TrainRunner:
    """Fault-tolerant training orchestrator.

        runner = TrainRunner(model, loader, total_steps=1000,
                             ckpt=AsyncCheckpointManager("ckpts",
                                                         save_every=50),
                             step_timeout=300.0,
                             record_store="runs/torch/records.jsonl")
        result = runner.run()

    The model must be compiled (``model.compile(...)``) with its
    optimizer set before ``run()``; restore happens inside ``run()`` and
    invalidates compiled executors as needed, so compile-then-restore is
    the expected order.

    Parameters beyond the obvious:

    * ``heartbeat`` — a pre-built Heartbeat, or None; ``step_timeout``
      (seconds per step) builds one wired to the runner's fatal path.
    * ``max_retries``/``backoff_base``/``backoff_max`` — transient-error
      retry budget and exponential backoff bounds (seconds).
    * ``record_store`` — path of the durable run-record JSONL (None
      disables record keeping, e.g. in unit tests of other behavior).
    * ``on_fatal(msg)`` — invoked after the emergency checkpoint +
      record on unrecoverable failure; defaults to
      ``failure.clean_abort`` (process exit 42 so a launcher restarts
      into resume).  A callback that RETURNS causes TrainAborted to be
      raised instead.
    * ``on_step(step, outs)`` — post-step hook (metrics, schedulers,
      tests).
    """

    def __init__(self, model, loader: Optional[Iterable], total_steps: int,
                 *, ckpt: Optional[AsyncCheckpointManager] = None,
                 heartbeat: Optional[failure.Heartbeat] = None,
                 step_timeout: Optional[float] = None,
                 max_retries: int = 2, backoff_base: float = 0.25,
                 backoff_max: float = 4.0, liveness_timeout: float = 5.0,
                 preemptible: bool = True,
                 record_store: Optional[str] = None,
                 run_id: Optional[str] = None,
                 on_fatal: Optional[Callable[[str], Any]] = None,
                 on_step: Optional[Callable[[int, Any], Any]] = None,
                 to_batch: Optional[Callable[[Any], Tuple]] = None,
                 _sleep: Callable[[float], None] = time.sleep):
        if total_steps < 1:
            raise ValueError(f"total_steps must be >= 1, got {total_steps}")
        self.model = model
        self.loader = loader
        self.total_steps = int(total_steps)
        self.ckpt = ckpt
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.liveness_timeout = float(liveness_timeout)
        self.preemptible = preemptible
        self.record_store = record_store
        self.run_id = run_id or obs_record.new_run_id("train")
        self.on_fatal = on_fatal
        self.on_step = on_step
        self.to_batch = to_batch
        self._sleep = _sleep
        # _append_record races the heartbeat monitor thread against the
        # step thread (a hang-abort and a fatal-abort can land together);
        # the lock makes write-exactly-once true, not just likely
        self._record_lock = threading.Lock()
        self._record_written = False
        # the incident flight ring: bounded in-memory record
        # of recent steps/retries, dumped on the fatal/hung paths when
        # record_store names a place for the evidence
        self.flight = obs_flight.register(obs_flight.FlightRecorder())
        self._resumed_from = -1
        self._prestep_data: Optional[dict] = None
        self._ckpt0 = ckpt.committed_count if ckpt is not None else 0
        self._t0 = 0.0
        self.heartbeat = heartbeat
        if self.heartbeat is None and step_timeout is not None:
            self.heartbeat = failure.Heartbeat(
                timeout=float(step_timeout),
                on_failure=self._heartbeat_failure)

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> TrainResult:
        # the whole run executes under one trace (the run_id): every
        # span/counter it emits — resume, per-step spans with their
        # retry attempts, checkpoint snapshot/write (the background
        # writer inherits via trace.capture/attach in train.ckpt) —
        # carries it, so `obsq trace <run_id>` renders the run timeline
        with obs_trace.activate(self.run_id):
            return self._run_traced()

    def _run_traced(self) -> TrainResult:
        self._t0 = time.perf_counter()
        start_step = self._restore()
        self._resumed_from = start_step if start_step > 0 else -1
        outcome = "completed"
        completed = start_step
        preempt = PreemptionHandler() if self.preemptible else None
        hb = self.heartbeat
        try:
            if preempt is not None:
                preempt.install()
            if hb is not None:
                hb.start()
            batches = self._batches()
            for step in range(start_step, self.total_steps):
                if self.ckpt is not None and self.loader is not None \
                        and hasattr(self.loader, "state_dict"):
                    # drawing the batch advances the loader cursor past
                    # this (not yet completed) step — the emergency
                    # checkpoint must save the PRE-draw cursor so a
                    # resumed run replays the failed step's own batch
                    self._prestep_data = dict(self.loader.state_dict())
                batch = next(batches)
                outs = self._step_with_retries(step, batch)
                completed = step + 1
                if hb is not None:
                    hb.beat(step)
                events.counter("train.steps", 1)
                self._emit_loss(step, outs)
                if self.on_step is not None:
                    self.on_step(step, outs)
                if preempt is not None and preempt.requested:
                    outcome = "preempted"
                    if hb is not None:
                        # the blocking final write may legitimately
                        # outlast a step timeout — it must not be shot
                        # down by the watchdog it just outlived
                        hb.stop()
                    self._save_checked(completed, force=True, block=True)
                    break
                self._save_checked(completed)
            else:
                # run complete: make the final state durable even when
                # total_steps doesn't land on the save cadence.  Wait
                # first — the cadence save for this very step may still
                # be in flight, and re-snapshotting it would turn the
                # async final save into a duplicate blocking write.
                if self.ckpt is not None:
                    self._wait_checked(completed)
                    if (not self.ckpt.steps()
                            or self.ckpt.steps()[-1] != completed):
                        self._save_checked(completed, force=True)
            if self.ckpt is not None:
                self._wait_checked(completed)
        finally:
            if hb is not None:
                hb.stop()
            if preempt is not None:
                preempt.uninstall()
        wall = time.perf_counter() - self._t0
        self._append_record(outcome, completed, wall)
        return TrainResult(
            outcome=outcome, steps=completed, start_step=start_step,
            resumed_from=self._resumed_from, wall_s=wall,
            ckpt_count=(self.ckpt.committed_count - self._ckpt0
                        if self.ckpt is not None else 0),
            run_id=self.run_id)

    def __enter__(self) -> "TrainRunner":
        return self

    def __exit__(self, *exc) -> bool:
        if self.heartbeat is not None:
            self.heartbeat.stop()
        if self.ckpt is not None:
            self.ckpt.close()
        return False

    # -- resume ------------------------------------------------------------
    def _restore(self) -> int:
        if self.ckpt is None:
            return 0
        with events.span("train.resume"):
            aux = self.ckpt.restore_latest(self.model)
        if aux is None:
            return 0
        if AUX_RUN_STATE in aux:
            rs = RunState.from_aux(aux[AUX_RUN_STATE])
            rs.apply(self.model, self.loader)
            start = rs.step
        else:
            # only commit-marked checkpoints are visible here, and only
            # AsyncCheckpointManager writes markers — so aux["step"] is
            # its convention: steps COMPLETED, i.e. the next step index
            start = int(aux.get("step", 0))
            warnings.warn(
                "resumed from a checkpoint without run_state: data "
                "order and RNG trajectory restart rather than resume",
                stacklevel=2)
        events.gauge("train.resumed_from", start)
        return start

    # -- stepping ----------------------------------------------------------
    def _batches(self):
        if self.loader is None:
            raise ValueError("TrainRunner needs a loader to draw batches "
                             "from (got None)")
        empty_epochs = 0
        while True:
            got = False
            for b in self.loader:
                got = True
                yield self._to_tensors(b)
            # a resumed cursor sitting exactly at an epoch boundary
            # legitimately yields an empty first iteration — two empty
            # epochs in a row means the loader is actually empty
            empty_epochs = 0 if got else empty_epochs + 1
            if empty_epochs >= 2:
                raise RuntimeError("DataLoader yielded no batches for two "
                                   "consecutive epochs")

    def _to_tensors(self, batch) -> Tuple:
        if self.to_batch is not None:
            return tuple(self.to_batch(batch))
        from ..model import model_device
        dev = model_device(self.model).torch_device
        if not isinstance(batch, (tuple, list)):
            batch = (batch,)
        def put(b):
            # the loader's dtypes are kept: token ids and labels int32,
            # features f32.  On the card the batch is staged in pinned
            # memory and copied without blocking the host (as the
            # reference's device_put dispatches): a pageable copy would
            # wait for the step in flight every step
            t = torch.as_tensor(np.asarray(b))
            if dev.type != "cuda":
                return t.to(dev)
            return t.pin_memory().to(dev, non_blocking=True)
        return tuple(b if isinstance(b, torch.Tensor) or b is None
                     else put(b) for b in batch)

    def _step_with_retries(self, step: int, batch: Tuple):
        from .. import faults
        attempt = 0
        while True:
            try:
                # "train.step" injection site: the retried region — an
                # injected InjectedFault is a RuntimeError, so it takes
                # the same backoff/liveness/fatal path a real transient
                # dispatch failure would
                # note BEFORE the injection site: a faulted attempt
                # must still show up in the flight timeline
                self.flight.note("span", "train.step", step=step,
                                 attempt=attempt)
                faults.fire("train.step", step=step, attempt=attempt)
                with events.span("train.step", step=step, attempt=attempt):
                    return self.model.train_step(
                        *(b for b in batch if b is not None))
            except (RuntimeError, OSError) as e:
                # ValueError/TypeError are bugs and propagate; runtime/OS
                # errors are where transient device trouble surfaces
                if isinstance(e, (TrainAborted, failure.FailureDetected)):
                    raise
                alive = True
                if attempt < self.max_retries:
                    alive = failure.device_liveness_check(
                        getattr(self.model, "device", None),
                        timeout=self.liveness_timeout)
                if attempt >= self.max_retries or not alive:
                    probe = "" if alive else \
                        " (device liveness probe failed)"
                    self._fatal(step,
                                f"train step {step} failed after "
                                f"{attempt + 1} attempt(s){probe}: "
                                f"{type(e).__name__}: {e}",
                                data_state=self._prestep_data)
                    raise TrainAborted(
                        f"step {step} unrecoverable: {e}") from e
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** attempt))
                attempt += 1
                events.counter("train.retries", 1, step=step,
                               backoff_s=delay)
                self.flight.note("counter", "train.retries", step=step,
                                 backoff_s=delay,
                                 error=type(e).__name__)
                warnings.warn(
                    f"train step {step} attempt {attempt} failed "
                    f"({type(e).__name__}: {e}); retrying in {delay:.2f}s",
                    stacklevel=2)
                self._sleep(delay)

    def _emit_loss(self, step: int, outs) -> None:
        if not events.enabled():
            return
        try:
            loss = outs[1] if isinstance(outs, tuple) and len(outs) > 1 \
                else outs
            # the fetch runs only when telemetry is enabled, and the
            # fetch IS the measurement
            val = (float(loss) if isinstance(loss, torch.Tensor)
                   else float(np.asarray(getattr(loss, "data", loss))))
            events.gauge("train.loss", val, step=step)
        except Exception:   # telemetry must never break the step loop
            pass

    # -- checkpoint / failure ----------------------------------------------
    def _save(self, completed: int, force: bool = False,
              block: bool = False, data_state: Optional[dict] = None) -> None:
        if self.ckpt is None:
            return
        if not force and completed % self.ckpt.save_every:
            return   # mirror the manager's gate BEFORE paying for the
                     # RunState capture (the generators' states)
        rs = RunState.capture(self.model, self.loader, completed,
                              self.run_id, data_state=data_state)
        self.ckpt.save(completed, self.model, run_state=rs, force=force,
                       block=block)

    def _save_checked(self, completed: int, **kw) -> None:
        """A periodic/final save whose failure (typically a background
        write surfacing in wait(), e.g. ENOSPC) takes the fatal path —
        record + on_fatal — instead of escaping run() unrecorded."""
        try:
            self._save(completed, **kw)
        except Exception as e:
            self._ckpt_fatal(completed, e)

    def _wait_checked(self, completed: int) -> None:
        try:
            self.ckpt.wait()
        except Exception as e:
            self._ckpt_fatal(completed, e)

    def _ckpt_fatal(self, completed: int, e: Exception) -> None:
        self._fatal(completed,
                    f"checkpoint write at step {completed} failed: "
                    f"{type(e).__name__}: {e}")
        raise TrainAborted(
            f"checkpoint write at step {completed} failed: {e}") from e

    def _fatal(self, step: int, msg: str,
               data_state: Optional[dict] = None) -> None:
        """Emergency checkpoint → run record → on_fatal.  Ordered so the
        durable evidence lands even when on_fatal hard-exits.

        ``data_state`` overrides the loader cursor saved with the
        emergency checkpoint — the retry-exhaustion path passes the
        pre-draw cursor because its failed step never completed; the
        checkpoint-failure path leaves it None (its step count DID
        complete, so the live cursor is the right one)."""
        if self.heartbeat is not None:
            # the emergency save below may legitimately outlast a step
            # timeout; the watchdog must not kill the save it triggered
            self.heartbeat.stop()
        events.counter("train.aborts", 1, step=step)
        self.flight.note("counter", "train.aborts", step=step, msg=msg)
        if self.ckpt is not None:
            try:
                self._save(step, force=True, block=True,
                           data_state=data_state)
            except Exception as e:
                warnings.warn(f"emergency checkpoint failed: "
                              f"{type(e).__name__}: {e}", stacklevel=2)
        self._append_record("aborted", step,
                            time.perf_counter() - self._t0,
                            dump=lambda: self._flight_dump("train.fatal",
                                                           msg))
        (self.on_fatal or failure.clean_abort)(msg)

    def _heartbeat_failure(self, age: float, last_step: int) -> None:
        """Monitor-thread path: the step thread is wedged, so no
        checkpoint (the gather would wedge too) — record, then abort.
        (Runs trace-less by design: threads never inherit the run's
        trace context implicitly, and the hang observation is
        run-scoped evidence the record itself carries.)"""
        msg = (f"no heartbeat for {age:.1f}s (last step {last_step}); "
               f"assuming hung collective or dead device")
        events.counter("train.aborts", 1, step=last_step)
        self.flight.note("counter", "train.aborts", step=last_step,
                         msg=msg)
        self._append_record("hung", max(0, last_step + 1),
                            time.perf_counter() - self._t0,
                            dump=lambda: self._flight_dump("train.hung",
                                                           msg))
        (self.on_fatal or failure.clean_abort)(msg)

    # -- durable run record + flight dumps ---------------------------------
    def _flight_dump(self, site: str, reason: str) -> Optional[str]:
        """Dump the flight ring next to the record store and return the
        ``flight_ref`` (or None without a store) — the shared
        :func:`obs.flight.dump_for_store` contract; this thin wrapper
        exists so literal sites at call sites stay SGL009-checkable."""
        return obs_flight.dump_for_store(self.flight, site,
                                         self.record_store, reason)

    def _append_record(self, outcome: str, steps: int, wall_s: float,
                       dump: Optional[Callable[[], Optional[str]]] = None
                       ) -> None:
        if not self.record_store:
            return
        with self._record_lock:
            if self._record_written:
                return
            self._record_written = True
        # the dump thunk runs only after winning the write-exactly-once
        # race: a losing fatal path (step-thread abort vs heartbeat
        # firing together) must not strand an orphan dump that no
        # record's flight_ref points at
        flight_ref = dump() if dump is not None else None
        try:
            from ..model import model_device
            platform, device_kind = obs_record.device_kind(
                model_device(self.model).torch_device)
            payload = {
                "steps": int(steps),
                "wall_s": round(wall_s, 3),
                "ckpt_count": int(self.ckpt.committed_count - self._ckpt0
                                  if self.ckpt is not None else 0),
                "resumed_from": int(self._resumed_from),
                "outcome": outcome,
                "total_steps": int(self.total_steps),
            }
            if flight_ref:
                payload["flight_ref"] = flight_ref
            # runtime attribution: when a ledger is live,
            # the run's dispatch count/seconds ride along as numeric
            # extras — the schema allows extras, and obsq diff can
            # then put step-time drift next to the outcome fields
            led = obs_attr.get()
            if led is not None:
                snap = led.snapshot()
                payload["attr_dispatches"] = int(
                    sum(r["count"] for r in snap.values()))
                payload["attr_attributed_s"] = round(
                    sum(r["total_s"] for r in snap.values()), 6)
            entry = obs_record.new_entry(
                "train_run", platform, platform != "cuda", device_kind,
                run_id=self.run_id, payload=payload)
            obs_record.RunRecord(self.record_store).append(entry)
        except Exception as e:
            # the record is evidence, not a dependency: a full disk must
            # not turn a completed run into a crashed one
            warnings.warn(f"could not append train_run record: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
