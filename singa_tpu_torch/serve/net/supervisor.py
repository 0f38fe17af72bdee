"""Multi-process disaggregated serving: supervisor + worker pools,
ported from ``singa_tpu/serve/net/supervisor.py``.

The in-process tier (:mod:`~singa_tpu_torch.serve.disagg`) proves the
prefill/decode split's SCHEDULING story — but its N workers share one
Python interpreter, so N engines never buy parallel host work.  This
module is the same tier shape with the workers in their own OS
processes:

* :func:`build_proc_pools` mirrors ``build_pools``: it spawns N + M
  worker processes (:mod:`.procworker` — one ``ServeEngine`` each, on
  the device ``device`` names: the card unless the caller asks for the
  CPU), each of which builds its model DETERMINISTICALLY from a seeded
  ``module:callable`` builder (same weights in every process — the
  stand-in for weight shipping), makes its own programs, and reports
  readiness (model key, program counts, wall time) over the control
  channel.  Worker processes on one card are time-sliced, and each
  holds its own CUDA context and weight copy.
* :class:`ProcRouter` mirrors ``Router`` over the framed RPC
  (:mod:`.rpc`): submissions route least-loaded, tier rounds pipeline
  (ticks are SENT to every worker before any reply is awaited, so
  worker compute overlaps), and finished prefills hand off through the
  versioned wire codec (:mod:`.codec`) — gather → host staging →
  serialize → socket → digest check → in-place scatter via the
  existing ``inject_handoff``.
* **resilience** is replay, same as the in-process tier: the
  supervisor's :class:`ProcHandle` mirror (prompt + tokens so far) is
  the authoritative copy of every live request, so a dead worker, a
  torn frame (``serve.transport`` chaos), or a failed inject re-routes
  the request via ``resubmit`` on a surviving worker and greedy replay
  keeps the stream bitwise identical.  A torn transfer is NEVER
  injected — the codec rejects it by digest before any engine state is
  touched.
* **elastic pools** — :meth:`ProcRouter.resize` grows (background
  spawn, adopted at a step boundary) or shrinks (drain RPC: the worker
  hands its in-flight requests back as host state, they replay on
  survivors, then the process exits) either pool at runtime; an
  :class:`~singa_tpu_torch.serve.net.elastic.ElasticPolicy` can drive it
  from queue-depth / parked-handoff signals.  ``serve.resize`` faults
  abort a resize cleanly without touching the worker set.
* **self-healing** — a supervisor-side liveness layer
  (per-op RPC deadlines + ``heartbeat`` probes of quiet workers)
  declares a HUNG worker dead as readily as a crashed one, and every
  death funnels into the same path: in-flight requests replay bitwise
  on survivors immediately, then a replacement is respawned in the
  background toward the role's target size and adopted at a step
  boundary exactly like elastic grow (``serve.respawn`` incident).
  K deaths of one role inside a window trip a crash-loop circuit
  breaker (``serve.crashloop`` incident): the tier stops respawning
  that role and degrades to the surviving pools until an explicit
  ``resize()`` closes the breaker.

Observability: each worker writes its own event sink
(``<base>.<worker>``) and every RPC frame carries the contextvar trace
id, so one request's events share one trace id across all processes.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import faults
from ...faults.plan import InjectedFault
from ...obs import events
from ...obs import flight as obs_flight
from ...obs import record as obs_record
from ...obs import trace as obs_trace
from ...obs.events import _Hist
from ..engine import EngineClosed
from ..scheduler import (EVICTED, FAILED, FINISHED, QUEUED, RUNNING,
                         QueueFull)
from ..disagg.router import SLOClass, _merged_summary
from . import rpc

__all__ = ["WorkerProc", "ProcHandle", "ProcRouter", "ProcTierMetrics",
           "build_proc_pools", "WorkerDied"]

_POOL_SEQ = itertools.count()

#: Per-op RPC deadlines (seconds).  One blanket generous timeout (the
#: old ``_CALL_TIMEOUT_S = 120``) meant a silently wedged worker could
#: stall the tier for two minutes before anything noticed; each op now
#: gets the deadline its work actually justifies:
#:
#: * ``heartbeat``/``health`` are header-only probes a healthy worker
#:   answers in microseconds — seconds of allowance is pure scheduler
#:   slack, so a hang is DECLARED in seconds, not minutes;
#: * ``submit``/``resubmit``/``withdraw``/``chaos`` are queue/plan
#:   mutations: host-side bookkeeping only, no device dispatch;
#: * ``tick`` runs one engine round and ``handoff`` moves KV over the
#:   wire — tens of seconds of honest compute on a loaded CPU box;
#: * ``drain``/``shutdown`` bound how long an elastic scale-down or a
#:   close waits before escalating to a kill.
#:
#: A worker's FIRST few ticks and FIRST handoff make and capture its
#: programs — those calls escalate to ``_COMPILE_TIMEOUT_S`` (see
#: :meth:`WorkerProc.op_timeout`) instead of inflating every
#: steady-state deadline.  The table is the reference's, sized for XLA
#: compiles; a card's capture is measured against it (each worker's
#: ``ready_ms`` and ``warm_tick_s``).  On an H100 it holds as it is: a
#: base() worker cut to 2 layers is respawned, built, captured and
#: adopted about 8-9 s after a death, well inside the compile budget,
#: and chaosd's shorter deadlines still declare a hang at their 8 s
#: tick deadline (PERF.md, section 6).
_OP_TIMEOUTS: Dict[str, float] = {
    "heartbeat": 5.0,
    "health": 10.0,
    "submit": 15.0,
    "resubmit": 15.0,
    "withdraw": 15.0,
    "chaos": 15.0,
    "tick": 60.0,
    "handoff": 60.0,
    "drain": 60.0,
    "shutdown": 30.0,
}
#: ops missing from the table (forward compatibility) keep the old
#: blanket deadline
_DEFAULT_TIMEOUT_S = 120.0
#: first-dispatch escalation: programs are made and captured at a
#: worker's first prefill/decode/handoff dispatches, NOT at ready
#: (ready only proves the build), so early ticks/handoffs get the
#: compile budget
_COMPILE_TIMEOUT_S = 300.0
#: how many ok ticks before a worker's tick deadline drops from the
#: compile-aware budget to the steady-state one (the prefill, decode
#: and spec programs are each made on a different early tick)
_WARMUP_TICKS = 4


class WorkerDied(ConnectionError):
    """The worker process behind an RPC went away (socket error, RPC
    timeout, or an op reply the supervisor treats as fatal)."""


class WorkerProc:
    """Supervisor-side proxy for one worker process: the Popen, the
    connected control socket, and the rid mapping (each process draws
    request ids from its own counter, so the supervisor keys everything
    by its OWN qid and maps per-worker)."""

    def __init__(self, name: str, role: str, proc: subprocess.Popen,
                 sock: socket.socket, fabric: "_Fabric"):
        self.name = name
        self.role = role
        self.proc = proc
        self.sock = sock
        self.fabric = fabric
        self.alive = True
        self.load = 0
        self.pid: Optional[int] = None
        self.model_key: Optional[str] = None
        self.compiles: Optional[dict] = None
        self.ready_ms: Optional[float] = None
        #: the longest worker-side tick among the ticks the compile
        #: budget covers (the first ``_WARMUP_TICKS``)
        self.warm_tick_s: Optional[float] = None
        #: a timed-out / errored socket may sit mid-frame — the next
        #: recv on it would misparse stale bytes as a fresh reply, so
        #: the FIRST WorkerDied poisons the connection for good and
        #: every later use fails fast without touching the socket
        self.poisoned = False
        #: monotonic time of the last successful round trip — the
        #: host-side heartbeat age (``ProcRouter._check_liveness``)
        self.last_ok = time.monotonic()
        #: successful ticks / handoff ops so far — drives the
        #: compile-aware deadline escalation in :meth:`op_timeout`
        self.ok_ticks = 0
        self.ok_handoffs = 0
        #: worker-local rid -> supervisor qid for every request this
        #: worker currently owns
        self.wrids: Dict[int, int] = {}

    def op_timeout(self, op: str) -> float:
        """The per-op deadline (``_OP_TIMEOUTS``), compile-aware: a
        worker's early ticks and first handoff escalate to the fabric's
        compile budget because programs are made on first dispatch,
        not at ready."""
        t = self.fabric.op_timeouts.get(op, _DEFAULT_TIMEOUT_S)
        if op == "tick" and self.ok_ticks < _WARMUP_TICKS:
            return max(t, self.fabric.compile_timeout_s)
        if op == "handoff" and self.ok_handoffs < 1:
            return max(t, self.fabric.compile_timeout_s)
        return t

    def _usable(self) -> None:
        if self.poisoned:
            raise WorkerDied(
                f"worker {self.name}: connection poisoned by an "
                f"earlier timeout/socket error (stream may be "
                f"mid-frame); refusing further RPC")

    def _poison(self, e: BaseException) -> WorkerDied:
        self.poisoned = True
        return WorkerDied(
            f"worker {self.name}: {type(e).__name__}: {e}")

    def call(self, header: Dict[str, Any], payload: bytes = b"", *,
             timeout: Optional[float] = None
             ) -> Tuple[Dict[str, Any], bytes]:
        """One RPC round trip; any socket-level failure is a
        :class:`WorkerDied` (the caller escalates to worker death).
        ``timeout=None`` resolves from the per-op table via
        :meth:`op_timeout`."""
        self._usable()
        if timeout is None:
            timeout = self.op_timeout(str(header.get("op", "")))
        try:
            rep, data = rpc.call(self.sock, header, payload,
                                 timeout=timeout)
        except (rpc.RPCError, socket.timeout, OSError) as e:
            raise self._poison(e) from e
        self.last_ok = time.monotonic()
        return rep, data

    def send(self, header: Dict[str, Any], payload: bytes = b"") -> None:
        self._usable()
        try:
            rpc.send_frame(self.sock, header, payload)
        except OSError as e:
            raise self._poison(e) from e

    def recv(self, *, timeout: Optional[float] = None
             ) -> Tuple[Dict[str, Any], bytes]:
        self._usable()
        try:
            rep, data = rpc.recv_frame(
                self.sock,
                timeout=_DEFAULT_TIMEOUT_S if timeout is None
                else timeout)
        except (rpc.RPCError, socket.timeout, OSError) as e:
            raise self._poison(e) from e
        self.last_ok = time.monotonic()
        return rep, data

    def __repr__(self) -> str:
        return (f"WorkerProc({self.name!r}, {self.role}, "
                f"{'alive' if self.alive else 'DEAD'}, "
                f"pid={self.pid}, load={self.load})")


class _Fabric:
    """Spawn plumbing shared by a tier's worker processes: one AF_UNIX
    listener in a private tempdir, the worker config template (so
    elastic grow spawns clones), and the spawn lock that keeps a
    background grow from racing a close."""

    def __init__(self, worker_cfg: dict, *, device: str = "cuda",
                 spawn_timeout_s: float = 300.0,
                 faults_env: Optional[Dict[str, str]] = None,
                 op_timeouts: Optional[Dict[str, float]] = None,
                 compile_timeout_s: float = _COMPILE_TIMEOUT_S):
        self.dir = tempfile.mkdtemp(prefix="singa-net-")
        self.sock_path = os.path.join(self.dir, "sup.sock")
        self.listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.listener.bind(self.sock_path)
        self.listener.listen(64)
        self.worker_cfg = worker_cfg
        #: the workers' device kind ("cuda" or "cpu")
        self.device = device
        self.spawn_timeout_s = spawn_timeout_s
        self.faults_env = dict(faults_env or {})
        #: per-op RPC deadlines — the documented defaults with any
        #: caller overrides on top (tests/chaos runs shrink them)
        self.op_timeouts = {**_OP_TIMEOUTS, **(op_timeouts or {})}
        self.compile_timeout_s = float(compile_timeout_s)
        self.obs_base: Optional[str] = None
        #: every Popen this fabric ever spawned — the no-orphan
        #: invariant audits this ledger (each entry must be an adopted
        #: pool member or already reaped)
        self.procs: List[subprocess.Popen] = []
        self._lock = threading.Lock()
        self._name_seq = {"prefill": itertools.count(),
                          "decode": itertools.count()}
        self._gen = next(_POOL_SEQ)
        self._closed = False

    def next_name(self, role: str) -> str:
        return f"{role[0]}{next(self._name_seq[role])}-mp{self._gen}"

    def _child_env(self) -> Dict[str, str]:
        env = dict(os.environ)
        # never inherit the supervisor's fault plan or event sink: a
        # forwarded plan would double-inject (both sides of one RPC),
        # and a shared sink file would interleave process writes
        for k in ("SINGA_FAULTS", "SINGA_FAULTS_SEED", "SINGA_OBS"):
            env.pop(k, None)
        env.update(self.faults_env)
        # children import singa_tpu_torch (and the model builder) by
        # module path — anchor the repo root regardless of the
        # supervisor's cwd
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        pp = env.get("PYTHONPATH")
        env["PYTHONPATH"] = root if not pp else f"{root}{os.pathsep}{pp}"
        return env

    def spawn_many(self, specs: List[Tuple[str, str]]
                   ) -> List[WorkerProc]:
        """Spawn one worker process per (name, role), wait for each to
        connect + hello + ready.  All children build concurrently; the
        supervisor pays max(build) wall time, not the sum."""
        with self._lock:
            if self._closed:
                raise RuntimeError("fabric is closed")
            procs: Dict[str, subprocess.Popen] = {}
            for name, role in specs:
                cfg = dict(self.worker_cfg)
                if self.obs_base:
                    cfg = dict(cfg, obs_path=f"{self.obs_base}.{name}")
                arg = base64.b64encode(
                    json.dumps(cfg).encode()).decode()
                # a fresh interpreter per worker: never a fork of a
                # process that has touched CUDA
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m",
                     "singa_tpu_torch.serve.net.procworker",
                     "--sock", self.sock_path, "--name", name,
                     "--role", role, "--device", self.device,
                     "--config", arg],
                    env=self._child_env())
            self.procs.extend(procs.values())
            by_name: Dict[str, WorkerProc] = {}
            deadline = time.monotonic() + self.spawn_timeout_s
            roles = dict(specs)
            try:
                self.listener.settimeout(self.spawn_timeout_s)
                while len(by_name) < len(specs):
                    conn, _ = self.listener.accept()
                    hello, _ = rpc.recv_frame(
                        conn, timeout=max(1.0,
                                          deadline - time.monotonic()))
                    name = hello.get("name")
                    if hello.get("op") != "hello" or name not in roles \
                            or name in by_name:
                        conn.close()
                        continue
                    w = WorkerProc(name, roles[name], procs[name], conn,
                                   self)
                    w.pid = hello.get("pid")
                    by_name[name] = w
                out = []
                for name, _role in specs:
                    w = by_name[name]
                    ready, _ = w.recv(
                        timeout=max(1.0, deadline - time.monotonic()))
                    if ready.get("op") != "ready" or not ready.get("ok"):
                        raise WorkerDied(
                            f"worker {name} failed to become ready: "
                            f"{ready}")
                    w.model_key = ready.get("model_key")
                    w.compiles = ready.get("compiles")
                    w.ready_ms = ready.get("ready_ms")
                    out.append(w)
                return out
            except socket.timeout:
                self._reap(procs.values())
                raise WorkerDied(
                    f"spawn timed out: {sorted(set(roles) - set(by_name))} "
                    f"never connected within {self.spawn_timeout_s:.0f}s"
                ) from None
            except BaseException:
                # never leave half-spawned children behind: a failed
                # batch is reaped wholesale (the no-orphan invariant)
                self._reap(procs.values())
                raise
            finally:
                self.listener.settimeout(None)

    @staticmethod
    def _reap(procs) -> None:
        for p in procs:
            try:
                p.kill()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=10.0)
            except (subprocess.TimeoutExpired, OSError):
                pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self.listener.close()
            except OSError:
                pass
            for p in (self.sock_path,):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            try:
                os.rmdir(self.dir)
            except OSError:
                pass


def build_proc_pools(model_spec, n_prefill: int, n_decode: int, *,
                     num_slots: int = 4, max_len: int = 64,
                     block_size: int = 16,
                     num_blocks: Optional[int] = None,
                     share_prefix: bool = True,
                     max_queue: Optional[int] = None,
                     record_store: Optional[str] = None,
                     device: str = "cuda",
                     obs_base: Optional[str] = None,
                     faults_env: Optional[Dict[str, str]] = None,
                     spawn_timeout_s: float = 300.0,
                     self_spec_k: int = 0,
                     op_timeouts: Optional[Dict[str, float]] = None,
                     compile_timeout_s: float = _COMPILE_TIMEOUT_S,
                     **engine_kwargs
                     ) -> Tuple[List[WorkerProc], List[WorkerProc]]:
    """(prefill_workers, decode_workers) as OS processes — the
    multi-process mirror of ``disagg.build_pools``.

    ``model_spec`` is either a ``"module:callable"`` builder string or
    ``{"builder": "mod:fn", "kwargs": {...}}``; every worker calls it as
    ``builder(device=<its Device>, **kwargs)`` under the same seed
    discipline, so all processes hold identical weights.  A worker
    imports the builder's module by name in a fresh interpreter (run
    from the repository root), so it must import without jax, as the
    port does.
    ``device`` is the workers' device: ``"cuda"`` (the default; a
    worker raises without a card) or ``"cpu"``.  A ``param_dtype`` in
    ``engine_kwargs`` may be a torch dtype: it travels by name.
    ``obs_base`` (default: the supervisor's own configured sink path)
    gives each worker a ``<base>.<name>`` event sink;
    ``faults_env`` forwards a ``SINGA_FAULTS`` plan to the CHILDREN
    (worker-side chaos) — by default children are scrubbed of the
    supervisor's plan so one spec never injects on both sides of an
    RPC.  ``op_timeouts`` overrides entries of the per-op RPC deadline
    table (``_OP_TIMEOUTS``) and ``compile_timeout_s`` the
    first-dispatch escalation budget — chaos tests shrink both so hang
    detection is measured in seconds."""
    if n_prefill < 1 or n_decode < 1:
        raise ValueError(
            f"a tier needs at least one worker per pool, got "
            f"{n_prefill} prefill / {n_decode} decode")
    if isinstance(model_spec, str):
        model_spec = {"builder": model_spec}
    pd = engine_kwargs.get("param_dtype")
    if isinstance(pd, torch.dtype):
        engine_kwargs["param_dtype"] = str(pd).removeprefix("torch.")
    worker_cfg = {
        "model": model_spec,
        "self_spec_k": int(self_spec_k),
        "engine": dict(num_slots=num_slots, max_len=max_len,
                       block_size=block_size, num_blocks=num_blocks,
                       share_prefix=share_prefix, max_queue=max_queue,
                       record_store=record_store, **engine_kwargs),
    }
    fabric = _Fabric(worker_cfg, device=device,
                     spawn_timeout_s=spawn_timeout_s,
                     faults_env=faults_env, op_timeouts=op_timeouts,
                     compile_timeout_s=compile_timeout_s)
    if obs_base is None:
        sink = events.get_sink()
        obs_base = getattr(sink, "path", None)
    fabric.obs_base = obs_base
    specs = [(fabric.next_name("prefill"), "prefill")
             for _ in range(n_prefill)]
    specs += [(fabric.next_name("decode"), "decode")
              for _ in range(n_decode)]
    try:
        workers = fabric.spawn_many(specs)
    except BaseException:
        fabric.close()
        raise
    return ([w for w in workers if w.role == "prefill"],
            [w for w in workers if w.role == "decode"])


class ProcHandle:
    """Supervisor-side mirror of one request — the SAME user-facing
    surface as :class:`~singa_tpu_torch.serve.scheduler.RequestHandle`, but
    the state lives here (fed by tick deltas) because the worker that
    owns the request can die: the mirror is what replay resubmits
    from."""

    def __init__(self, qid: int, prompt_ids, max_new_tokens: int,
                 deadline_s: Optional[float], eos_id: Optional[int],
                 trace_id: str, on_token=None):
        self.qid = qid
        self._prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
        self._max_new = int(max_new_tokens)
        self._deadline = (None if deadline_s is None
                          else time.monotonic() + float(deadline_s))
        self._eos = eos_id
        self._trace = trace_id
        self._on_token = on_token
        self._tokens: List[int] = []
        self._state = QUEUED
        self._finish_reason: Optional[str] = None
        self._error: Optional[str] = None
        self._ttft_s: Optional[float] = None

    # -- RequestHandle surface ---------------------------------------------
    @property
    def rid(self) -> int:
        return self.qid

    @property
    def trace_id(self) -> Optional[str]:
        return self._trace

    @property
    def status(self) -> str:
        return self._state

    @property
    def done(self) -> bool:
        return self._state in (FINISHED, EVICTED, FAILED)

    @property
    def failed(self) -> bool:
        return self._state == FAILED

    @property
    def error(self) -> Optional[str]:
        return self._error

    @property
    def finish_reason(self) -> Optional[str]:
        return self._finish_reason

    @property
    def tokens(self) -> List[int]:
        return list(self._tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        return self._ttft_s

    def result(self) -> np.ndarray:
        return np.concatenate(
            [self._prompt, np.asarray(self._tokens, np.int32)])

    # -- mirror feed (tick deltas) -----------------------------------------
    def _append(self, tok: int) -> None:
        self._tokens.append(int(tok))
        if self._state == QUEUED:
            self._state = RUNNING
        if self._on_token is not None:
            self._on_token(int(tok))

    def _finish(self, state: str, reason: Optional[str],
                error: Optional[str]) -> None:
        self._state = state
        self._finish_reason = reason
        self._error = error

    def _deadline_rem(self) -> Optional[float]:
        return (None if self._deadline is None
                else self._deadline - time.monotonic())


class ProcTierMetrics:
    """Tier metrics over worker processes: the supervisor's own
    counters plus ``health`` fan-out aggregation — same ``snapshot()``
    shape as the in-process :class:`TierMetrics`, with the transport
    extras on top.  Workers that were
    drained away (elastic shrink) leave their FINAL health snapshot
    cached here, so tier totals and latency percentiles survive pool
    churn."""

    def __init__(self, router: "ProcRouter"):
        self._router = router
        self.handoffs = 0
        self.reroutes = 0
        self.door_rejected = 0
        self.quota_rejected = 0
        self.worker_deaths = 0
        self.respawns = 0
        self.crashloops = 0
        self.steps = 0
        self.resizes = 0
        self.resizes_aborted = 0
        self.torn_frames = 0
        self.wire_bytes = 0
        self._handoff = _Hist()
        self._ser = _Hist()
        #: worker name -> last health reply (alive workers refresh on
        #: every snapshot; retired/dead workers keep their last)
        self._health: Dict[str, dict] = {}

    # -- supervisor-side events --------------------------------------------
    def on_handoff(self, wait_ms: float, nbytes: int,
                   ser_ms: float) -> None:
        self.handoffs += 1
        self.wire_bytes += int(nbytes)
        self._handoff.observe(wait_ms)
        self._ser.observe(ser_ms)
        events.counter("serve.handoffs", 1)
        events.counter("serve.handoff_wire_bytes", nbytes)
        events.histogram("serve.handoff_ms", wait_ms)
        events.histogram("serve.handoff_ser_ms", ser_ms)

    def on_reroute(self) -> None:
        self.reroutes += 1
        events.counter("serve.rerouted", 1)

    def on_torn_frame(self) -> None:
        self.torn_frames += 1
        events.counter("serve.torn_frame", 1)

    def on_door_reject(self) -> None:
        self.door_rejected += 1
        events.counter("serve.rejected", 1, reason="tier_full")

    def on_worker_death(self, worker: str) -> None:
        self.worker_deaths += 1
        events.counter("serve.worker_dead", 1, worker=worker)

    def on_respawn(self, worker: str) -> None:
        self.respawns += 1
        events.counter("serve.respawn", 1, worker=worker)

    def on_crashloop(self, role: str) -> None:
        self.crashloops += 1
        events.counter("serve.crashloop", 1, role=role)

    def on_resize(self, kind: str) -> None:
        self.resizes += 1
        events.counter("serve.resize", 1, kind=kind)

    def on_step(self) -> None:
        self.steps += 1

    def handoff_summary(self) -> Optional[dict]:
        return self._handoff.summary()

    # -- aggregation -------------------------------------------------------
    def refresh_health(self) -> None:
        for w in self._router.workers():
            if not w.alive:
                continue
            try:
                rep, _ = w.call({"op": "health"})
            except WorkerDied as e:
                self._router._worker_death(w, str(e))
                continue
            if rep.get("ok"):
                self._health[w.name] = rep

    def retire(self, w: WorkerProc) -> None:
        """Fetch (or keep) ``w``'s final health before it leaves the
        tier — best-effort: a dead worker keeps whatever was cached."""
        if not w.alive:
            return
        try:
            rep, _ = w.call({"op": "health"})
            if rep.get("ok"):
                self._health[w.name] = rep
        except WorkerDied:
            pass

    def snapshot(self) -> dict:
        self.refresh_health()
        healths = list(self._health.values())
        snaps = [h["snapshot"] for h in healths]

        def total(key: str) -> int:
            return sum(s[key] for s in snaps)

        def merge(key: str) -> Dict[str, int]:
            out: Dict[str, int] = {}
            for s in snaps:
                for k, v in s[key].items():
                    out[k] = out.get(k, 0) + v
            return out

        def merged(key: str) -> Optional[dict]:
            hists = []
            for h in healths:
                hist = _Hist()
                hist.samples = list(h.get(key) or [])
                hists.append(hist)
            return _merged_summary(hists)

        spec_proposed = total("spec_proposed")
        disp = sum(s["slot_dispatches"] for s in snaps)
        disp_tokens = sum(s["slot_dispatch_tokens"] for s in snaps)
        return {
            "submitted": total("submitted"),
            "spec_rounds": total("spec_rounds"),
            "spec_proposed": spec_proposed,
            "spec_accepted": total("spec_accepted"),
            "spec_fallbacks": total("spec_fallbacks"),
            "accept_rate": (total("spec_accepted") / spec_proposed
                            if spec_proposed else None),
            "tokens_per_dispatch": (disp_tokens / disp if disp else None),
            "admitted": total("admitted"),
            "rejected": self.door_rejected + self.quota_rejected,
            "evicted": merge("evicted"),
            "retries": merge("retries"),
            "quarantined": total("quarantined"),
            "recoveries": total("recoveries"),
            "preempted": total("preempted"),
            "prefix_hits": total("prefix_hits"),
            "prefix_hit_tokens": total("prefix_hit_tokens"),
            "steps": self.steps,
            "ttft_ms": merged("ttft_samples"),
            "token_ms": merged("token_samples"),
            "handoffs": self.handoffs,
            "handoff_ms": self.handoff_summary(),
            "reroutes": self.reroutes,
            "worker_deaths": self.worker_deaths,
            "respawns": self.respawns,
        }


class ProcRouter:
    """Front door + tick loop over worker PROCESSES — the
    :class:`~singa_tpu_torch.serve.disagg.router.Router` contract
    (submit / step / drain / close, tier_stats, metrics.snapshot) for a
    tier whose workers live behind :mod:`.rpc`.

        pw, dw = build_proc_pools("mypkg.models:build", 2, 1)
        tier = ProcRouter(pw, dw)
        h = tier.submit(prompt, max_new_tokens=16)
        tier.run_until_idle()
        tier.close()
    """

    def __init__(self, prefill_workers: List[WorkerProc],
                 decode_workers: List[WorkerProc], *,
                 slo_classes: Optional[Dict[str, SLOClass]] = None,
                 record_store: Optional[str] = None,
                 run_id: Optional[str] = None,
                 policy=None,
                 heartbeat_every_s: float = 2.0,
                 respawn: bool = True,
                 respawn_backoff_s: float = 0.5,
                 respawn_backoff_cap_s: float = 30.0,
                 breaker_k: int = 3,
                 breaker_window_s: float = 60.0):
        self.prefill = list(prefill_workers)
        self.decode = list(decode_workers)
        if not self.prefill or not self.decode:
            raise ValueError("a tier needs at least one prefill and one "
                             "decode worker")
        names = [w.name for w in self.workers()]
        if len(set(names)) != len(names):
            raise ValueError(f"worker names must be unique, got {names}")
        self.fabric = self.prefill[0].fabric
        self.slo_classes = dict(slo_classes or {})
        self.record_store = record_store
        self.run_id = run_id or obs_record.new_run_id("mptier")
        self.policy = policy
        self.metrics = ProcTierMetrics(self)
        #: the supervisor's OWN flight ring (a dead worker process
        #: cannot be asked for its ring — the survivor's view is the
        #: incident evidence)
        self.flight = obs_flight.register(obs_flight.FlightRecorder())
        self.model_key = next(
            (w.model_key for w in self.workers() if w.model_key), None)
        self._seq = itertools.count()
        self._incident_seq = itertools.count()
        self._handles: Dict[int, ProcHandle] = {}
        self._where: Dict[int, WorkerProc] = {}
        self._ready_at: Dict[int, float] = {}
        self._tick_ewma: Optional[float] = None
        #: ready prefills that found no decode capacity last round —
        #: the decode-pool backpressure signal the elastic policy reads
        self.parked = 0
        self._staged: List[WorkerProc] = []
        self._staged_lock = threading.Lock()
        self._spawn_threads: List[threading.Thread] = []
        self._draining = False
        self._closed = False
        # -- self-healing knobs + state -----------------------------
        #: probe an alive worker whose last successful RPC is older
        #: than this (host half of the ``utils.failure.Heartbeat``
        #: contract: beat age > deadline → dead, crash or no crash)
        self.heartbeat_every_s = float(heartbeat_every_s)
        #: automatic respawn of dead workers toward the role target
        self.respawn = bool(respawn)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_cap_s = float(respawn_backoff_cap_s)
        #: crash-loop circuit breaker: ``breaker_k`` deaths of one role
        #: inside ``breaker_window_s`` → stop respawning that role
        self.breaker_k = int(breaker_k)
        self.breaker_window_s = float(breaker_window_s)
        #: per-role pool-size goal — seeded from the constructor
        #: pools, moved ONLY by :meth:`resize`; respawn restores
        #: toward it and adoption dismisses any surplus beyond it
        self._target = {"prefill": len(self.prefill),
                        "decode": len(self.decode)}
        #: in-flight background spawns per role (guarded by
        #: ``_staged_lock``, like ``_staged`` — together they make the
        #: "already on its way" count resize/respawn dedupe against)
        self._spawning = {"prefill": 0, "decode": 0}
        #: consecutive failed respawn attempts → exponential backoff
        self._respawn_fails = {"prefill": 0, "decode": 0}
        self._respawn_not_before = {"prefill": 0.0, "decode": 0.0}
        #: recent death timestamps per role (breaker window evidence)
        self._death_times: Dict[str, List[float]] = {"prefill": [],
                                                     "decode": []}
        self._breaker_open = {"prefill": False, "decode": False}

    # -- introspection -----------------------------------------------------
    def workers(self) -> List[WorkerProc]:
        return self.prefill + self.decode

    @property
    def pending(self) -> int:
        """Requests the tier still owes an outcome — counted from the
        supervisor mirror (the authoritative copy), not from worker
        loads (a dead worker's load is meaningless)."""
        return sum(1 for h in self._handles.values() if not h.done)

    def worker(self, name: str) -> WorkerProc:
        for w in self.workers():
            if w.name == name:
                return w
        raise KeyError(f"no worker named {name!r} "
                       f"(have: {[w.name for w in self.workers()]})")

    def tier_stats(self) -> dict:
        summ = self.metrics.handoff_summary() or {}
        return {
            "prefill_workers": len(self.prefill),
            "decode_workers": len(self.decode),
            "handoffs": self.metrics.handoffs,
            "handoff_p99_ms": round(summ.get("p99", 0.0), 3),
        }

    def transport_stats(self) -> dict:
        """The ``serve_load`` transport field trio (obs/schema.py
        ``_SERVE_TRANSPORT_FIELDS``)."""
        ser = self.metrics._ser.summary() or {}
        return {
            "handoff_wire_bytes": self.metrics.wire_bytes,
            "handoff_ser_ms_p99": round(ser.get("p99", 0.0), 3),
            "resizes": self.metrics.resizes,
        }

    # -- submission --------------------------------------------------------
    def submit(self, prompt_ids, *, max_new_tokens: int,
               tenant: Optional[str] = None,
               slo: Optional[str] = None,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_token=None) -> ProcHandle:
        if self._closed:
            raise EngineClosed("submit() on a closed tier")
        if self._draining:
            raise EngineClosed("tier is draining — new submissions are "
                               "refused while in-flight requests complete")
        faults.fire("serve.router", tenant=tenant or "", slo=slo or "")
        if slo is not None:
            cls = self.slo_classes.get(slo)
            if cls is None:
                raise ValueError(
                    f"unknown SLO class {slo!r} (registered: "
                    f"{sorted(self.slo_classes)})")
            if deadline_s is None:
                deadline_s = cls.deadline_s
        qid = next(self._seq)
        trace_id = f"{self.run_id}/q{qid}"
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        for w in self._route_order(self._prefill_pool()):
            try:
                rep, _ = w.call({"op": "submit", "trace": trace_id,
                                 "prompt": prompt.tolist(),
                                 "max_new_tokens": int(max_new_tokens),
                                 "deadline_s": deadline_s,
                                 "eos_id": eos_id})
            except WorkerDied as e:
                self._worker_death(w, str(e))
                continue
            if not rep.get("ok"):
                err = rep.get("err", "")
                if err.startswith("value_error"):
                    raise ValueError(err.partition(":")[2].strip()
                                     or err)
                continue   # queue_full / draining: try the next worker
            h = ProcHandle(qid, prompt, max_new_tokens, deadline_s,
                           eos_id, trace_id, on_token)
            with obs_trace.activate(trace_id):
                events.counter("serve.route", 1, worker=w.name,
                               role=w.role)
            self._handles[qid] = h
            self._where[qid] = w
            w.wrids[rep["rid"]] = qid
            w.load = rep.get("pending", w.load + 1)
            return h
        self.metrics.on_door_reject()
        raise QueueFull(
            "every prefill worker's queue is at capacity; request "
            "rejected — shed load, raise max_queue, or add workers")

    def _prefill_pool(self) -> List[WorkerProc]:
        alive = [w for w in self.prefill if w.alive]
        return alive or [w for w in self.decode if w.alive]

    @staticmethod
    def _route_order(pool: List[WorkerProc]) -> List[WorkerProc]:
        return sorted(pool, key=lambda w: (w.load, w.name))

    # -- the tier round ----------------------------------------------------
    def step(self) -> int:
        """One tier round, PIPELINED: tick frames go out to every
        worker in a pool before any reply is awaited, so the worker
        processes compute concurrently — this is where N processes buy
        wall-clock the in-process tier cannot."""
        if self._closed:
            raise EngineClosed("step() on a closed tier")
        t0 = time.monotonic()
        delivered = 0
        with events.span("serve.tier_step"):
            self._adopt_staged()
            self._prune()
            self._check_liveness()
            decode_alive = [w for w in self.decode if w.alive]
            ready_map: Dict[str, List[dict]] = {}
            delivered += self._tick_pool(
                [w for w in self.prefill if w.alive],
                decode=not decode_alive, ready_map=ready_map)
            self._drain_prefills(ready_map)
            delivered += self._tick_pool(
                [w for w in self.decode if w.alive], decode=True)
            if not any(w.alive for w in self.workers()) and self.pending:
                raise RuntimeError(
                    "every worker in the tier is dead; cannot serve "
                    "the remaining requests")
            if self.policy is not None:
                want = self.policy.decide(self)
                if want:
                    self.resize(**want)
            self._respawn_tick()
            dt = time.monotonic() - t0
            self._tick_ewma = dt if self._tick_ewma is None else \
                0.8 * self._tick_ewma + 0.2 * dt
            self.metrics.on_step()
        return delivered

    def _tick_pool(self, pool: List[WorkerProc], *, decode: bool,
                   ready_map: Optional[Dict[str, List[dict]]] = None
                   ) -> int:
        delivered = 0
        sent: List[WorkerProc] = []
        for w in pool:
            try:
                w.send({"op": "tick", "decode": decode,
                        "tick_hint_s": self._tick_ewma})
                sent.append(w)
            except WorkerDied as e:
                self._worker_death(w, str(e))
        for w in sent:
            if not w.alive:
                continue
            try:
                rep, _ = w.recv(timeout=w.op_timeout("tick"))
            except WorkerDied as e:
                self._worker_death(w, str(e))
                continue
            if not rep.get("ok"):
                self._worker_death(w, f"tick: {rep.get('err')}")
                continue
            if w.ok_ticks < _WARMUP_TICKS:
                w.warm_tick_s = max(w.warm_tick_s or 0.0,
                                    rep.get("tick_s", 0.0))
            w.ok_ticks += 1
            delivered += rep.get("delivered", 0)
            w.load = rep.get("pending", w.load)
            self._apply_delta(w, rep.get("delta", ()))
            if ready_map is not None and rep.get("ready"):
                ready_map[w.name] = rep["ready"]
        return delivered

    def _apply_delta(self, w: WorkerProc, delta) -> None:
        for e in delta:
            qid = w.wrids.get(e["rid"])
            h = self._handles.get(qid)
            if h is None:
                continue
            for t in e.get("toks", ()):
                h._append(t)
            if h._ttft_s is None and e.get("ttft_s") is not None:
                h._ttft_s = e["ttft_s"]
            if e.get("done"):
                h._finish(e.get("state", FINISHED),
                          e.get("finish_reason"), e.get("error"))
                w.wrids.pop(e["rid"], None)

    def run_until_idle(self, max_steps: Optional[int] = None) -> None:
        n = 0
        while self.pending:
            self.step()
            n += 1
            if max_steps is not None and n >= max_steps:
                break

    def drain(self, max_steps: Optional[int] = None) -> None:
        self._draining = True
        self.run_until_idle(max_steps=max_steps)

    def close(self) -> None:
        """Drain, shut every worker process down (RPC shutdown, then
        wait), join any in-flight grow spawns, release the fabric.
        Idempotent."""
        if self._closed:
            return
        self.respawn = False   # a closing tier never heals itself
        self.drain()
        self._closed = True
        for t in self._spawn_threads:
            t.join(timeout=self.fabric.spawn_timeout_s)
        self._adopt_staged(force=True)
        for w in self.workers():
            if not w.alive:
                continue
            try:
                w.call({"op": "shutdown"}, timeout=30.0)
            except WorkerDied:
                pass
            w.alive = False
            try:
                w.proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                w.proc.kill()
            try:
                w.sock.close()
            except OSError:
                pass
        self.fabric.close()

    def __enter__(self) -> "ProcRouter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- handoff over the wire ---------------------------------------------
    def _drain_prefills(self, ready_map: Dict[str, List[dict]]) -> None:
        now = time.monotonic()
        decode_alive = [w for w in self.decode if w.alive]
        parked = 0
        for w in [p for p in self.prefill if p.alive]:
            for ent in ready_map.get(w.name, ()):
                qid = w.wrids.get(ent["rid"])
                h = self._handles.get(qid)
                if h is None:
                    continue
                if qid not in self._ready_at:
                    self._ready_at[qid] = now
                if not decode_alive:
                    parked += 1
                    continue
                dst = None
                for d in self._route_order(decode_alive):
                    try:
                        rep, _ = d.call({
                            "op": "handoff", "dir": "probe",
                            "prompt": h._prompt.tolist(),
                            "n_blocks": ent["n_blocks"],
                            "prompt_keys": ent["prompt_keys"]})
                    except WorkerDied as e:
                        self._worker_death(d, str(e))
                        continue
                    if rep.get("ok") and rep.get("accept"):
                        dst = d
                        break
                if dst is None:
                    parked += 1
                    continue
                self._handoff(w, ent, dst, qid)
                if not w.alive:
                    break   # rest of this worker's entries re-routed
        self.parked = parked

    def _handoff(self, src: WorkerProc, ent: dict, dst: WorkerProc,
                 qid: int) -> None:
        h = self._handles[qid]
        ready = self._ready_at.get(qid)
        wait_ms = 0.0 if ready is None else \
            (time.monotonic() - ready) * 1e3
        with obs_trace.activate(h.trace_id):
            try:
                faults.fire("serve.handoff", rid=qid, src=src.name,
                            dst=dst.name)
            except InjectedFault as e:
                # pre-extract: the request still sits in its source
                # slot — withdraw it there, replay elsewhere
                self._withdraw_quiet(src, ent)
                self._replay(qid, f"handoff {src.name}->{dst.name}: "
                                  f"{type(e).__name__}: {e}")
                return
            with events.span("serve.handoff", src=src.name,
                             dst=dst.name, rid=qid):
                try:
                    rep, wire = src.call({"op": "handoff",
                                          "dir": "extract",
                                          "slot": ent["slot"],
                                          "rid": ent["rid"]})
                except InjectedFault as e:
                    # transport fault on the extract round trip: the
                    # reply (and the KV in it) is gone; whether the
                    # worker already released the slot is unknowable,
                    # so treat the KV as lost and replay
                    self._withdraw_quiet(src, ent)
                    self._replay(qid, f"transport(extract): {e}")
                    return
                except WorkerDied as e:
                    self._worker_death(src, str(e))
                    return   # death replay already covered qid
                if not rep.get("ok"):
                    self._withdraw_quiet(src, ent)
                    self._replay(qid, f"extract: {rep.get('err')}")
                    return
                src.wrids.pop(ent["rid"], None)
                src.load = max(0, src.load - 1)
                src.ok_handoffs += 1
                try:
                    rep2, _ = dst.call({"op": "handoff",
                                        "dir": "inject"}, wire)
                except InjectedFault as e:
                    self._replay(qid, f"transport(inject): {e}")
                    return
                except WorkerDied as e:
                    self._worker_death(dst, str(e))
                    self._replay(qid, f"inject: worker died: {e}")
                    return
                if not rep2.get("ok"):
                    if rep2.get("err") == "torn_frame":
                        self.metrics.on_torn_frame()
                    self._replay(qid, f"inject: {rep2.get('err')}")
                    return
                if not rep2.get("injected"):
                    # capacity vanished between probe and inject
                    self._replay(qid, "inject: capacity vanished",
                                 count_reroute=False)
                    return
        self._ready_at.pop(qid, None)
        self._where[qid] = dst
        dst.wrids[rep2["rid"]] = qid
        dst.load += 1
        dst.ok_handoffs += 1
        self.metrics.on_handoff(
            wait_ms, len(wire),
            float(rep.get("ser_ms", 0.0)) + float(rep2.get("deser_ms",
                                                           0.0)))

    def _withdraw_quiet(self, src: WorkerProc, ent: dict) -> None:
        """Best-effort release of a source slot after a failed handoff
        (the request replays elsewhere regardless)."""
        if not src.alive:
            return
        try:
            src.call({"op": "withdraw", "slot": ent["slot"],
                      "rid": ent["rid"]})
        except WorkerDied as e:
            self._worker_death(src, str(e))
            return
        src.wrids.pop(ent["rid"], None)
        src.load = max(0, src.load - 1)

    # -- replay (re-route) -------------------------------------------------
    def _replay(self, qid: int, reason: str, *,
                count_reroute: bool = True, incident: bool = True,
                warn: bool = True) -> None:
        """Re-admit the request behind ``qid`` from the supervisor
        mirror (prompt + tokens so far) on the least-loaded surviving
        prefill worker — greedy replay keeps its stream bitwise
        identical; ``resubmit`` bypasses queue backpressure because the
        request was already admitted once."""
        h = self._handles.get(qid)
        if h is None or h.done:
            return
        if count_reroute:
            self.metrics.on_reroute()
        if warn:
            warnings.warn(f"serve.net: re-routing request {qid} "
                          f"({reason}); it will re-prefill from "
                          f"prompt + tokens so far", stacklevel=2)
        self._ready_at.pop(qid, None)
        placed = False
        while not placed:
            pool = self._prefill_pool()
            if not pool:
                raise RuntimeError(
                    f"no alive worker to re-route request {qid} to")
            w = self._route_order(pool)[0]
            try:
                rep, _ = w.call({"op": "resubmit", "trace": h.trace_id,
                                 "prompt": h._prompt.tolist(),
                                 "tokens": list(h._tokens),
                                 "max_new_tokens": h._max_new,
                                 "deadline_s": h._deadline_rem(),
                                 "eos_id": h._eos,
                                 "ttft_s": h._ttft_s})
            except WorkerDied as e:
                self._worker_death(w, str(e))
                continue
            if not rep.get("ok"):
                raise RuntimeError(
                    f"replay of request {qid} refused by worker "
                    f"{w.name}: {rep.get('err')}")
            w.wrids[rep["rid"]] = qid
            w.load = rep.get("pending", w.load + 1)
            self._where[qid] = w
            placed = True
        if incident:
            self._incident(
                "serve.handoff", reason, f"req:{qid}", "rerouted", 0,
                flight_ref=self._flight_dump("serve.handoff", reason))

    # -- worker death ------------------------------------------------------
    def kill_worker(self, name: str, reason: str = "killed") -> None:
        """Operations/chaos hook: declare ``name`` dead now (its
        process is terminated) — flight dump, incident record, and
        every request placed on it replays on the survivors."""
        self._worker_death(self.worker(name), reason)

    def _worker_death(self, w: WorkerProc, reason: str) -> None:
        if not w.alive:
            return
        w.alive = False
        self.metrics.on_worker_death(w.name)
        try:
            # SIGKILL, not SIGTERM: a HUNG worker (the liveness layer's
            # whole reason to exist) may be wedged in a way that never
            # services SIGTERM — e.g. SIGSTOPped, or spinning with
            # signals blocked.  Kill is the only verdict that sticks,
            # and the wait() reaps the zombie so the no-orphan audit
            # sees a clean ledger.
            w.proc.kill()
        except OSError:
            pass
        try:
            w.proc.wait(timeout=10.0)
        except (subprocess.TimeoutExpired, OSError):
            pass
        try:
            w.sock.close()
        except OSError:
            pass
        warnings.warn(f"serve.net: worker {w.name} died ({reason}); "
                      f"re-routing its in-flight requests", stacklevel=2)
        self.flight.note("error", "serve.worker_dead", worker=w.name,
                         reason=reason)
        ref = self._flight_dump("serve.router",
                                f"worker {w.name} death: {reason}")
        victims = [qid for qid, ww in self._where.items()
                   if ww is w and not self._handles[qid].done]
        w.wrids.clear()
        # newest first: each resubmit prepends on the survivor, so the
        # oldest request ends up at the head — FIFO survives the death
        for qid in sorted(victims, reverse=True):
            self._replay(qid, f"worker {w.name} death",
                         count_reroute=True, incident=False, warn=False)
        self._incident("serve.router", "worker_death", w.name,
                       "rerouted", len(victims), flight_ref=ref)
        self._on_death_respawn(w.role)

    # -- self-healing: liveness, respawn, crash-loop breaker ---------------
    def _check_liveness(self) -> None:
        """Supervisor-side heartbeat (the host half of the
        ``utils.failure.Heartbeat`` contract): any alive worker whose
        last successful RPC is older than ``heartbeat_every_s`` gets a
        header-only ``heartbeat`` probe on a fast deadline.  A worker
        that cannot answer within seconds is declared dead even though
        its PROCESS may still exist — a hang and a crash converge on
        the same :class:`WorkerDied` funnel (``_worker_death``).  In a
        busy tier every tick refreshes ``last_ok``, so probes only
        ride when a worker has been quiet; a worker that hangs MID
        tick is caught by the tick deadline instead."""
        now = time.monotonic()
        for w in self.workers():
            if not w.alive or now - w.last_ok < self.heartbeat_every_s:
                continue
            try:
                rep, _ = w.call({"op": "heartbeat"})
            except WorkerDied as e:
                self._worker_death(w, f"heartbeat: {e}")
                continue
            if not rep.get("ok"):
                self._worker_death(w, f"heartbeat: {rep.get('err')}")

    def _on_death_respawn(self, role: str) -> None:
        """Death-path respawn bookkeeping: record the death for the
        breaker window, trip the crash-loop breaker at ``breaker_k``
        deaths in ``breaker_window_s`` (→ ``serve.crashloop`` incident,
        the role degrades to the surviving pools instead of
        spawn-spinning), else schedule a replacement immediately."""
        if not self.respawn or self._closed or self._draining:
            return
        now = time.monotonic()
        times = [t for t in self._death_times[role]
                 if now - t <= self.breaker_window_s]
        times.append(now)
        self._death_times[role] = times
        if self._breaker_open[role]:
            return
        if len(times) >= self.breaker_k:
            self._breaker_open[role] = True
            self.metrics.on_crashloop(role)
            warnings.warn(
                f"serve.net: {role} pool is crash-looping "
                f"({len(times)} deaths in {self.breaker_window_s:.0f}s)"
                f"; respawn breaker OPEN — the tier degrades to "
                f"survivors until an explicit resize()", stacklevel=2)
            self.flight.note("error", "serve.crashloop", role=role,
                             deaths=len(times),
                             window_s=self.breaker_window_s)
            self._incident(
                "serve.crashloop", "crash_loop", role, "degraded",
                len(times),
                flight_ref=self._flight_dump(
                    "serve.crashloop",
                    f"{role}: {len(times)} deaths in "
                    f"{self.breaker_window_s:.0f}s"))
            return
        self._respawn_tick()

    def _respawn_tick(self) -> None:
        """Schedule background replacement spawns for any role below
        its target.  Runs at every step boundary AND straight from the
        death path, so a failed attempt is retried (after its capped
        exponential backoff) without needing another death to notice
        the deficit.  The spawn itself happens on a ``net-respawner``
        thread — in-flight requests have ALREADY replayed on survivors
        by the time this runs, so nothing waits on the slow spawn —
        and the newcomer is adopted at a step boundary exactly like
        elastic grow."""
        if not self.respawn or self._closed or self._draining:
            return
        now = time.monotonic()
        for role, pool in (("prefill", self.prefill),
                           ("decode", self.decode)):
            if self._breaker_open[role]:
                continue
            alive = sum(1 for w in pool if w.alive)
            with self._staged_lock:
                if now < self._respawn_not_before[role]:
                    continue
                staged = sum(1 for w in self._staged if w.role == role)
                spawning = self._spawning[role]
            deficit = self._target[role] - (alive + staged + spawning)
            if deficit <= 0:
                continue
            try:
                # the ``serve.respawn`` seam: an error here is a failed
                # attempt (counts toward backoff), a hang delays the
                # respawn decision — the spawn itself is exercised by
                # killing the spawned worker, not by this site
                faults.fire("serve.respawn", role=role, n=deficit)
            except InjectedFault as e:
                self._respawn_failed(role, e)
                continue
            self._respawn(role, deficit)

    def _respawn(self, role: str, n: int) -> None:
        specs = [(self.fabric.next_name(role), role) for _ in range(n)]
        with self._staged_lock:
            self._spawning[role] += n

        def respawn() -> None:
            workers, err = [], None
            try:
                workers = self.fabric.spawn_many(specs)
            except (WorkerDied, RuntimeError, OSError) as e:
                err = e
            with self._staged_lock:
                self._spawning[role] -= n
                if err is None:
                    self._respawn_fails[role] = 0
                    self._respawn_not_before[role] = 0.0
                    for w in workers:
                        w.is_respawn = True
                    self._staged.extend(workers)
            if err is not None:
                self._respawn_failed(role, err)

        t = threading.Thread(target=respawn, name="net-respawner",
                             daemon=True)
        self._spawn_threads.append(t)
        t.start()

    def _respawn_failed(self, role: str, err: BaseException) -> None:
        with self._staged_lock:
            self._respawn_fails[role] += 1
            fails = self._respawn_fails[role]
            backoff = min(self.respawn_backoff_cap_s,
                          self.respawn_backoff_s * 2.0 ** (fails - 1))
            self._respawn_not_before[role] = time.monotonic() + backoff
        warnings.warn(
            f"serve.net: {role} respawn failed "
            f"({type(err).__name__}: {err}); attempt {fails}, next "
            f"retry backs off {backoff:.2f}s", stacklevel=2)

    def breaker_state(self) -> Dict[str, bool]:
        """Operations/test introspection: which roles the crash-loop
        breaker has given up on (cleared by an explicit resize)."""
        return dict(self._breaker_open)

    def heal_state(self) -> dict:
        """One consistent snapshot of the self-healing machinery —
        what a chaos harness polls to decide the tier has settled:
        per-role alive counts vs targets, staged-but-not-adopted and
        in-flight spawn counts, and the breaker state."""
        with self._staged_lock:
            staged = {r: sum(1 for w in self._staged if w.role == r)
                      for r in ("prefill", "decode")}
            spawning = dict(self._spawning)
        return {
            "alive": {"prefill": sum(1 for w in self.prefill
                                     if w.alive),
                      "decode": sum(1 for w in self.decode if w.alive)},
            "target": dict(self._target),
            "staged": staged,
            "spawning": spawning,
            "breaker": dict(self._breaker_open),
        }

    # -- elastic resize ----------------------------------------------------
    def resize(self, n_prefill: Optional[int] = None,
               n_decode: Optional[int] = None) -> bool:
        """Grow/shrink the pools toward the requested sizes.  Shrink is
        synchronous (drain → replay → shutdown); grow spawns in a
        background thread and the new workers are adopted at the next
        ``step()`` boundary.  Returns False when the ``serve.resize``
        fault aborts the resize (the tier is untouched — resizes are
        idempotent shape goals, the policy simply re-evaluates
        later)."""
        if self._closed:
            raise EngineClosed("resize() on a closed tier")
        try:
            faults.fire("serve.resize",
                        prefill=-1 if n_prefill is None else n_prefill,
                        decode=-1 if n_decode is None else n_decode)
        except InjectedFault as e:
            self.metrics.resizes_aborted += 1
            warnings.warn(f"serve.net: resize aborted by injected "
                          f"fault ({e})", stacklevel=2)
            return False
        changed = False
        for pool, role, want in ((self.prefill, "prefill", n_prefill),
                                 (self.decode, "decode", n_decode)):
            if want is None:
                continue
            want = max(1, int(want))   # never below one worker per pool
            self._target[role] = want
            # an explicit resize is an operator decision: the role gets
            # a clean slate — breaker closed, backoff forgotten
            self._breaker_open[role] = False
            self._death_times[role] = []
            alive = [w for w in pool if w.alive]
            with self._staged_lock:
                self._respawn_fails[role] = 0
                self._respawn_not_before[role] = 0.0
                staged = sum(1 for w in self._staged if w.role == role)
                spawning = self._spawning[role]
            # grow against everything already on its way (staged +
            # in-flight spawns), not just the alive count — a shrink
            # below that sum is settled at adoption time, where the
            # target guard dismisses the surplus newcomer cleanly
            # (the respawn-vs-shrink race cannot double-adopt)
            have = len(alive) + staged + spawning
            if want > have:
                self._grow(role, want - have)
                changed = True
            elif want < len(alive):
                # drain the youngest first (oldest workers keep the
                # warmest prefix caches)
                for w in sorted(alive, key=lambda w: w.name,
                                reverse=True)[:len(alive) - want]:
                    self._drain_worker(w, pool)
                changed = True
        if changed:
            self.metrics.on_resize(
                f"p{len(self.prefill)}d{len(self.decode)}")
        return changed

    def _grow(self, role: str, n: int) -> None:
        specs = [(self.fabric.next_name(role), role) for _ in range(n)]
        with self._staged_lock:
            self._spawning[role] += n

        def spawn() -> None:
            workers, err = [], None
            try:
                workers = self.fabric.spawn_many(specs)
            except (WorkerDied, RuntimeError, OSError) as e:
                err = e
            with self._staged_lock:
                self._spawning[role] -= n
                self._staged.extend(workers)
            if err is not None:
                warnings.warn(f"serve.net: grow spawn failed: {err}",
                              stacklevel=2)

        t = threading.Thread(target=spawn, name="net-spawner",
                             daemon=True)
        self._spawn_threads.append(t)
        t.start()

    def _adopt_staged(self, force: bool = False) -> None:
        with self._staged_lock:
            staged, self._staged = self._staged, []
        for w in staged:
            if self._closed and not force:
                continue
            pool = self.prefill if w.role == "prefill" else self.decode
            alive = sum(1 for x in pool if x.alive)
            if not force and alive >= self._target[w.role]:
                # the target moved while this spawn was in flight (an
                # elastic shrink racing a respawn/grow): the newcomer
                # is surplus — dismiss it cleanly instead of
                # double-adopting, and no process is orphaned
                self._dismiss(w, "surplus to target after resize")
                continue
            pool.append(w)
            events.counter("serve.worker_adopted", 1, worker=w.name,
                           role=w.role)
            self.flight.note("counter", "serve.worker_adopted",
                             worker=w.name, role=w.role)
            if getattr(w, "is_respawn", False):
                # the self-healing receipt: replacement adopted, pool
                # back toward target — incident + flight evidence
                self.metrics.on_respawn(w.name)
                self._incident(
                    "serve.respawn", "respawn", w.name, "respawned",
                    0, flight_ref=self._flight_dump(
                        "serve.respawn",
                        f"worker {w.name} adopted as replacement"))

    def _dismiss(self, w: WorkerProc, reason: str) -> None:
        """Shut down a spawned-but-never-adopted worker cleanly (it
        owns no requests — nothing to replay)."""
        self.flight.note("counter", "serve.worker_dismissed",
                         worker=w.name, reason=reason)
        try:
            w.call({"op": "shutdown"})
        except WorkerDied:
            pass
        w.alive = False
        try:
            w.proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            w.proc.kill()
        try:
            w.sock.close()
        except OSError:
            pass

    def _drain_worker(self, w: WorkerProc, pool: List[WorkerProc]
                      ) -> None:
        """Elastic scale-down of one worker: final health cached (its
        latency samples survive in tier metrics), in-flight requests
        handed back as host state and replayed bitwise on survivors,
        then a clean process exit — recorded as a ``serve.resize``
        incident with the supervisor ring as evidence."""
        pool.remove(w)
        self.metrics.retire(w)
        self.flight.note("counter", "serve.worker_drain", worker=w.name)
        try:
            rep, _ = w.call({"op": "drain"})
        except WorkerDied as e:
            self._worker_death(w, f"drain: {e}")
            return
        victims = []
        for r in rep.get("reqs", ()):
            qid = w.wrids.get(r["rid"])
            if qid is not None and not self._handles[qid].done:
                victims.append(qid)
        w.wrids.clear()
        for qid in sorted(victims, reverse=True):
            self._replay(qid, f"worker {w.name} drained",
                         count_reroute=False, incident=False,
                         warn=False)
        try:
            w.call({"op": "shutdown"}, timeout=30.0)
        except WorkerDied:
            pass
        w.alive = False
        try:
            w.proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            w.proc.kill()
        try:
            w.sock.close()
        except OSError:
            pass
        self._incident(
            "serve.resize", "drain", w.name, "drained", len(victims),
            flight_ref=self._flight_dump(
                "serve.resize", f"worker {w.name} drained"))

    # -- bookkeeping -------------------------------------------------------
    def _prune(self) -> None:
        for qid, h in list(self._handles.items()):
            if h.done:
                self._handles.pop(qid, None)
                self._where.pop(qid, None)
                self._ready_at.pop(qid, None)
        # dead workers leave the pool lists once their victims have
        # replayed (which happened at death): respawn means pools churn
        # for the tier's whole life, and tier_stats/resize must count
        # the real population, not a graveyard
        for pool in (self.prefill, self.decode):
            if any(not w.alive for w in pool):
                pool[:] = [w for w in pool if w.alive]

    def _flight_dump(self, site: str, reason: str) -> Optional[str]:
        return obs_flight.dump_for_store(self.flight, site,
                                         self.record_store, reason)

    def _incident(self, site: str, fault: str, ref, outcome: str,
                  retries: int, flight_ref: Optional[str] = None
                  ) -> None:
        events.counter("serve.incident", 1, site=site, outcome=outcome)
        if not self.record_store:
            return
        try:
            platform, kind = obs_record.device_kind(self.fabric.device)
            payload = {"site": site, "fault": fault, "ref": ref,
                       "outcome": outcome, "retries": int(retries),
                       "engine_run": self.run_id}
            if flight_ref:
                payload["flight_ref"] = flight_ref
            entry = obs_record.new_entry(
                "incident", platform, platform != "cuda", kind,
                run_id=f"{self.run_id}-inc{next(self._incident_seq)}",
                payload=payload)
            obs_record.RunRecord(self.record_store).append(entry)
        except Exception as e:
            warnings.warn(f"could not append incident record: "
                          f"{type(e).__name__}: {e}", stacklevel=2)
