"""Worker-process main for the multi-process serving tier, ported from
``singa_tpu/serve/net/procworker.py``.

One OS process = one :class:`~singa_tpu_torch.serve.engine.ServeEngine`
in a prefill or decode role, owned by a supervisor
(:mod:`~singa_tpu_torch.serve.net.supervisor`) over a framed
local-socket RPC (:mod:`~singa_tpu_torch.serve.net.rpc`).  The
process, a fresh interpreter (never a fork of one that touched CUDA):

1. takes its device from ``--device`` (``cuda``, the default, raises
   without a card; the CPU only when asked for),
2. connects to the supervisor and says ``hello`` (liveness before the
   expensive part),
3. builds its model from the configured ``module:callable`` builder on
   that device — deterministic construction (seeded init) is what
   replaces weight shipping: every process materializes the same
   weights — then builds its engine (its programs are made and, on a
   card, captured at their first dispatches),
4. reports ``ready`` (model key, program counts, wall time) over the
   control channel, and
5. serves the RPC loop: ``submit`` / ``resubmit`` / ``tick`` /
   ``handoff`` (probe, extract, inject) / ``drain`` / ``health`` /
   ``heartbeat`` (liveness probe) / ``chaos`` (install a worker-side
   fault plan) / ``shutdown``.

Per-process observability: the supervisor points each worker's event
sink at a per-worker file (``<base>.<worker>``), and every frame's
``trace`` id is re-activated around handling, so one request's events
land in whichever worker served it under ONE trace id.

Engine errors never kill the connection: a failed op replies
``{"ok": false, "err": ...}`` and the supervisor decides (re-route,
worker death, or plain rejection).  Only a broken socket ends the
process.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import importlib
import json
import os
import socket
import sys
import time
from typing import Any, Dict, List, Optional

import torch

__all__ = ["main"]


def _load_builder(spec: str):
    """Resolve ``"module:callable"`` to the model-builder function."""
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(
            f"model builder must be 'module:callable', got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def _deadline_rem(req, now: float) -> Optional[float]:
    return None if req.deadline is None else req.deadline - now


class _WorkerServer:
    """The RPC loop around one engine (single-threaded by design: the
    supervisor owns the connection and pipelines at the POOL level —
    concurrency across processes, sequential ops within one)."""

    def __init__(self, engine, name: str, role: str,
                 sock: socket.socket):
        self.engine = engine
        self.name = name
        self.role = role
        self.sock = sock
        #: worker-local rid -> [handle, tokens already reported] — the
        #: delta cursor per tracked request (the supervisor holds the
        #: authoritative mirror; this is just "what changed since the
        #: last tick reply")
        self.tracked: Dict[int, List[Any]] = {}
        self._draining = False

    # -- op handlers -------------------------------------------------------
    def _track(self, handle, already: int) -> None:
        self.tracked[handle.rid] = [handle, already]

    def _collect_delta(self) -> List[dict]:
        out = []
        for rid, slot in list(self.tracked.items()):
            h, last = slot
            toks = h.tokens
            if len(toks) > last or h.done:
                out.append({"rid": rid, "toks": toks[last:],
                            "done": h.done, "state": h.status,
                            "finish_reason": h.finish_reason,
                            "error": h.error, "ttft_s": h.ttft_s})
                slot[1] = len(toks)
                if h.done:
                    del self.tracked[rid]
        return out

    def _ready_prefills(self) -> List[dict]:
        """Parked finished prefills the supervisor can hand off: slot,
        block count, and the prefix chain keys a destination probe
        needs — no KV moves until the supervisor commits to an
        extract."""
        eng = self.engine
        out = []
        for slot, req in eng.running_items():
            if not req.tokens:
                continue
            keys = eng._req_keys(req)[
                :req.prompt.size // eng.pool.block_size]
            out.append({"rid": req.rid, "slot": slot,
                        "n_blocks": eng.pool.mapped_count(slot),
                        "prompt_keys": [k.hex() for k in keys]})
        return out

    def _op_submit(self, hdr: dict) -> dict:
        from ..scheduler import QueueFull
        if self._draining:
            return {"ok": False, "err": "draining"}
        try:
            h = self.engine.submit(
                hdr["prompt"], max_new_tokens=hdr["max_new_tokens"],
                deadline_s=hdr.get("deadline_s"),
                eos_id=hdr.get("eos_id"), trace_id=hdr.get("trace"))
        except QueueFull:
            return {"ok": False, "err": "queue_full"}
        except ValueError as e:
            return {"ok": False, "err": f"value_error: {e}"}
        self._track(h, 0)
        return {"ok": True, "rid": h.rid, "pending": self.engine.pending}

    def _op_resubmit(self, hdr: dict) -> dict:
        if self._draining:
            return {"ok": False, "err": "draining"}
        try:
            h = self.engine.resubmit(
                hdr["prompt"], hdr["tokens"],
                max_new_tokens=hdr["max_new_tokens"],
                deadline_s=hdr.get("deadline_s"),
                eos_id=hdr.get("eos_id"), trace_id=hdr.get("trace"),
                ttft_s=hdr.get("ttft_s"))
        except ValueError as e:
            return {"ok": False, "err": f"value_error: {e}"}
        self._track(h, len(hdr["tokens"]))
        return {"ok": True, "rid": h.rid, "pending": self.engine.pending}

    def _op_tick(self, hdr: dict) -> dict:
        if hdr.get("tick_hint_s") is not None:
            self.engine.tick_hint_s = float(hdr["tick_hint_s"])
        decode = bool(hdr.get("decode", True))
        t0 = time.perf_counter()
        try:
            delivered = self.engine.step(decode=decode)
        except (RuntimeError, OSError) as e:
            # past the engine's own retry/recovery budget — at the tier
            # level this is a worker death, reported, not raised
            return {"ok": False, "err": f"{type(e).__name__}: {e}"}
        rep = {"ok": True, "delivered": delivered,
               "tick_s": time.perf_counter() - t0,
               "pending": self.engine.pending,
               "delta": self._collect_delta()}
        if self.role == "prefill" and not decode:
            rep["ready"] = self._ready_prefills()
        return rep

    def _op_handoff(self, hdr: dict, payload: bytes):
        from . import codec
        direction = hdr.get("dir")
        if direction == "probe":
            pkg = codec.probe_package(hdr["prompt"], hdr["n_blocks"],
                                      hdr["prompt_keys"])
            return {"ok": True,
                    "accept": self.engine.can_accept_handoff(pkg)}, b""
        if direction == "extract":
            slot = int(hdr["slot"])
            req = self.engine._running.get(slot)
            if req is None or req.rid != hdr.get("rid"):
                return {"ok": False, "err": "slot_moved"}, b""
            t0 = time.perf_counter()
            try:
                pkg = self.engine.extract_handoff(slot)
                wire = codec.encode_package(pkg, src=self.name)
            except (RuntimeError, OSError, codec.WireError) as e:
                return {"ok": False,
                        "err": f"{type(e).__name__}: {e}"}, b""
            self.tracked.pop(req.rid, None)
            return {"ok": True, "rid": req.rid,
                    "ser_ms": (time.perf_counter() - t0) * 1e3}, wire
        if direction == "inject":
            t0 = time.perf_counter()
            try:
                pkg = codec.decode_package(payload)
            except codec.TornFrame:
                return {"ok": False, "err": "torn_frame"}, b""
            except codec.WireError as e:
                return {"ok": False, "err": f"wire_error: {e}"}, b""
            try:
                injected = self.engine.inject_handoff(pkg)
            except (RuntimeError, OSError) as e:
                return {"ok": False,
                        "err": f"{type(e).__name__}: {e}"}, b""
            if not injected:
                return {"ok": True, "injected": False}, b""
            self._track(pkg.req.handle, len(pkg.req.tokens))
            return {"ok": True, "injected": True, "rid": pkg.req.rid,
                    "deser_ms": (time.perf_counter() - t0) * 1e3}, b""
        return {"ok": False, "err": f"unknown handoff dir {direction!r}"}, \
            b""

    def _op_withdraw(self, hdr: dict) -> dict:
        """Pull one running request out of the engine (slot + blocks
        released, nothing re-queued here) — the supervisor's pre-extract
        failure recovery: the request replays on another worker, so this
        engine just forgets it."""
        slot = int(hdr["slot"])
        req = self.engine._running.get(slot)
        if req is None or (hdr.get("rid") is not None
                           and req.rid != hdr["rid"]):
            return {"ok": False, "err": "slot_moved"}
        self.engine.withdraw(slot)
        self.tracked.pop(req.rid, None)
        return {"ok": True, "rid": req.rid}

    def _op_drain(self, hdr: dict) -> dict:
        """Hand every in-flight request back to the supervisor as host
        state (prompt + tokens so far + budget + remaining deadline) —
        the worker's half of an elastic scale-down.  Running slots are
        withdrawn (blocks released), the queue is emptied, and new
        submissions are refused from here on."""
        self._draining = True
        eng = self.engine
        now = time.monotonic()
        reqs = [eng.withdraw(slot) for slot, _ in eng.running_items()]
        while True:
            r = eng.sched.pop_for_admission()
            if r is None:
                break
            reqs.append(r)
        out = []
        for r in reqs:
            self.tracked.pop(r.rid, None)
            out.append({"rid": r.rid, "prompt": r.prompt.tolist(),
                        "tokens": list(r.tokens),
                        "max_new_tokens": r.max_new_tokens,
                        "deadline_rem_s": _deadline_rem(r, now),
                        "eos_id": r.eos_id, "trace": r.trace_id,
                        "ttft_s": r.ttft_s})
        return {"ok": True, "reqs": out}

    def _op_heartbeat(self, hdr: dict) -> dict:
        """Liveness probe — header-only and engine-free by design: it
        proves the RPC loop itself is being serviced.  The supervisor's
        hang detector keys off THIS (and the per-op deadlines), never
        off process existence — a SIGSTOPped or wedged worker has a
        perfectly live pid and still fails this probe."""
        return {"ok": True, "pid": os.getpid()}

    def _op_chaos(self, hdr: dict) -> dict:
        """Install (or clear) a fault plan inside THIS worker process —
        the worker-side chaos seam.  ``plan`` is the
        ``SINGA_FAULTS`` syntax (``FaultPlan.parse``); a worker-side
        ``serve.transport`` hang, for instance, wedges the worker's
        payload frames without killing the process, which is exactly
        the hang-≠-crash case the liveness layer exists for.  Empty or
        missing ``plan`` uninstalls."""
        from ... import faults
        from ...faults.plan import FaultPlan
        spec = hdr.get("plan")
        try:
            if spec:
                faults.install(FaultPlan.parse(
                    spec, seed=int(hdr.get("seed", 0))))
            else:
                faults.uninstall()
        except ValueError as e:
            return {"ok": False, "err": f"value_error: {e}"}
        return {"ok": True, "plan": spec or None}

    def _op_health(self, hdr: dict) -> dict:
        m = self.engine.metrics
        rep = {"ok": True, "pending": self.engine.pending,
               "pid": os.getpid(), "role": self.role,
               "snapshot": m.snapshot(),
               "ttft_samples": list(m._ttft.samples),
               "token_samples": list(m._token.samples)}
        # the live program counts: the fixed-program-set invariant
        rep["compiles"] = self.engine.compiled_counts()
        rep["handoff_compiles"] = self.engine.handoff_compiled_count()
        return rep

    # -- the loop ----------------------------------------------------------
    def serve(self) -> int:
        from ...obs import trace as obs_trace
        from . import rpc
        while True:
            try:
                hdr, payload = rpc.recv_frame(self.sock)
            except (rpc.RPCError, OSError):
                # supervisor went away: nothing to serve for
                return 0
            op = hdr.get("op")
            tid = hdr.get("trace")
            ctx = (obs_trace.activate(tid) if tid
                   else contextlib.nullcontext())
            with ctx:
                if op == "shutdown":
                    rpc.send_frame(self.sock, {"op": "shutdown",
                                               "ok": True})
                    self.engine.close()
                    return 0
                handler = getattr(self, f"_op_{op}", None)
                if handler is None:
                    rep, pl = {"ok": False,
                               "err": f"unknown op {op!r}"}, b""
                elif op == "handoff":
                    rep, pl = self._op_handoff(hdr, payload)
                else:
                    rep, pl = handler(hdr), b""
                rep["op"] = op
                try:
                    rpc.send_frame(self.sock, rep, pl)
                except OSError:
                    return 0


def _engine_kwargs(cfg: dict, model) -> dict:
    """The engine's keyword arguments from the JSON config: a
    ``param_dtype`` travels as its torch name (``"bfloat16"``), and
    self-speculation's draft is the target itself."""
    kw = dict(cfg.get("engine", {}))
    if kw.get("param_dtype") is not None:
        kw["param_dtype"] = getattr(torch, kw["param_dtype"])
    if cfg.get("self_spec_k"):
        # self-speculation rides the same deterministic build: the
        # draft IS the target, so no second model crosses the config
        kw["draft_model"] = model
        kw["spec_k"] = int(cfg["self_spec_k"])
    return kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve-tier worker process (spawned by "
                    "singa_tpu_torch.serve.net.supervisor — not a user "
                    "CLI)")
    ap.add_argument("--sock", required=True,
                    help="AF_UNIX socket path of the supervisor")
    ap.add_argument("--name", required=True)
    ap.add_argument("--role", required=True,
                    choices=("prefill", "decode"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or "
                         "cpu")
    ap.add_argument("--config", required=True,
                    help="base64(JSON): model builder + engine kwargs")
    args = ap.parse_args(argv)
    cfg = json.loads(base64.b64decode(args.config).decode())

    from ...device import create_device
    dev = create_device(args.device)

    from ...obs import events
    if cfg.get("obs_path"):
        events.configure(path=cfg["obs_path"])

    # connect FIRST: the supervisor sees liveness before paying for the
    # model build, and a build crash surfaces as a closed connection
    # rather than a silent spawn timeout
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.sock)
    from . import rpc
    rpc.send_frame(sock, {"op": "hello", "name": args.name,
                          "role": args.role, "pid": os.getpid()})

    t0 = time.perf_counter()
    builder = _load_builder(cfg["model"]["builder"])
    model = builder(device=dev, **cfg["model"].get("kwargs", {}))
    from ...autotune.table import model_key
    from ..engine import ServeEngine
    engine = ServeEngine(model, **_engine_kwargs(cfg, model))
    rpc.send_frame(sock, {"op": "ready", "name": args.name, "ok": True,
                          "ready_ms": (time.perf_counter() - t0) * 1e3,
                          "pid": os.getpid(), "model_key": model_key(model),
                          "compiles": engine.compiled_counts()})

    server = _WorkerServer(engine, args.name, args.role, sock)
    try:
        return server.serve()
    finally:
        try:
            sock.close()
        except OSError:
            pass


if __name__ == "__main__":
    sys.exit(main())
