"""The port's multi-process tier (singa_tpu_torch.serve.net) on the
CPU, against the JAX package's serve/net.

* **framing, deadlines, poisoning, elastic policy, self-healing** — the
  reference's own tests of those layers (tests/test_net.py), run on the
  port's modules over socketpairs and fake workers (no processes), and
  the op-deadline table held equal to the reference's;
* **codec** — one package encodes to byte-identical SGKV frames in both
  packages, in f32 and in bf16 (the reference's bf16 through
  `ml_dtypes`), each package decodes the other's frame, and a torn or
  bit-flipped frame raises TornFrame before any request is built;
* **live tier** — ONE module-scoped 1 prefill + 2 decode process tier on
  the CPU (workers built by `tests.test_torch_cuda:tier_model` from the
  reference's tiny weights), reused in order: streams identical to the
  reference engine's and the port's single engine, a torn frame
  rejected by its digest and replayed, an injected resize fault, a
  drain under load, and a killed worker replayed and respawned.  Every
  spawn and wait has its own timeout."""

import os
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu.serve.disagg import HandoffPackage as JPackage
from singa_tpu.serve.net import codec as jcodec
from singa_tpu.serve.net import supervisor as jsup
from singa_tpu.serve.scheduler import Request as JRequest
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.obs import trace as obs_trace
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.serve.disagg import HandoffPackage
from singa_tpu_torch.serve.net import codec as tcodec
from singa_tpu_torch.serve.net import rpc
from singa_tpu_torch.serve.net import supervisor as sup
from singa_tpu_torch.serve.net.elastic import (ElasticPolicy,
                                               target_decode_share)
from singa_tpu_torch.serve.scheduler import Request

from test_torch_cuda import tier_model

#: the builder every worker process imports by name (jax-free)
BUILDER = "tests.test_torch_cuda:tier_model"


# ---------------------------------------------------------------------------
# RPC framing (no processes)
# ---------------------------------------------------------------------------

class TestFraming:
    def test_round_trip_with_payload_and_trace(self):
        a, b = socket.socketpair()
        try:
            with obs_trace.activate("tr-net-1"):
                rpc.send_frame(a, {"op": "handoff"}, b"\x00\x01kv")
            hdr, payload = rpc.recv_frame(b)
            assert hdr["op"] == "handoff"
            assert hdr["trace"] == "tr-net-1"
            assert payload == b"\x00\x01kv"
        finally:
            a.close()
            b.close()

    def test_header_only_frame(self):
        a, b = socket.socketpair()
        try:
            rpc.send_frame(a, {"op": "tick", "decode": True})
            hdr, payload = rpc.recv_frame(b)
            assert hdr == {"op": "tick", "decode": True}
            assert payload == b""
        finally:
            a.close()
            b.close()

    def test_peer_hangup_mid_frame_is_loud(self):
        a, b = socket.socketpair()
        try:
            # a well-formed length prefix promising bytes that never come
            a.sendall(b"\x00\x00\x00\x08\x00\x00\x00\x00head")
            a.close()
            with pytest.raises(rpc.RPCError):
                rpc.recv_frame(b)
        finally:
            b.close()

    def test_oversized_length_prefix_is_refused(self):
        a, b = socket.socketpair()
        try:
            import struct
            a.sendall(struct.pack(">II", rpc.MAX_FRAME + 1, 0))
            with pytest.raises(rpc.RPCError):
                rpc.recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_torn_frame_plan_truncates_payload_bytes(self):
        """The send side passes payloads through faults.tear — a
        torn_frame spec halves the bytes while the frame itself stays
        parseable, exactly what the codec digest must catch."""
        a, b = socket.socketpair()
        try:
            plan = tfaults.FaultPlan.parse(
                "serve.transport=torn_frame:at=1")
            with tfaults.active(plan):
                rpc.send_frame(a, {"op": "handoff"}, b"x" * 64)
            hdr, payload = rpc.recv_frame(b)
            assert hdr["op"] == "handoff"
            assert payload == b"x" * 32
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# per-op deadlines + the poisoned-socket contract 
# ---------------------------------------------------------------------------

def _wp(sock=None, op_timeouts=None, compile_timeout_s=300.0):
    """A supervisor-side WorkerProc over a fabric stub — just the two
    fields :meth:`WorkerProc.op_timeout` and the RPC wrappers read."""
    fab = SimpleNamespace(
        op_timeouts={**sup._OP_TIMEOUTS, **(op_timeouts or {})},
        compile_timeout_s=compile_timeout_s)
    return sup.WorkerProc("d0", "decode", SimpleNamespace(), sock, fab)


class TestOpDeadlines:
    def test_table_resolves_per_op(self):
        w = _wp()
        assert w.op_timeout("heartbeat") == sup._OP_TIMEOUTS["heartbeat"]
        assert w.op_timeout("health") == sup._OP_TIMEOUTS["health"]
        assert w.op_timeout("shutdown") == sup._OP_TIMEOUTS["shutdown"]
        # a liveness probe must be ORDERS faster than a tick deadline —
        # that asymmetry is what makes hang detection snappy
        assert w.op_timeout("heartbeat") < sup._OP_TIMEOUTS["tick"]

    def test_unknown_op_keeps_the_blanket_deadline(self):
        assert _wp().op_timeout("no-such-op") == sup._DEFAULT_TIMEOUT_S

    def test_tick_escalates_until_warm(self):
        """Programs are made and captured at a worker's first
        dispatches, NOT at ready — early ticks get the compile budget,
        then the deadline drops to the steady-state table value."""
        w = _wp()
        assert w.op_timeout("tick") == 300.0
        w.ok_ticks = sup._WARMUP_TICKS - 1
        assert w.op_timeout("tick") == 300.0
        w.ok_ticks = sup._WARMUP_TICKS
        assert w.op_timeout("tick") == sup._OP_TIMEOUTS["tick"]

    def test_first_handoff_escalates(self):
        w = _wp()
        assert w.op_timeout("handoff") == 300.0
        w.ok_handoffs = 1
        assert w.op_timeout("handoff") == sup._OP_TIMEOUTS["handoff"]

    def test_per_tier_override_wins_in_steady_state(self):
        w = _wp(op_timeouts={"tick": 7.0}, compile_timeout_s=9.0)
        assert w.op_timeout("tick") == 9.0      # still compile-aware
        w.ok_ticks = sup._WARMUP_TICKS
        assert w.op_timeout("tick") == 7.0

    def test_heartbeat_never_escalates(self):
        """Warmth is irrelevant to a header-only probe: a FRESH worker
        that hangs must still be declared dead on the fast deadline."""
        w = _wp()
        assert w.ok_ticks == 0
        assert w.op_timeout("heartbeat") == sup._OP_TIMEOUTS["heartbeat"]


class TestPoisonedSocket:
    """The regression: a timed-out socket may sit mid-frame,
    so the first WorkerDied poisons the connection — every later use
    fails fast and the stale bytes are NEVER parsed as a fresh reply."""

    def test_timeout_poisons_and_late_reply_is_never_misread(self):
        a, b = socket.socketpair()
        try:
            w = _wp(sock=a, op_timeouts={"tick": 0.2},
                    compile_timeout_s=0.2)
            with pytest.raises(sup.WorkerDied):
                w.call({"op": "tick"})          # peer never replies
            assert w.poisoned
            # the reply lands LATE — exactly the stale frame a naive
            # retry would misread as its own answer
            rpc.send_frame(b, {"op": "tick", "ok": True})
            t0 = time.monotonic()
            with pytest.raises(sup.WorkerDied, match="poisoned"):
                w.call({"op": "tick"})
            assert time.monotonic() - t0 < 0.1  # fail-fast, no read
            # proof the poisoned path never touched the socket: the
            # stale frame is still sitting in the buffer, unconsumed
            hdr, _ = rpc.recv_frame(a, timeout=1.0)
            assert hdr == {"op": "tick", "ok": True}
        finally:
            a.close()
            b.close()

    def test_send_and_recv_refuse_a_poisoned_connection(self):
        a, b = socket.socketpair()
        try:
            w = _wp(sock=a)
            w.poisoned = True
            with pytest.raises(sup.WorkerDied, match="poisoned"):
                w.send({"op": "tick"})
            with pytest.raises(sup.WorkerDied, match="poisoned"):
                w.recv(timeout=0.1)
        finally:
            a.close()
            b.close()


# ---------------------------------------------------------------------------
# elastic policy over a fake router (no processes)
# ---------------------------------------------------------------------------

class _FakeWorker:
    def __init__(self, load=0):
        self.alive = True
        self.load = load


class _FakeRouter:
    def __init__(self, n_prefill, n_decode, *, pending=0, parked=0,
                 loads=0):
        self.prefill = [_FakeWorker(loads) for _ in range(n_prefill)]
        self.decode = [_FakeWorker() for _ in range(n_decode)]
        self.pending = pending
        self.parked = parked
        self.model_key = None


class TestElasticPolicy:
    def test_parked_prefills_grow_decode(self):
        pol = ElasticPolicy(check_every=1, patience=1, max_total=4,
                            decode_share=0.5)
        r = _FakeRouter(1, 1, pending=3, parked=2)
        assert pol.decide(r) == {"n_decode": 2}

    def test_at_budget_trades_prefill_for_decode_below_share(self):
        pol = ElasticPolicy(check_every=1, patience=1, max_total=4,
                            decode_share=0.6)
        r = _FakeRouter(3, 1, pending=3, parked=2)   # total at budget
        assert pol.decide(r) == {"n_prefill": 2, "n_decode": 2}

    def test_deep_prefill_queues_grow_prefill(self):
        pol = ElasticPolicy(check_every=1, patience=1, max_total=4,
                            decode_share=0.5)
        r = _FakeRouter(1, 1, pending=5, loads=4)    # queued > 2*n_p
        assert pol.decide(r) == {"n_prefill": 2}

    def test_idle_shrinks_toward_the_committed_share(self):
        pol = ElasticPolicy(check_every=1, patience=1, max_total=4,
                            decode_share=0.5)
        r = _FakeRouter(1, 2, pending=0)
        assert pol.decide(r) == {"n_decode": 1}
        r = _FakeRouter(2, 1, pending=0)
        assert pol.decide(r) == {"n_prefill": 1}

    def test_debounce_needs_patience_consecutive_checks(self):
        pol = ElasticPolicy(check_every=1, patience=2, max_total=4,
                            decode_share=0.5)
        r = _FakeRouter(1, 1, pending=3, parked=1)
        assert pol.decide(r) is None          # first sighting: wait
        assert pol.decide(r) == {"n_decode": 2}
        # the signal clearing resets the debounce
        assert pol.decide(_FakeRouter(1, 1, pending=3)) is None
        assert pol.decide(r) is None

    def test_min_per_pool_is_a_floor(self):
        pol = ElasticPolicy(check_every=1, patience=1, max_total=4,
                            decode_share=0.5)
        r = _FakeRouter(1, 1, pending=0)
        assert pol.decide(r) is None          # nothing above the floor

    def test_bad_budget_is_rejected(self):
        with pytest.raises(ValueError):
            ElasticPolicy(min_per_pool=0)
        with pytest.raises(ValueError):
            ElasticPolicy(min_per_pool=2, max_total=3)

    def test_target_share_defaults_sanely(self):
        assert 0.0 <= target_decode_share("no-such-model") <= 1.0


# ---------------------------------------------------------------------------
# self-healing over fake workers (no processes)
# ---------------------------------------------------------------------------

class _HealProc:
    def __init__(self):
        self.killed = False

    def kill(self):
        self.killed = True

    def wait(self, timeout=None):
        return 0

    def poll(self):
        return 0 if self.killed else None


class _HealWorker:
    """Duck-typed WorkerProc for router-level healing tests: alive,
    warmed, and answering every RPC — until told not to."""

    def __init__(self, name, role, *, heartbeat_ok=True):
        self.name, self.role = name, role
        self.alive = True
        self.load = 0
        self.pid = 1000
        self.model_key = "fake"
        self.poisoned = False
        self.last_ok = time.monotonic()
        self.ok_ticks = 99
        self.ok_handoffs = 9
        self.wrids = {}
        self.proc = _HealProc()
        self.sock = SimpleNamespace(close=lambda: None)
        self.heartbeat_ok = heartbeat_ok
        self.ops = []
        self.fabric = None                      # set by _mini_router

    def call(self, header, payload=b"", *, timeout=None):
        self.ops.append(header["op"])
        if header["op"] == "heartbeat" and not self.heartbeat_ok:
            raise sup.WorkerDied(
                f"worker {self.name}: probe timed out")
        self.last_ok = time.monotonic()
        return {"ok": True}, b""


def _mini_router(n_prefill=1, n_decode=2, *, spawn_many=None, **kw):
    """A real ProcRouter over fake workers and a fabric stub — the
    whole self-healing state machine (liveness, respawn, backoff,
    breaker, adoption) runs for real; only processes are fake."""
    seq = {"n": 100}

    def next_name(role):
        seq["n"] += 1
        return f"{role[0]}{seq['n']}"

    fab = SimpleNamespace(
        op_timeouts=dict(sup._OP_TIMEOUTS), compile_timeout_s=300.0,
        spawn_timeout_s=5.0, next_name=next_name,
        spawn_many=spawn_many or (lambda specs: []),
        close=lambda: None)
    pw = [_HealWorker(f"p{i}", "prefill") for i in range(n_prefill)]
    dw = [_HealWorker(f"d{i}", "decode") for i in range(n_decode)]
    for w in pw + dw:
        w.fabric = fab
    return sup.ProcRouter(pw, dw, **kw)


def _await_staged(router, role, n, deadline_s=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if router.heal_state()["staged"][role] >= n:
            return
        time.sleep(0.01)
    raise AssertionError(f"nothing staged: {router.heal_state()}")


class TestHeartbeatLiveness:
    def test_quiet_hung_worker_is_probed_and_funneled(self):
        """The host half of the Heartbeat contract: a worker whose
        last successful RPC is stale gets a probe, and a probe failure
        converges on the SAME WorkerDied funnel as a crash — its
        process is terminated even though the pid still existed."""
        r = _mini_router(respawn=False)
        d1 = r.decode[1]
        d1.heartbeat_ok = False
        d1.last_ok = time.monotonic() - 10.0
        with pytest.warns(UserWarning, match="died"):
            r._check_liveness()
        assert d1.alive is False
        assert d1.proc.killed                   # hang ≠ crash: SIGKILL
        assert r.metrics.worker_deaths == 1
        assert d1.ops == ["heartbeat"]

    def test_busy_workers_are_not_probed(self):
        r = _mini_router(respawn=False)
        r._check_liveness()                     # everyone fresh
        assert all(w.ops == [] for w in r.workers())

    def test_healthy_quiet_worker_survives_the_probe(self):
        r = _mini_router(respawn=False)
        d1 = r.decode[1]
        d1.last_ok = time.monotonic() - 10.0
        r._check_liveness()
        assert d1.alive and d1.ops == ["heartbeat"]
        assert r.metrics.worker_deaths == 0


class TestRespawn:
    def test_death_respawns_toward_target_and_adopts(self):
        created = []

        def spawn_many(specs):
            ws = [_HealWorker(name, role) for name, role in specs]
            created.extend(ws)
            return ws

        r = _mini_router(spawn_many=spawn_many)
        with pytest.warns(UserWarning, match="died"):
            r._worker_death(r.decode[1], "chaos kill")
        _await_staged(r, "decode", 1)
        for t in r._spawn_threads:
            t.join(timeout=5.0)
        r._prune()
        r._adopt_staged()
        assert [w.name for w in r.decode if w.alive] == \
            ["d0", created[0].name]
        assert r.metrics.respawns == 1
        assert r.heal_state()["alive"]["decode"] == 2

    def test_failed_respawn_backs_off_exponentially_capped(self):
        r = _mini_router(respawn_backoff_s=0.5,
                         respawn_backoff_cap_s=4.0)
        seen = []
        for _ in range(5):
            with pytest.warns(UserWarning, match="backs off"):
                r._respawn_failed("decode", RuntimeError("spawn lost"))
            seen.append(r._respawn_not_before["decode"]
                        - time.monotonic())
        # 0.5 -> 1 -> 2 -> 4 -> 4: doubling until the cap holds it
        for want, got in zip((0.5, 1.0, 2.0, 4.0, 4.0), seen):
            assert got == pytest.approx(want, abs=0.2)
        # a backed-off role is skipped by the respawn tick until due
        r._respawn_tick()
        assert r.heal_state()["spawning"]["decode"] == 0

    def test_breaker_opens_after_k_deaths_and_resize_resets(self):
        """K deaths of one role inside the window → the crash-loop
        breaker opens, respawn stops (the tier degrades to survivors),
        and only an EXPLICIT resize hands the role a clean slate."""
        scheduled = []
        r = _mini_router(n_decode=3, breaker_k=3, breaker_window_s=60.0)
        r._respawn = lambda role, n: scheduled.append((role, n))
        for i in range(3):
            with pytest.warns(UserWarning):
                r._worker_death(r.decode[i], f"chaos kill {i}")
        assert r.breaker_state()["decode"] is True
        assert r.metrics.crashloops == 1
        # only the pre-breaker deaths scheduled spawns
        assert scheduled == [("decode", 1), ("decode", 2)]
        r._respawn_tick()                       # breaker holds it shut
        assert scheduled == [("decode", 1), ("decode", 2)]
        grown = []
        r._grow = lambda role, n: grown.append((role, n))
        assert r.resize(n_decode=1) is True
        assert r.breaker_state()["decode"] is False
        assert r._death_times["decode"] == []
        assert grown == [("decode", 1)]

    def test_prune_removes_dead_workers_from_the_pool(self):
        r = _mini_router(respawn=False)
        with pytest.warns(UserWarning, match="died"):
            r._worker_death(r.decode[0], "chaos kill")
        assert len(r.decode) == 2
        r._prune()
        assert [w.name for w in r.decode] == ["d1"]


class TestRespawnShrinkRace:
    def test_shrink_during_inflight_respawn_dismisses_the_surplus(self):
        """Forced interleaving (the race): a respawn spawn is
        parked mid-flight on an Event, an elastic shrink moves the
        target underneath it, and the newcomer must be DISMISSED at
        adoption — no double-adopt past the target, no orphan."""
        started, release = threading.Event(), threading.Event()
        created = []

        def spawn_many(specs):
            started.set()
            assert release.wait(10.0), "race test wedged"
            ws = [_HealWorker(name, role) for name, role in specs]
            created.extend(ws)
            return ws

        r = _mini_router(spawn_many=spawn_many)
        with pytest.warns(UserWarning, match="died"):
            r._worker_death(r.decode[1], "chaos kill")
        assert started.wait(5.0), "death scheduled no respawn"
        # the spawn is in flight; now the shrink wins the race
        assert r.resize(n_decode=1) is False    # nothing to do NOW —
        assert r._target["decode"] == 1         # but the goal moved
        release.set()
        for t in r._spawn_threads:
            t.join(timeout=5.0)
        _await_staged(r, "decode", 1)
        r._prune()
        r._adopt_staged()
        assert [w.name for w in r.decode if w.alive] == ["d0"]
        assert r.metrics.respawns == 0          # never adopted
        (newcomer,) = created
        assert newcomer.alive is False          # dismissed cleanly,
        assert "shutdown" in newcomer.ops       # not orphaned

    def test_resize_grow_counts_inflight_spawns(self):
        """The dual guard: a grow that races an in-flight respawn must
        dedupe against spawning+staged, not spawn a second worker."""
        started, release = threading.Event(), threading.Event()

        def spawn_many(specs):
            started.set()
            assert release.wait(10.0)
            return [_HealWorker(name, role) for name, role in specs]

        r = _mini_router(spawn_many=spawn_many)
        with pytest.warns(UserWarning, match="died"):
            r._worker_death(r.decode[1], "chaos kill")
        assert started.wait(5.0)
        grown = []
        r._grow = lambda role, n: grown.append((role, n))
        assert r.resize(n_decode=2) is False    # 1 alive + 1 spawning
        assert grown == []                      # already on its way
        release.set()
        for t in r._spawn_threads:
            t.join(timeout=5.0)


# ---------------------------------------------------------------------------
# schema: the transport trio
# ---------------------------------------------------------------------------

def _base_serve_load():
    return {f: 1 for f in tschema._SERVE_LOAD_FIELDS}


class TestTransportTrioSchema:
    def test_absent_trio_is_valid(self):
        tschema.validate_serve_load_payload(_base_serve_load())

    def test_full_trio_is_valid(self):
        p = _base_serve_load()
        p.update(handoff_wire_bytes=801421, handoff_ser_ms_p99=322.5,
                 resizes=0)
        tschema.validate_serve_load_payload(p)

    def test_partial_trio_is_rejected(self):
        for f in tschema._SERVE_TRANSPORT_FIELDS:
            p = _base_serve_load()
            p[f] = 1
            with pytest.raises(tschema.SchemaError):
                tschema.validate_serve_load_payload(p)

    def test_non_numeric_trio_field_is_rejected(self):
        p = _base_serve_load()
        p.update(handoff_wire_bytes="many", handoff_ser_ms_p99=1.0,
                 resizes=0)
        with pytest.raises(tschema.SchemaError):
            tschema.validate_serve_load_payload(p)




def test_op_deadline_table_is_the_reference_s():
    """The deadlines, the compile budget and the warm-up tick count are
    the reference's (sized for XLA compiles; a card's captures are
    measured against them by chip_smoke.py's net phase)."""
    assert sup._OP_TIMEOUTS == jsup._OP_TIMEOUTS
    assert (sup._DEFAULT_TIMEOUT_S, sup._COMPILE_TIMEOUT_S,
            sup._WARMUP_TICKS) == (jsup._DEFAULT_TIMEOUT_S,
                                   jsup._COMPILE_TIMEOUT_S,
                                   jsup._WARMUP_TICKS)


# ---------------------------------------------------------------------------
# the wire codec against the reference's
# ---------------------------------------------------------------------------

def _arrays(dtype, seed=0, layers=2, n=16):
    """Per-layer (k, v) host arrays: f32, or bf16 as the top halves of
    f32 values (the same 2-byte patterns for both packages)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(2 * layers):
        x = rng.randn(1, n, 2, 4).astype(np.float32)
        if dtype == "bfloat16":
            x = (x.view(np.uint32) >> 16).astype(np.uint16).view(np.int16)
        out.append(x)
    return list(zip(out[0::2], out[1::2]))


def _packages(dtype, draft=False):
    """The same package in both packages' types: (reference, port)."""
    import ml_dtypes
    pairs = _arrays(dtype)
    dpairs = _arrays(dtype, seed=1, layers=1) if draft else None

    def jside(ps):
        if dtype == "bfloat16":
            return [(k.view(ml_dtypes.bfloat16), v.view(ml_dtypes.bfloat16))
                    for k, v in ps]
        return ps

    def tside(ps):
        conv = ((lambda a: torch.from_numpy(a).view(torch.bfloat16))
                if dtype == "bfloat16" else torch.from_numpy)
        return [(conv(k), conv(v)) for k, v in ps]

    prompt = np.arange(11, dtype=np.int32)
    out = []
    for req_cls, pkg_cls, conv in ((JRequest, JPackage, jside),
                                   (Request, HandoffPackage, tside)):
        req = req_cls(prompt, 9, None, 7, None)
        req.rid, req.tokens = 41, [3, 5]
        req.trace_id, req.ttft_s = "tier/q3", 0.125
        out.append(pkg_cls(req=req, kv=conv(pairs), pos=12, n_blocks=2,
                           prompt_keys=[b"\x01" * 16], src="p0",
                           draft_kv=conv(dpairs) if draft else None))
    return out


@pytest.mark.parametrize("draft", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_frames_are_byte_identical_to_the_reference(dtype, draft):
    jpkg, tpkg = _packages(dtype, draft)
    jframe, tframe = jcodec.encode_package(jpkg), tcodec.encode_package(tpkg)
    assert tframe == jframe
    # each package reads the other's frame back to the same tensors
    back = tcodec.decode_package(jframe)
    jback = jcodec.decode_package(tframe)
    want = tpkg.kv + (tpkg.draft_kv or [])
    got = back.kv + (back.draft_kv or [])
    assert len(got) == len(want)
    for (k, v), (wk, wv) in zip(got, want):
        assert k.dtype == wk.dtype and torch.equal(k, wk) and \
            torch.equal(v, wv)
    for (k, _), (wk, _) in zip(jback.kv, jpkg.kv):
        assert k.dtype == wk.dtype and np.array_equal(
            k.view(np.uint8), wk.view(np.uint8))
    assert (back.pos, back.n_blocks, back.prompt_keys, back.src) == \
        (12, 2, [b"\x01" * 16], "p0")
    assert (back.req.tokens, back.req.trace_id, back.req.ttft_s,
            back.req.eos_id, back.req.max_new_tokens) == \
        ([3, 5], "tier/q3", 0.125, 7, 9)
    assert back.req.prompt.tolist() == list(range(11))


def test_torn_frame_raises_before_any_request_is_built(monkeypatch):
    """A truncated or bit-flipped frame is refused by its digest before
    the codec constructs anything; a wrong magic or version is a
    WireError of its own."""
    _, pkg = _packages("bfloat16")
    frame = tcodec.encode_package(pkg)

    def no_request(*a, **k):
        raise AssertionError("a request was built from a torn frame")
    monkeypatch.setattr(tcodec, "Request", no_request)
    for bad in (frame[:len(frame) // 2], frame[:10],
                frame[:100] + bytes([frame[100] ^ 1]) + frame[101:]):
        with pytest.raises(tcodec.TornFrame):
            tcodec.decode_package(bad)
    with pytest.raises(tcodec.WireError, match="magic"):
        tcodec.decode_package(b"XXXX" + frame[4:])
    body = frame[:4] + bytes([2]) + frame[5:-16]
    with pytest.raises(tcodec.WireError, match="version"):
        tcodec.decode_package(body + tcodec._digest(body))


def test_codec_refuses_what_the_wire_does_not_carry():
    _, pkg = _packages("float32")
    pkg.kv = [(pkg.kv[0][0].to(torch.complex64), pkg.kv[0][1])]
    with pytest.raises(tcodec.WireError, match="dtype"):
        tcodec.encode_package(pkg)
    pkg.kv = [(torch.zeros(1),)]
    with pytest.raises(tcodec.WireError, match="pair"):
        tcodec.encode_package(pkg)


# ---------------------------------------------------------------------------
# the live 3-process tier on the CPU (module-scoped)
# ---------------------------------------------------------------------------

_MAX_NEW = 6


def _prompts(vocab=256):
    rng = np.random.RandomState(23)
    return [rng.randint(0, vocab, (int(n),)).astype(np.int32)
            for n in (5, 9, 12, 7)]


@pytest.fixture(scope="module")
def mp_tier(tmp_path_factory):
    """ONE spawn for every live test: a 1 prefill + 2 decode process
    tier on the CPU over the reference's tiny weights, the reference
    engine's and the port single engine's streams, and the record store
    the drain and respawn incidents land in.  Tests run in definition
    order; the destructive ones (drain, kill) come last."""
    tmp = tmp_path_factory.mktemp("net")
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    weights = str(tmp / "tiny.npz")
    np.savez(weights, **{n: np.asarray(t.data)
                         for n, t in jm.get_params().items()})
    prompts = _prompts()
    je = JEngine(jm, 4, 32, block_size=8)
    jh = [je.submit(p, max_new_tokens=_MAX_NEW) for p in prompts]
    je.run_until_idle()
    te = ServeEngine(tier_model(tdevice.create_device("cpu"),
                                weights=weights), 4, 32, block_size=8)
    th = [te.submit(p, max_new_tokens=_MAX_NEW) for p in prompts]
    te.run_until_idle()
    ref = [list(map(int, h.tokens)) for h in jh]
    assert [list(map(int, h.tokens)) for h in th] == ref

    store = str(tmp / "records.jsonl")
    pw, dw = sup.build_proc_pools(
        {"builder": BUILDER, "kwargs": {"weights": weights}}, 1, 2,
        num_slots=4, max_len=32, block_size=8, record_store=store,
        device="cpu", spawn_timeout_s=120.0)
    tier = sup.ProcRouter(pw, dw, record_store=store)
    try:
        yield SimpleNamespace(tier=tier, prompts=prompts, ref_toks=ref,
                              store=store)
    finally:
        tier.close()
    assert all(p.poll() is not None for p in tier.fabric.procs)


def _serve_all(tier, prompts):
    handles = [tier.submit(p, max_new_tokens=_MAX_NEW) for p in prompts]
    tier.run_until_idle(max_steps=500)
    return [h.tokens for h in handles]


def _settle_heal(tier, deadline_s=120.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        tier.step()
        hs = tier.heal_state()
        if (not any(hs["spawning"].values())
                and not any(hs["staged"].values())
                and all(hs["alive"][r] >= hs["target"][r]
                        or hs["breaker"][r]
                        for r in ("prefill", "decode"))):
            return hs
        time.sleep(0.05)
    raise AssertionError(f"tier did not heal: {tier.heal_state()}")


def _incidents(store, site):
    return [e for e in trecord.RunRecord(store).entries()
            if e["kind"] == "incident" and e["payload"].get("site") == site]


class TestLiveTier:
    def test_streams_equal_the_reference_and_the_single_engine(
            self, mp_tier):
        tier = mp_tier.tier
        assert _serve_all(tier, mp_tier.prompts) == mp_tier.ref_toks
        assert tier.metrics.handoffs >= 1
        assert tier.metrics.wire_bytes > 0
        assert tier.model_key == "llama-d64-L2"
        for w in tier.workers():
            assert w.ready_ms > 0 and w.warm_tick_s > 0
            rep, _ = w.call({"op": "health"})
            assert all(n <= 1 for n in rep["compiles"])
        assert tier.prefill[0].call({"op": "health"})[0][
            "handoff_compiles"] == 1

    def test_torn_frame_is_rejected_and_replayed_bitwise(self, mp_tier):
        """Tear the first inject payload (the supervisor's
        serve.transport fires at the extract's receive, then at the
        inject's send): the destination's codec refuses it by digest,
        and the request replays bitwise."""
        m = mp_tier.tier.metrics
        torn0, rer0 = m.torn_frames, m.reroutes
        plan = tfaults.FaultPlan.parse("serve.transport=torn_frame:at=2")
        with tfaults.active(plan), \
                pytest.warns(UserWarning, match="re-routing"):
            got = _serve_all(mp_tier.tier, mp_tier.prompts)
        assert got == mp_tier.ref_toks
        assert m.torn_frames == torn0 + 1
        assert m.reroutes >= rer0 + 1

    def test_injected_resize_fault_aborts_atomically(self, mp_tier):
        tier = mp_tier.tier
        n_p, n_d = len(tier.prefill), len(tier.decode)
        plan = tfaults.FaultPlan.parse("serve.resize=error:at=1")
        with tfaults.active(plan), \
                pytest.warns(UserWarning, match="resize aborted"):
            assert tier.resize(n_decode=n_d + 1) is False
        assert tier.metrics.resizes_aborted >= 1
        assert (len(tier.prefill), len(tier.decode)) == (n_p, n_d)
        assert tier.metrics.resizes == 0

    def test_scale_down_under_load_drains_bitwise_with_incident(
            self, mp_tier):
        tier = mp_tier.tier
        handles = [tier.submit(p, max_new_tokens=_MAX_NEW)
                   for p in mp_tier.prompts]
        for _ in range(3):
            tier.step()
        assert tier.resize(n_decode=1) is True
        tier.run_until_idle(max_steps=500)
        assert [h.tokens for h in handles] == mp_tier.ref_toks
        assert len(tier.decode) == 1
        assert tier.metrics.resizes == 1
        (inc, *_) = _incidents(mp_tier.store, "serve.resize")
        assert os.path.exists(os.path.join(
            os.path.dirname(mp_tier.store), inc["payload"]["flight_ref"]))

    def test_worker_death_mid_flight_replays_bitwise_and_respawns(
            self, mp_tier):
        """SIGKILL the only decode worker mid-stream: the in-flight
        streams replay bitwise on the survivor at once, then the
        replacement is adopted at a step boundary with a serve.respawn
        incident."""
        tier = mp_tier.tier
        deaths0, respawns0 = tier.metrics.worker_deaths, \
            tier.metrics.respawns
        handles = [tier.submit(p, max_new_tokens=_MAX_NEW)
                   for p in mp_tier.prompts]
        for _ in range(3):
            tier.step()
        tier.decode[0].proc.kill()
        with pytest.warns(UserWarning, match="died"):
            tier.run_until_idle(max_steps=500)
        assert [h.tokens for h in handles] == mp_tier.ref_toks
        assert tier.metrics.worker_deaths == deaths0 + 1
        hs = _settle_heal(tier)
        assert hs["alive"]["decode"] == hs["target"]["decode"] == 1
        assert tier.metrics.respawns == respawns0 + 1
        (inc, *_) = _incidents(mp_tier.store, "serve.respawn")
        assert inc["platform"] == "cpu"
        assert os.path.exists(os.path.join(
            os.path.dirname(mp_tier.store), inc["payload"]["flight_ref"]))
        # the replacement serves the same streams
        assert _serve_all(tier, mp_tier.prompts) == mp_tier.ref_toks
