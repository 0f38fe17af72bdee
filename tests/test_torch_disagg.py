"""The port's disaggregated tier (singa_tpu_torch.serve.disagg and the
engine's tier hooks) against the JAX package's, on the CPU:
LlamaConfig.tiny() in f32 with the reference's weights carried over
through `load_reference_params`, at the reference tier tests' shape
(workers of num_slots=3, max_len=24, block_size=8; tests/test_faults.py
TestDisaggChaos and tests/test_spec.py's spec tier).

Every tier test runs the same traffic through the reference's Router and
the port's.  Greedy streams must be token-identical to the reference
tier's and to the port's own single engine (no tolerance: tiny f32
streams are identical), through a handoff fault, killed decode and
prefill workers, prefix keys crossing with the blocks and the
speculative tier with the draft's KV.  The engine hooks (`withdraw`,
`running_items`, `step(decode=False)`), the SharedPrograms refusals and
the int8 arena's requantization are held to the reference's; the
router's policy, the cross-pool shed eta and the tier-field schema are
the reference's own tests (tests/test_disagg.py) run on the port."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from singa_tpu import faults as jfaults
from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu.serve import disagg as jdisagg
from singa_tpu.obs import record as jrecord
from singa_tpu.ops import kv_cache as jkv
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.obs import events as tevents
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.ops import kv_cache as tkv
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.serve import disagg as tdisagg
from singa_tpu_torch.serve.metrics import ServeMetrics
from singa_tpu_torch.serve.scheduler import (QUEUED, Request, Scheduler,
                                             eta_first_token)

SLOTS, MAX_LEN, BS, NEW = 3, 24, 8, 6
FAST = dict(backoff_base=0.001, backoff_max=0.01)
LENS = (4, 6, 8)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, a JAX template
    engine, a port template engine, the port engine's single-engine
    streams for `_prompts(LENS)`).  Every test drains what it touches."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    je = JEngine(jm, SLOTS, MAX_LEN, block_size=BS, **FAST)
    te = ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS, **FAST)
    hs = [te.submit(p, max_new_tokens=NEW) for p in _prompts(LENS)]
    te.run_until_idle()
    return SimpleNamespace(jm=jm, tm=tm, je=je, te=te,
                           baseline=_tokens(hs))


def _prompts(lens, seed=7, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _tokens(hs):
    return [list(map(int, h.tokens)) for h in hs]


class _Side:
    """One package's side of a tier test: its model, template engine,
    disagg module, faults module and record store."""

    def __init__(self, name, model, template, disagg, faults, store):
        self.name, self.model, self.template = name, model, template
        self.disagg, self.faults, self.store = disagg, faults, store

    def tier(self, n, m, template=None, **kw):
        pw, dw = self.disagg.build_pools(
            self.model, n, m, template=template or self.template,
            num_slots=SLOTS, max_len=MAX_LEN, block_size=BS, **FAST,
            **kw.pop("engine", {}))
        return self.disagg.Router(pw, dw, **kw), pw, dw


def _sides(pair, tmp_path):
    """[reference side, port side], each with its own record store."""
    return [_Side("jax", pair.jm, pair.je, jdisagg, jfaults,
                  str(tmp_path / "jax" / "records.jsonl")),
            _Side("torch", pair.tm, pair.te, tdisagg, tfaults,
                  str(tmp_path / "torch" / "records.jsonl"))]


def _serve(tier, prompts, n=NEW):
    hs = [tier.submit(p, max_new_tokens=n) for p in prompts]
    tier.run_until_idle()
    return _tokens(hs)


# -- the tier against the reference tier and the single engine ----------------

def test_tier_streams_match_reference_tier_and_single_engine(pair, tmp_path):
    """A 2:1 tier: streams equal the reference tier's and the port's own
    single engine; every worker serves from the template's weight copy
    and its program counts stay within (1, 1), the handoff program made
    at most once; three handoffs, every first token from a prefill
    worker and the rest from the decode worker."""
    got = {}
    for side in _sides(pair, tmp_path):
        tier, pw, dw = side.tier(2, 1)
        got[side.name] = _serve(tier, _prompts(LENS))
        assert tier.pending == 0
        assert tier.metrics.handoffs == 3
        snap = tier.metrics.snapshot()
        assert snap["admitted"] == 3
        assert sum(len(t) for t in got[side.name]) == 3 * NEW
    assert got["torch"] == got["jax"] == pair.baseline
    for w in pw + dw:
        assert w.engine._params is pair.te._params
        assert all(n <= 1 for n in w.engine.compiled_counts())
        assert w.engine.handoff_compiled_count() <= 1
    assert all(w.engine.handoff_compiled_count() == 1 for w in pw)
    assert tier.tier_stats()["handoffs"] == 3


def test_handoff_fault_reroutes_and_streams_stay_identical(pair, tmp_path):
    """An injected `serve.handoff` fault at the second handoff: the
    router re-routes, the request re-prefills from its prompt, all
    streams equal the fault-free run's, and the reroute lands as an
    incident record whose flight_ref dump exists."""
    for side in _sides(pair, tmp_path):
        tier, pw, dw = side.tier(1, 1, record_store=side.store)
        plan = side.faults.FaultPlan(
            [side.faults.FaultSpec("serve.handoff", "error", at=2)])
        with side.faults.active(plan):
            with pytest.warns(UserWarning, match="re-routing"):
                got = _serve(tier, _prompts(LENS))
        assert got == pair.baseline, side.name
        assert plan.fire_count() == 1
        assert tier.metrics.reroutes == 1
        rec = (jrecord if side.name == "jax" else trecord).RunRecord(
            side.store)
        (inc,) = [e for e in rec.entries()
                  if e["payload"].get("outcome") == "rerouted"]
        assert inc["payload"]["site"] == "serve.handoff"
        assert os.path.exists(os.path.join(os.path.dirname(side.store),
                                           inc["payload"]["flight_ref"]))
    assert inc["platform"] == "cpu"


@pytest.mark.parametrize("role", ["decode", "prefill"])
def test_killed_worker_reroutes_bitwise(pair, tmp_path, role):
    """A decode worker killed mid-stream (its slots live), or the most
    loaded prefill worker killed before any tick: everything placed on
    it replays from prompt + tokens so far on the survivors, streams
    bitwise; the death lands as an incident naming the worker, whose
    flight dump carries the dead decode worker's handoffs."""
    for side in _sides(pair, tmp_path):
        n, m = (1, 2) if role == "decode" else (2, 1)
        tier, pw, dw = side.tier(n, m, record_store=side.store)
        hs = [tier.submit(p, max_new_tokens=NEW) for p in _prompts(LENS)]
        if role == "decode":
            for _ in range(3):
                tier.step()
            victim = next(w for w in dw if w.engine.running_items())
        else:
            victim = max(pw, key=lambda w: w.load)
            assert victim.load > 0
        with pytest.warns(UserWarning, match="died"):
            tier.kill_worker(victim.name)
        assert not victim.alive
        tier.run_until_idle()
        assert _tokens(hs) == pair.baseline, (side.name, role)
        assert tier.metrics.worker_deaths == 1
        rec = (jrecord if side.name == "jax" else trecord).RunRecord(
            side.store)
        (inc,) = [e for e in rec.entries()
                  if e["payload"].get("fault") == "worker_death"]
        assert inc["payload"]["site"] == "serve.router"
        assert inc["payload"]["ref"] == victim.name
        dump = os.path.join(os.path.dirname(side.store),
                            inc["payload"]["flight_ref"])
        assert os.path.exists(dump)
        if role == "decode":
            with open(dump) as f:
                assert "serve.handoff_in" in f.read()
        else:
            survivor = next(w for w in pw if w.alive)
            assert survivor.engine.metrics.admitted >= victim.load


def test_handoff_transfers_prefix_cache_keys(pair, tmp_path):
    """Two requests sharing one full prompt block hand off to the same
    decode worker; the second maps the shared block copy-free (the
    decode worker's prefix cache matched the chain key the first
    handoff registered), streams equal generate()'s."""
    shared = _prompts([8], seed=11)[0]
    prompts = [np.concatenate([shared, _prompts([k], seed=s)[0]])
               for k, s in ((3, 12), (5, 13))]
    want = [list(map(int, pair.tm.generate(p[None], max_new_tokens=3)
                     [0, p.size:])) for p in prompts]
    for side in _sides(pair, tmp_path):
        tier, pw, dw = side.tier(1, 1)
        assert _serve(tier, prompts, n=3) == want, side.name
        notes = [e for e in dw[0].engine.flight.snapshot()
                 if e.get("name") == "serve.handoff_in"]
        assert len(notes) == 2
        assert sum(e["shared"] for e in notes) >= 1


def test_spec_tier_hands_off_the_draft_kv(pair, tmp_path):
    """A speculative 1:1 tier (self-speculation, spec_k=2): prefill
    workers write both arenas, the package carries the draft's KV, the
    decode worker verifies.  Streams equal the plain single engine's
    and the accept rate is 1.0 in both packages — a handoff without
    the draft blocks would accept almost nothing."""
    kw = dict(draft_model=None, spec_k=2)
    prompts = _prompts(LENS, seed=29)
    want = [list(map(int, pair.tm.generate(p[None], max_new_tokens=9)
                     [0, p.size:])) for p in prompts]
    for side in _sides(pair, tmp_path):
        kw["draft_model"] = side.model
        eng = (JEngine if side.name == "jax" else ServeEngine)(
            side.model, 4, 48, block_size=BS, **kw, **FAST)
        pw, dw = side.disagg.build_pools(side.model, 1, 1, template=eng,
                                         num_slots=4, max_len=48,
                                         block_size=BS, **kw, **FAST)
        tier = side.disagg.Router(pw, dw)
        assert _serve(tier, prompts, n=9) == want, side.name
        assert tier.metrics.handoffs >= 1
        snap = tier.metrics.snapshot()
        assert snap["accept_rate"] == 1.0
        assert snap["tokens_per_dispatch"] > 1.0
    counts = pw[0].engine.spec_compiled_counts()
    assert (counts[0], counts[3]) == (1, 1)
    assert dw[0].engine.spec_compiled_counts()[2] == 1


def test_cross_worker_trace_is_one_timeline(pair, tmp_path):
    """The router's trace id rides through both workers: route →
    submitted → prefill → handoff (src, dst) → tokens → evicted."""
    path = str(tmp_path / "ev.jsonl")
    tier, pw, dw = _sides(pair, tmp_path)[1].tier(1, 1)
    tevents.configure(path=path)
    try:
        h = tier.submit(_prompts([4])[0], max_new_tokens=NEW)
        tier.run_until_idle()
    finally:
        tevents.configure()
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    mine = [e for e in evs if e.get("trace") == h.trace_id]
    names = {e["name"] for e in mine}
    assert h.trace_id.startswith(tier.run_id)
    for name in ("serve.submitted", "serve.route", "serve.prefill",
                 "serve.handoff", "serve.token", "serve.evicted"):
        assert name in names, (name, names)
    route = next(e for e in mine if e["name"] == "serve.route")
    handoff = next(e for e in mine if e["name"] == "serve.handoff")
    assert route["worker"] == pw[0].name
    assert (handoff["src"], handoff["dst"]) == (pw[0].name, dw[0].name)


def test_tenant_quota_and_slo_classes(pair, tmp_path):
    """Quotas reject at the tier door (QuotaExceeded is a QueueFull),
    SLO classes bind deadlines, unknown classes fail loudly; the quota
    frees on completion — in both packages alike."""
    for side in _sides(pair, tmp_path):
        d = side.disagg
        tier, _, _ = side.tier(
            1, 1, slo_classes={"interactive": d.SLOClass("interactive", 5.0),
                               "batch": d.SLOClass("batch", None)},
            tenant_quota=1)
        p = _prompts([4])[0]
        h1 = tier.submit(p, max_new_tokens=2, tenant="acme",
                         slo="interactive")
        assert h1._req.deadline is not None
        with pytest.raises(d.QuotaExceeded):
            tier.submit(p, max_new_tokens=2, tenant="acme")
        h2 = tier.submit(p, max_new_tokens=2, tenant="other", slo="batch")
        assert h2._req.deadline is None
        with pytest.raises(ValueError, match="unknown SLO class"):
            tier.submit(p, max_new_tokens=2, slo="gold")
        tier.run_until_idle()
        assert h1.done and h2.done
        tier.submit(p, max_new_tokens=2, tenant="acme")
        tier.run_until_idle()
        assert tier.metrics.quota_rejected == 1
        assert tier.metrics.snapshot()["rejected"] == 1


# -- the engine hooks ---------------------------------------------------------

def test_withdraw_running_items_and_step_without_decode(pair):
    """step(decode=False) stops after admission with the first tokens
    delivered; running_items() lists the parked (slot, request) pairs
    in slot order; withdraw() releases the slot and its blocks and
    re-queues nothing — as the reference's engine does."""
    prompts = _prompts((5, 11))
    out = {}
    for name, eng in (("jax", pair.je), ("torch", pair.te)):
        free0 = eng.pool.available_blocks
        hs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
        assert eng.step(decode=False) == 2
        items = eng.running_items()
        first = _tokens(hs)
        slots = [s for s, _ in items]
        assert sorted(r.rid for _, r in items) == [h.rid for h in hs]
        assert slots == sorted(slots)
        assert eng.step(decode=False) == 0      # nothing more to admit
        req = eng.withdraw(items[0][0])
        assert req.state == QUEUED and req.slot is None
        assert req.tokens == first[[h.rid for h in hs].index(req.rid)]
        assert [r for _, r in eng.running_items()] == [items[1][1]]
        eng.withdraw(items[1][0])
        assert eng.pending == 0
        assert eng.pool.available_blocks == free0
        out[name] = first
    assert out["torch"] == out["jax"] == [t[:1] for t in
                                           _tokens_of(pair.te, prompts)]


def _tokens_of(eng, prompts):
    hs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    eng.run_until_idle()
    return _tokens(hs)


_REFUSALS = {
    "model": ("SAME model object", dict(model="other")),
    "block_size": ("matching block_size", dict(block_size=4)),
    "spec_k": ("SAME draft model", dict(draft="self", spec_k=2)),
    "kv_dtype": ("matching arena storage", dict(kv_dtype="int8")),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_shared_programs_refusals_match_the_reference(pair, case):
    """programs= from another model, block size, draft/spec_k or arena
    format is refused with the reference's message."""
    match, kw = _REFUSALS[case]
    for name, model, tmpl, cls in (("jax", pair.jm, pair.je, JEngine),
                                   ("torch", pair.tm, pair.te,
                                    ServeEngine)):
        m = model
        if kw.get("model") == "other":
            m = (jmodels.Llama(jmodels.LlamaConfig.tiny()) if name == "jax"
                 else Llama(LlamaConfig.tiny(),
                            device=tdevice.create_device("cpu")))
            if name == "jax":
                m.eval()
                m.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
                          is_train=False, use_graph=False)
        extra = {}
        if kw.get("draft") == "self":
            extra = dict(draft_model=m, spec_k=kw["spec_k"])
        if "kv_dtype" in kw:
            extra["kv_dtype"] = kw["kv_dtype"]
        with pytest.raises(ValueError, match=match):
            cls(m, SLOTS, MAX_LEN, block_size=kw.get("block_size", BS),
                programs=tmpl.programs(), **extra)


def test_shared_programs_refuse_another_weight_dtype(pair):
    """The port shares ONE weight copy, cast once for the template: an
    engine asking for another param_dtype is refused (the reference
    would cast its own copy and compile a second program entry)."""
    with pytest.raises(ValueError, match="matching param_dtype"):
        ServeEngine(pair.tm, SLOTS, MAX_LEN, block_size=BS,
                    param_dtype=torch.bfloat16, programs=pair.te.programs())
    shared = ServeEngine(pair.tm, 2, 16, block_size=BS,
                         programs=pair.te.programs())
    assert shared._params is pair.te._params
    assert shared.programs().resume is pair.te._resume
    assert shared.handoff_compiled_count() == 0


def test_int8_requantization_matches_the_reference():
    """A handoff out of an int8 arena dequantizes (gather_block_kv) and
    the destination quantizes again (scatter_block_kv): the port's
    quantize_kv(dequantize_kv(q, s)) returns the reference's codes and
    scales exactly."""
    rng = np.random.RandomState(3)
    x = (rng.randn(6, 8, 2, 16) * rng.uniform(0.01, 30, (6, 8, 1, 1))
         ).astype(np.float32)
    jq, js = jkv.quantize_kv(x)
    jq2, js2 = jkv.quantize_kv(jkv.dequantize_kv(jq, js))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x))
    tq2, ts2 = tkv.quantize_kv(tkv.dequantize_kv(tq, ts))
    np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    np.testing.assert_array_equal(tq2.numpy(), tq.numpy())


def test_int8_tier_streams_equal_the_int8_engine(pair):
    """An int8 tier (requantized handoffs) serves the streams of one
    int8 engine."""
    eng = ServeEngine(pair.tm, SLOTS, MAX_LEN, block_size=BS,
                      kv_dtype="int8", **FAST)
    want = _tokens_of(eng, _prompts(LENS))
    pw, dw = tdisagg.build_pools(pair.tm, 1, 1, template=eng,
                                 num_slots=SLOTS, max_len=MAX_LEN,
                                 block_size=BS, kv_dtype="int8", **FAST)
    tier = tdisagg.Router(pw, dw)
    assert _serve(tier, _prompts(LENS)) == want
    assert tier.metrics.handoffs == 3


# -- router policy over inert workers (tests/test_disagg.py) ------------------

def _stub_worker(name, role):
    eng = SimpleNamespace(pending=0, tick_hint_s=None,
                          sched=Scheduler(max_queue=8),
                          metrics=ServeMetrics(), flight=None)
    return tdisagg.Worker(name, role, eng)


class TestRouterPolicy:
    def test_tier_shape_is_validated(self):
        pw = [_stub_worker("p0", "prefill")]
        dw = [_stub_worker("d0", "decode")]
        with pytest.raises(ValueError, match="at least one"):
            tdisagg.Router(pw, [])
        with pytest.raises(ValueError, match="at least one"):
            tdisagg.Router([], dw)
        with pytest.raises(ValueError, match="unique"):
            tdisagg.Router(pw, [_stub_worker("p0", "decode")])
        with pytest.raises(ValueError, match="SLOClass"):
            tdisagg.Router(pw, dw, slo_classes={"x": 5.0})

    def test_worker_role_and_slo_validation(self):
        with pytest.raises(ValueError, match="unknown worker role"):
            tdisagg.Worker("w", "prefetch", engine=None)
        with pytest.raises(ValueError, match="deadline_s"):
            tdisagg.SLOClass("interactive", -1.0)
        assert tdisagg.SLOClass("batch", None).deadline_s is None

    def test_route_order_is_least_loaded_deterministic(self):
        a, b, c = (_stub_worker(n, "prefill") for n in ("a", "b", "c"))
        a.engine.pending = 2
        order = tdisagg.Router._route_order([a, b, c])
        assert [w.name for w in order] == ["b", "c", "a"]

    def test_worker_death_preserves_fifo_order(self):
        dead = _stub_worker("p0", "prefill")
        surv = _stub_worker("p1", "prefill")
        router = tdisagg.Router([dead, surv],
                                [_stub_worker("d0", "decode")])
        reqs = [Request(np.ones(4, np.int32), 4, deadline_s=None,
                        eos_id=None, on_token=None) for _ in range(3)]
        for r in reqs:
            router._handles[r.rid] = (r.handle, None)
            router._where[r.rid] = dead
        with pytest.warns(UserWarning, match="died"):
            router.kill_worker("p0")
        assert not dead.alive
        assert [r.rid for r in surv.engine.sched.queue] == \
            [r.rid for r in reqs]

    def test_router_fault_fires_at_the_door(self):
        tier = tdisagg.Router([_stub_worker("p0", "prefill")],
                              [_stub_worker("d0", "decode")])
        plan = tfaults.FaultPlan([tfaults.FaultSpec("serve.router",
                                                    "error", at=1)])
        with tfaults.active(plan):
            with pytest.raises(tfaults.InjectedFault):
                tier.submit(np.ones(4, np.int32), max_new_tokens=2)
        assert plan.fire_count() == 1


class TestCrossPoolEta:
    def test_eta_model_waves(self):
        assert eta_first_token(0, free_slots=2, wave_size=4,
                               tick_s=1.0) == 0.0
        assert eta_first_token(1, free_slots=2, wave_size=4,
                               tick_s=1.0) == 0.0
        assert eta_first_token(2, free_slots=2, wave_size=4,
                               tick_s=1.0) == 1.0
        assert eta_first_token(5, free_slots=2, wave_size=4,
                               tick_s=1.0) == 1.0
        assert eta_first_token(6, free_slots=2, wave_size=4,
                               tick_s=1.0) == 2.0
        assert eta_first_token(3, free_slots=0, wave_size=0,
                               tick_s=0.5) == 0.5 * 4

    def test_router_cadence_hint_slows_the_eta(self):
        """The router's round time, pushed as `tick_hint_s`, is the
        admission period the shed eta runs against when it is the
        slower clock — the port's eta equals the reference's."""
        def eta(own, hint, position, free=0, slots=2):
            eng = SimpleNamespace(_tick_ewma=own, tick_hint_s=hint,
                                  _tpt_ewma=None,
                                  pool=SimpleNamespace(free_count=free,
                                                       num_slots=slots))
            return (ServeEngine._eta_first_token(eng, position),
                    JEngine._eta_first_token(eng, position))
        for args in ((0.01, None, 3), (0.01, 0.5, 3), (None, 0.5, 3),
                     (None, None, 3), (0.7, 0.5, 5)):
            t, j = eta(*args)
            assert t == pytest.approx(j)
        assert eta(0.01, None, 3)[0] == pytest.approx(0.01 * 2)
        assert eta(0.01, 0.5, 3)[0] == pytest.approx(0.5 * 2)
        assert eta(None, None, 3)[0] == 0.0

    def test_shed_overload_uses_the_pool_cadence(self):
        sched = Scheduler(max_queue=8)
        reqs = [Request(np.ones(4, np.int32), 4, deadline_s=0.3,
                        eos_id=None, on_token=None) for _ in range(4)]
        for r in reqs:
            sched.offer(r)
        now = reqs[0].submitted_at

        def eta(hint):
            eng = SimpleNamespace(_tick_ewma=0.01, tick_hint_s=hint,
                                  _tpt_ewma=None,
                                  pool=SimpleNamespace(free_count=1,
                                                       num_slots=1))
            return lambda pos: ServeEngine._eta_first_token(eng, pos)
        assert sched.shed_overload(now, eta(None)) == []
        shed = sched.shed_overload(now, eta(0.2))
        assert [r.rid for r in shed] == [reqs[2].rid, reqs[3].rid]
        assert all(r.finish_reason == "shed" for r in shed)
        assert sched.depth == 2


class TestTierFieldSchema:
    BASE = {"requests": 10, "completed": 9, "shed": 1, "rejected": 0,
            "tokens_per_s": 100.0, "ttft_p50_ms": 5.0,
            "ttft_p99_ms": 20.0}
    TIER = {"prefill_workers": 3, "decode_workers": 1, "handoffs": 9,
            "handoff_p99_ms": 12.5}

    def test_single_engine_payload_needs_no_tier_fields(self):
        tschema.validate_serve_load_payload(dict(self.BASE))

    def test_full_tier_quartet_is_valid(self):
        tschema.validate_serve_load_payload({**self.BASE, **self.TIER})

    def test_partial_tier_fields_are_rejected(self):
        for missing in self.TIER:
            bad = {**self.BASE, **self.TIER}
            del bad[missing]
            with pytest.raises(tschema.SchemaError, match=missing):
                tschema.validate_serve_load_payload(bad)

    def test_non_numeric_tier_field_is_rejected(self):
        bad = {**self.BASE, **self.TIER, "handoffs": "many"}
        with pytest.raises(tschema.SchemaError, match="handoffs"):
            tschema.validate_serve_load_payload(bad)

    def test_bool_is_not_a_measurement(self):
        bad = {**self.BASE, **self.TIER, "decode_workers": True}
        with pytest.raises(tschema.SchemaError, match="decode_workers"):
            tschema.validate_serve_load_payload(bad)

    def test_tier_stats_validate(self, pair, tmp_path):
        """A live tier's tier_stats() is a valid quartet."""
        tier, _, _ = _sides(pair, tmp_path)[1].tier(1, 1)
        _serve(tier, _prompts([4]))
        tschema.validate_serve_load_payload({**self.BASE,
                                             **tier.tier_stats()})
