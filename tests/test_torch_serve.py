"""The port's paged ServeEngine (singa_tpu_torch.serve) against the JAX
package's, on the CPU: LlamaConfig.tiny() in f32 with the reference's
weights carried over through `load_reference_params`, at the reference
tests' shape (num_slots=4, max_len=32, block_size=8).

Greedy streams must be token-identical to the JAX engine's and to the
port's own generate(), through chunked prefill, prefix sharing,
preemption and injected faults (retry, quarantine, recovery); the three
paged kv ops must equal the reference's exactly; the serve.* events in
the obs sink must match the reference engine's for the same traffic,
wall-clock fields excluded."""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import faults as jfaults
from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.obs import events as jevents
from singa_tpu.ops import kv_cache as jkv
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.obs import attr as tattr
from singa_tpu_torch.obs import events as tevents
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.ops import kv_cache as tkv
from singa_tpu_torch.serve import EngineClosed, QueueFull, ServeEngine

SLOTS, MAX_LEN, BS = 4, 32, 8
FAST = dict(backoff_base=0.001, backoff_max=0.01)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, a JAX engine and a
    port engine at the shared shape).  Every test drains both engines
    back to idle."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return (jm, tm, JEngine(jm, SLOTS, MAX_LEN, block_size=BS, **FAST),
            ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS, **FAST))


def _prompts(lens, seed=7, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lens]


def _shared(n_suffixes=2, prefix_len=19, seed=3):
    """Prompts sharing a 19-token system prompt (2 full blocks)."""
    rng = np.random.RandomState(seed)
    sysp = rng.randint(0, 256, (prefix_len,)).astype(np.int32)
    return [np.concatenate([sysp, rng.randint(0, 256, (4 + 3 * i,))
                            .astype(np.int32)]) for i in range(n_suffixes)]


def _serve(eng, prompts, n, **kw):
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    eng.run_until_idle()
    return hs


def _both(pair, prompts, n, jeng=None, teng=None):
    """The same traffic through both engines: (JAX handles, port
    handles)."""
    _, _, je, te = pair
    return _serve(jeng or je, prompts, n), _serve(teng or te, prompts, n)


def _tokens(hs):
    return [list(map(int, h.tokens)) for h in hs]


def _generate(tm, prompts, n):
    return [list(map(int, tm.generate(p[None], max_new_tokens=n)[0, p.size:]))
            for p in prompts]


# -- the paged kv ops ---------------------------------------------------------

def _arena(seed, nb=6, k=2, d=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(nb, BS, k, d).astype(np.float32),
            rng.randn(nb, BS, k, d).astype(np.float32))


def _kv_case(op, seed=0):
    """(reference (k, v), port (k, v)) for one op on seeded arrays."""
    ck, cv = _arena(seed)
    rng = np.random.RandomState(seed + 1)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    if op == "gather":
        table = rng.randint(0, ck.shape[0], (3, 4)).astype(np.int32)
        return (jkv.gather_block_kv(jnp.asarray(ck), jnp.asarray(cv),
                                    jnp.asarray(table)),
                tkv.gather_block_kv(tk, tv, torch.from_numpy(table)))
    if op == "scatter_block":
        kb, vb = rng.randn(2, BS, 2, 4).astype(np.float32)
        return (jkv.scatter_block_kv(jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(3, jnp.int32),
                                     jnp.asarray(kb), jnp.asarray(vb)),
                tkv.scatter_block_kv(tk, tv, torch.tensor(3),
                                     torch.from_numpy(kb),
                                     torch.from_numpy(vb)))
    block = np.array([2, 5, 1], np.int32)
    off = np.array([0, 7, 3], np.int32)
    kt, vt = rng.randn(2, 3, 2, 4).astype(np.float32)
    return (jkv.scatter_token_kv(jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.asarray(block), jnp.asarray(off),
                                 jnp.asarray(kt), jnp.asarray(vt)),
            tkv.scatter_token_kv(tk, tv, torch.from_numpy(block),
                                 torch.from_numpy(off), torch.from_numpy(kt),
                                 torch.from_numpy(vt)))


@pytest.mark.parametrize("op", ["gather", "scatter_block", "scatter_token"])
def test_paged_kv_ops_equal_the_reference(op):
    ref, out = _kv_case(op)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_scatters_write_the_given_arena_in_place():
    ck, cv = (torch.from_numpy(a) for a in _arena(1))
    k2, v2 = tkv.scatter_block_kv(ck, cv, torch.tensor(2),
                                  torch.ones(BS, 2, 4), torch.ones(BS, 2, 4))
    assert k2 is ck and v2 is cv and bool((ck[2] == 1).all())


# -- greedy streams -----------------------------------------------------------

@pytest.mark.parametrize("lens", [[8], [3, 5, 8, 11, 9, 27]],
                         ids=["single", "mixed"])
def test_streams_match_reference_engine_and_generate(pair, lens):
    """Mixed lengths, more requests than slots (two admission waves),
    prompts of up to four chunks: the port's streams equal the JAX
    engine's and the port's generate()."""
    prompts = _prompts(lens)
    jh, th = _both(pair, prompts, 5)
    assert _tokens(th) == _tokens(jh)
    assert _tokens(th) == _generate(pair[1], prompts, 5)
    for p, h in zip(prompts, th):
        np.testing.assert_array_equal(h.result()[:p.size], p)
    assert pair[3].compiled_counts() == (1, 1)
    assert pair[3].pool.free_count == SLOTS


def test_prefix_sharing_matches_reference(pair):
    _, tm, je, te = pair
    hits = (je.metrics.prefix_hit_tokens, te.metrics.prefix_hit_tokens)
    prompts = _shared()
    jh, th = _both(pair, prompts, 6)
    assert _tokens(th) == _tokens(jh) == _generate(tm, prompts, 6)
    gained = (te.metrics.prefix_hit_tokens - hits[1],
              je.metrics.prefix_hit_tokens - hits[0])
    assert gained[0] == gained[1] >= 2 * BS


def test_refcounts_drain_and_prefix_survives(pair):
    _, _, _, te = pair
    prompts = _shared(2, seed=13)
    hs = [te.submit(p, max_new_tokens=5) for p in prompts]
    te.step()
    assert (te.pool.ref > 1).any(), "no block was shared while both ran"
    te.run_until_idle()
    assert all(h.done for h in hs)
    assert (te.pool.ref == 0).all()
    hits = te.metrics.prefix_hits
    _serve(te, prompts[:1], 3)
    assert te.metrics.prefix_hits == hits + 1


def test_share_prefix_off_gives_equal_streams(pair):
    jm, tm, _, te = pair
    prompts = _shared(seed=23)
    shared = _tokens(_serve(te, prompts, 4))
    eng = ServeEngine(tm, 2, MAX_LEN, block_size=BS, share_prefix=False)
    assert _tokens(_serve(eng, prompts, 4)) == shared
    assert eng.metrics.prefix_hits == 0


def test_preemption_matches_reference(pair):
    """Both requests outgrow a 5-block pool mid-decode: the youngest is
    preempted and re-prefilled, on both engines alike, in as many
    steps."""
    jm, tm, _, _ = pair
    kw = dict(block_size=BS, num_blocks=6, **FAST)
    je, te = JEngine(jm, 2, MAX_LEN, **kw), ServeEngine(tm, 2, MAX_LEN, **kw)
    prompts = _prompts([7, 7], seed=37)
    jh, th = _both(pair, prompts, 16, je, te)
    assert _tokens(th) == _tokens(jh) == _generate(tm, prompts, 16)
    assert te.metrics.preempted == je.metrics.preempted >= 1
    assert te.metrics.steps == je.metrics.steps
    assert te.compiled_counts() == (1, 1)
    assert (te.pool.ref == 0).all()


def test_admission_waits_for_blocks_not_slots(pair):
    _, tm, _, _ = pair
    eng = ServeEngine(tm, 9, MAX_LEN, block_size=BS, num_blocks=9)
    prompts = _prompts([23, 23, 23], seed=31)
    hs = [eng.submit(p, max_new_tokens=9) for p in prompts]
    eng.step()
    assert eng.pool.active_count == 2 and eng.pool.free_count == 7
    eng.run_until_idle()
    assert _tokens(hs) == _generate(tm, prompts, 9)


# -- injected faults ----------------------------------------------------------

#: (plan specs, poisoned-first prompt or None): each is the same plan in
#: both packages, so they fire on the same site calls
CHAOS = {
    "retry": ([("serve.decode", "error", dict(every=3, times=2)),
               ("serve.prefill", "error", dict(at=2))], None),
    "quarantine": ([("serve.prefill", "error", dict(every=1, times=3))],
                   5),
    "alloc_quarantine": ([("serve.block_alloc", "error", dict(at=1))], 5),
    "alloc_recovery": ([("serve.block_alloc", "error", dict(at=4))], None),
    "decode_recovery": ([("serve.decode", "error", dict(every=1, times=3))],
                        None),
}


def _plan(mod, specs):
    return mod.FaultPlan([mod.FaultSpec(s, k, **kw) for s, k, kw in specs],
                         seed=1)


def _chaos_run(eng, mod, specs, poisoned):
    prompts = _prompts([4, 6, 8])
    plan = _plan(mod, specs)
    with mod.active(plan), _maybe_warns(poisoned):
        bad = ([eng.submit(_prompts([poisoned], seed=3)[0],
                           max_new_tokens=6)] if poisoned else [])
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_idle()
    return plan, bad, hs


def _maybe_warns(poisoned):
    import contextlib
    return (pytest.warns(UserWarning, match="quarantined") if poisoned
            else contextlib.nullcontext())


@pytest.mark.parametrize("case", sorted(CHAOS))
def test_injected_faults_match_reference(pair, case):
    """Retry, quarantine and recovery under the same seeded plan: the
    port fires on the same calls, reaches the same outcomes, and its
    surviving streams equal both the reference's and a fault-free
    run's."""
    _, tm, je, te = pair
    specs, poisoned = CHAOS[case]
    clean = _generate(tm, _prompts([4, 6, 8]), 6)
    before = dict(te.metrics.snapshot()), dict(je.metrics.snapshot())
    jplan, jbad, jh = _chaos_run(je, jfaults, specs, poisoned)
    tplan, tbad, th = _chaos_run(te, tfaults, specs, poisoned)
    assert _tokens(th) == _tokens(jh) == clean
    assert tplan.fire_count() == jplan.fire_count() > 0
    assert tplan.fired == jplan.fired
    assert tplan.calls == jplan.calls
    assert [(h.failed, h.finish_reason) for h in tbad] == \
        [(h.failed, h.finish_reason) for h in jbad]
    for key in ("retries", "quarantined", "recoveries"):
        t_now, j_now = te.metrics.snapshot()[key], je.metrics.snapshot()[key]
        if isinstance(t_now, dict):
            t_d = {k: v - before[0][key].get(k, 0) for k, v in t_now.items()}
            j_d = {k: v - before[1][key].get(k, 0) for k, v in j_now.items()}
            assert {k: v for k, v in t_d.items() if v} == \
                {k: v for k, v in j_d.items() if v}, key
        else:
            assert t_now - before[0][key] == j_now - before[1][key], key
    assert te.compiled_counts() == (1, 1)
    assert (te.pool.ref == 0).all() and te.pool.free_count == SLOTS


def test_heartbeat_hang_drives_recovery(pair, monkeypatch):
    """A decode that hangs past the heartbeat timeout asks for a
    recovery at the next step boundary; streams stay equal.  The
    watchdog reads a clock that moves only while the injected hang
    lasts, and the hang holds until the watchdog has fired: exactly one
    hang is seen, however slowly the steps run."""
    from singa_tpu_torch.utils import failure
    _, tm, _, _ = pair
    prompts = _prompts([6, 9])
    clean = _generate(tm, prompts, 6)
    eng = ServeEngine(tm, 2, MAX_LEN, block_size=BS, heartbeat_timeout_s=0.05,
                      recover_on_hang=True, **FAST)
    clock = [0.0]

    def hang(seconds):
        clock[0] += seconds
        assert eng._recover_flag.wait(timeout=30), "the watchdog never fired"

    monkeypatch.setattr(failure, "time",
                        types.SimpleNamespace(monotonic=lambda: clock[0]))
    monkeypatch.setattr(tfaults, "time", types.SimpleNamespace(sleep=hang))
    plan = _plan(tfaults, [("serve.decode", "hang",
                            dict(at=2, delay_s=1.0))])
    with tfaults.active(plan):
        assert _tokens(_serve(eng, prompts, 6)) == clean
    assert plan.fire_count() == 1
    assert eng.metrics.recoveries == 1
    assert eng.compiled_counts() == (1, 1)


def test_recovery_resets_in_place_and_keeps_programs(pair):
    _, tm, _, te = pair
    prompts = _prompts([9, 4], seed=5)
    clean = _generate(tm, prompts, 8)
    arena = [(k.data_ptr(), v.data_ptr()) for k, v in te.pool.caches]
    tables, toks = te.pool.tables.data_ptr(), te._toks.data_ptr()
    hs = [te.submit(p, max_new_tokens=8) for p in prompts]
    te.step()
    te.recover("test")
    te.recover("test-again")
    te.run_until_idle()
    assert _tokens(hs) == clean
    assert [(k.data_ptr(), v.data_ptr()) for k, v in te.pool.caches] == arena
    assert (te.pool.tables.data_ptr(), te._toks.data_ptr()) == (tables, toks)
    assert te.compiled_counts() == (1, 1)


def test_incident_records_and_dumps_go_to_the_given_store(pair, tmp_path):
    _, _, _, te = pair
    store = str(tmp_path / "runs" / "torch" / "records.jsonl")
    te.record_store = store
    try:
        te.submit(_prompts([4])[0], max_new_tokens=4)
        te.step()
        te.recover("test")
        te.run_until_idle()
    finally:
        te.record_store = None
    (entry,) = trecord.RunRecord(store).entries()
    assert entry["kind"] == "incident"
    assert (entry["platform"], entry["smoke"]) == ("cpu", True)
    assert entry["payload"]["outcome"] == "recovered"
    dump = tmp_path / "runs" / "torch" / entry["payload"]["flight_ref"]
    names = {json.loads(ln)["name"] for ln in dump.read_text().splitlines()}
    assert "serve.token" in names


def test_port_record_store_is_not_the_reference_store():
    assert trecord.DEFAULT_STORE != "runs/records.jsonl"
    assert trecord.DEFAULT_STORE.startswith("runs")


# -- admission control, deadlines, validation --------------------------------

def test_queue_full_rejects_and_drains(pair):
    _, _, _, te = pair
    rej = te.metrics.rejected
    ps = _prompts([4] * 9)
    hs = [te.submit(p, max_new_tokens=3) for p in ps[:2 * SLOTS]]
    with pytest.raises(QueueFull):
        te.submit(ps[-1], max_new_tokens=3)
    assert te.metrics.rejected == rej + 1
    te.run_until_idle()
    assert all(h.finish_reason == "length" for h in hs)


def test_deadline_evicts_queued_and_running(pair):
    import time
    _, _, _, te = pair
    h_run = te.submit(_prompts([4])[0], max_new_tokens=28, deadline_s=0.2)
    h_q = te.submit(_prompts([5], seed=9)[0], max_new_tokens=4,
                    deadline_s=-1.0)
    te.step()
    assert h_q.done and h_q.finish_reason == "deadline" and not h_q.tokens
    te.step()
    time.sleep(0.25)
    te.step()
    assert h_run.finish_reason == "deadline" and 0 < len(h_run.tokens) < 28
    assert te.pool.free_count == SLOTS


@pytest.mark.parametrize("n", [0, -1])
def test_max_new_tokens_validated(pair, n):
    with pytest.raises(ValueError, match="max_new_tokens"):
        pair[3].submit(np.zeros(4, np.int32), max_new_tokens=n)


def test_oversized_request_refused_at_the_door(pair):
    with pytest.raises(ValueError, match="max_len"):
        pair[3].submit(np.zeros(10, np.int32), max_new_tokens=30)


def test_drain_and_close(pair):
    _, tm, _, _ = pair
    eng = ServeEngine(tm, 2, MAX_LEN, block_size=BS)
    h = eng.submit(_prompts([5])[0], max_new_tokens=3)
    eng.close()
    assert h.done and len(h.tokens) == 3
    with pytest.raises(EngineClosed):
        eng.submit(_prompts([5])[0], max_new_tokens=3)
    with pytest.raises(EngineClosed):
        eng.step()


@pytest.mark.parametrize("kw", [dict(spec_k=2),
                                dict(kv_dtype="int4"),
                                dict(spill_blocks=0),
                                dict(programs="another model's")],
                         ids=["spec", "kv_dtype", "spill", "programs"])
def test_later_slice_options_raise(pair, kw):
    """The options ported after the engine (speculation, the int8 arena,
    the spill tier, program sharing) refuse a bad value as the
    reference does: a programs= bundle made for another model object
    included."""
    if "programs" in kw:
        kw = dict(programs=pair[3].programs()._replace(model_ref=object()))
    with pytest.raises(ValueError,
                       match="draft_model|kv_dtype|spill|SAME model"):
        ServeEngine(pair[1], 2, MAX_LEN, block_size=BS, **kw)


@pytest.mark.parametrize("method", ["programs", "extract_handoff",
                                    "inject_handoff", "can_accept_handoff"])
def test_handoff_hooks_raise(pair, method):
    """The tier hooks refuse what the reference's refuse: their bundle
    lent to an engine of another block size, an extract from an empty
    slot, an inject of a request that has no first token yet, and a
    capacity probe of no package."""
    from singa_tpu.serve.disagg import HandoffPackage as JPackage
    from singa_tpu.serve.scheduler import Request as JRequest
    from singa_tpu_torch.serve.disagg import HandoffPackage
    from singa_tpu_torch.serve.scheduler import Request
    for eng, model, pkg_cls, req_cls, cls in (
            (pair[2], pair[0], JPackage, JRequest, JEngine),
            (pair[3], pair[1], HandoffPackage, Request, ServeEngine)):
        if method == "programs":
            with pytest.raises(ValueError, match="block_size"):
                cls(model, 2, MAX_LEN, block_size=2 * BS,
                    programs=eng.programs())
        elif method == "extract_handoff":
            with pytest.raises(KeyError):
                eng.extract_handoff(0)
        elif method == "inject_handoff":
            req = req_cls(np.ones(5, np.int32), 2, None, None, None)
            pkg = pkg_cls(req=req, kv=[], pos=4, n_blocks=1)
            with pytest.raises((AssertionError, ValueError)):
                eng.inject_handoff(pkg)
            assert eng.pool.free_count == SLOTS
        else:
            with pytest.raises(AttributeError):
                eng.can_accept_handoff(None)


# -- telemetry ----------------------------------------------------------------

#: fields that differ between any two runs: wall clocks, durations and
#: the ids minted per engine/process
_VOLATILE = ("t", "dur_ms", "trace", "span", "parent", "age_s")


def _serve_events(path):
    """The serve.* lines of a sink, volatile fields dropped and request
    ids renumbered by first appearance (each package counts its own)."""
    out, rids = [], {}
    for ln in open(path):
        e = json.loads(ln)
        if not e["name"].startswith("serve."):
            continue
        if e["kind"] == "hist":
            e.pop("value")
        if "rid" in e:
            e["rid"] = rids.setdefault(e["rid"], len(rids))
        out.append(json.dumps({k: v for k, v in e.items()
                               if k not in _VOLATILE}, sort_keys=True))
    return out


def test_obs_events_match_reference(pair, tmp_path):
    """The same traffic (mixed lengths, a shared prefix, a retried
    decode) through two fresh engines writes the same serve.* events
    with the same attributes, in the same order."""
    jm, tm, _, _ = pair
    prompts = _prompts([4, 11]) + _shared(2, seed=41)
    logs = {}
    for name, eng, ev, fmod in (
            ("jax", JEngine(jm, SLOTS, MAX_LEN, block_size=BS, **FAST),
             jevents, jfaults),
            ("torch", ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS, **FAST),
             tevents, tfaults)):
        path = str(tmp_path / f"{name}.jsonl")
        ev.configure(path=path)
        try:
            with fmod.active(_plan(fmod, [("serve.decode", "error",
                                           dict(at=3))])):
                _serve(eng, prompts, 4)
        finally:
            ev.configure()
        logs[name] = _serve_events(path)
    assert len(logs["torch"]) > 50
    assert logs["torch"] == logs["jax"]


def test_attribution_ledger_times_both_programs(pair):
    led = tattr.install()
    try:
        _serve(pair[3], _prompts([9, 4]), 3)
    finally:
        tattr.uninstall()
    snap = led.snapshot()
    assert snap["prefill_chunk"]["count"] == 3
    assert snap["decode"]["count"] == 2
