"""The port's speculative decoding (singa_tpu_torch/serve/spec.py and the
spec engine) against the JAX package's, on the CPU: LlamaConfig.tiny()
in f32 with the reference's weights carried over through
`load_reference_params`, num_slots=4, block_size=8, spec_k=2.

Streams must be token-identical to the reference engine's and to the
port's own generate() at both ends of draft quality (self-speculation,
accepting everything; an adversarial draft, accepting nothing), through
eos mid-run, an injected serve.verify fault, recovery and growth
preemption; the program set stays (prefill, decode, verify, handoff);
the serve.verify and serve.spec_* events equal the reference's."""

import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from singa_tpu import faults as jfaults
from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.obs import events as jevents
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import faults as tfaults
from singa_tpu_torch.models import Llama, LlamaConfig, load_reference_params
from singa_tpu_torch.obs import events as tevents
from singa_tpu_torch.autotune import table as ttable
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.serve.scheduler import (Request, Scheduler,
                                             eta_first_token)

SLOTS, MAX_LEN, BS, K = 4, 48, 8, 2
#: prompt lengths every generate() reference reuses
LENS = (5, 8)
NNEW = 9


class _AdversarialDraft:
    """A draft that can never agree with the target: it negates the
    logits, so its greedy pick is the target's argmin — every proposal
    is rejected and each round makes exactly one token of progress.
    Delegates everything else to the wrapped model."""

    def __init__(self, model):
        self._m = model

    def __getattr__(self, name):
        return getattr(self._m, name)

    def forward_cached(self, ids, caches, pos):
        logits, caches = self._m.forward_cached(ids, caches, pos)
        return -logits, caches


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model with the same weights, a JAX and a port
    self-speculation engine)."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    kw = dict(block_size=BS, spec_k=K, backoff_base=0.001, backoff_max=0.01)
    return (jm, tm, JEngine(jm, SLOTS, MAX_LEN, draft_model=jm, **kw),
            ServeEngine(tm, SLOTS, MAX_LEN, draft_model=tm, **kw))


def _prompts(n, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (LENS[i % len(LENS)],)).astype(np.int32)
            for i in range(n)]


def _generate(tm, prompts, n=NNEW):
    return [list(map(int, tm.generate(p[None], max_new_tokens=n)[0, p.size:]))
            for p in prompts]


def _serve(eng, prompts, n=NNEW, **kw):
    hs = [eng.submit(p, max_new_tokens=n, **kw) for p in prompts]
    eng.run_until_idle()
    return [list(map(int, h.tokens)) for h in hs]


def test_self_speculation_equals_reference_and_generate(pair):
    jm, tm, je, te = pair
    prompts = _prompts(4)
    got, want = _serve(te, prompts), _serve(je, prompts)
    assert got == want == _generate(tm, prompts)
    snap, jsnap = te.metrics.snapshot(), je.metrics.snapshot()
    assert snap["accept_rate"] == jsnap["accept_rate"] == 1.0
    for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                "slot_dispatches", "tokens_per_dispatch"):
        assert snap[key] == jsnap[key], key
    assert 1.0 < snap["tokens_per_dispatch"] <= K + 1
    assert te.spec_compiled_counts() == (1, 0, 1, 0)
    assert te.pool.free_count == SLOTS and (te.pool.ref == 0).all()


def test_eos_stops_mid_accepted_run(pair):
    _, tm, je, te = pair
    prompt = _prompts(1, seed=11)[0]
    ref = _generate(tm, [prompt])[0]
    eos = ref[3]
    handles = [e.submit(prompt, max_new_tokens=NNEW, eos_id=eos)
               for e in (je, te)]
    for e in (je, te):
        e.run_until_idle()
    jh, th = handles
    assert th.finish_reason == jh.finish_reason == "eos"
    assert th.tokens == jh.tokens == ref[:ref.index(eos) + 1]
    assert te.pool.free_count == SLOTS


def test_injected_verify_fault_falls_back_bitwise(pair):
    """Three fires in a row exhaust the retries of ONE verify dispatch:
    that tick runs plain decode (its program made then), the streams
    stay equal, and the port fires on the same calls as the reference."""
    _, tm, je, te = pair
    prompts = _prompts(2, seed=23)
    runs = []
    for eng, fmod in ((je, jfaults), (te, tfaults)):
        fb0 = eng.metrics.spec_fallbacks
        plan = fmod.FaultPlan([fmod.FaultSpec("serve.verify", "error",
                                              every=1, times=3)])
        with fmod.active(plan), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runs.append((_serve(eng, prompts), plan,
                         eng.metrics.spec_fallbacks - fb0))
    (jt, jplan, jfb), (tt, tplan, tfb) = runs
    assert tt == jt == _generate(tm, prompts)
    assert tplan.fire_count() == jplan.fire_count() == 3
    assert tplan.calls == jplan.calls
    assert tfb == jfb >= 1
    assert te.spec_compiled_counts() == (1, 1, 1, 0)


def test_recovery_keeps_spec_streams_and_programs(pair):
    """A mid-stream recovery zeroes both arenas in place; the spec
    prefill re-warms both from prompt + tokens-so-far."""
    _, tm, _, te = pair
    prompts = _prompts(2, seed=37)
    counts = te.spec_compiled_counts()
    dptr = te.pool.draft_caches[0][0].data_ptr()
    hs = [te.submit(p, max_new_tokens=NNEW) for p in prompts]
    te.step()
    te.recover("test: simulated device event")
    te.run_until_idle()
    assert [list(map(int, h.tokens)) for h in hs] == _generate(tm, prompts)
    assert te.metrics.recoveries >= 1
    assert te.pool.draft_caches[0][0].data_ptr() == dptr
    assert te.spec_compiled_counts() == counts


def test_adversarial_draft_rolls_back_exactly(pair):
    """Every proposal rejected, every round: streams still equal the
    reference engine's and generate(), one token per slot per round."""
    jm, tm, _, _ = pair
    prompts = _prompts(2, seed=31)
    kw = dict(block_size=BS, spec_k=K)
    je = JEngine(jm, 2, MAX_LEN, draft_model=_AdversarialDraft(jm), **kw)
    te = ServeEngine(tm, 2, MAX_LEN, draft_model=_AdversarialDraft(tm), **kw)
    assert _serve(te, prompts) == _serve(je, prompts) == \
        _generate(tm, prompts)
    snap = te.metrics.snapshot()
    assert snap["accept_rate"] == je.metrics.snapshot()["accept_rate"] == 0.0
    assert snap["tokens_per_dispatch"] == 1.0
    assert snap["spec_rounds"] == snap["slot_dispatches"]
    assert te.spec_compiled_counts() == (1, 0, 1, 0)
    assert (te.pool.ref == 0).all()


def test_growth_preemption_keeps_spec_streams(pair):
    """A pool too small for both slots: growth (spec_k positions ahead)
    preempts the youngest request mid-speculation, and its replay
    reproduces the stream, as the reference engine's does."""
    jm, tm, _, _ = pair
    prompts = _prompts(2, seed=43)
    kw = dict(block_size=BS, num_blocks=8, spec_k=K)
    je = JEngine(jm, 2, MAX_LEN, draft_model=jm, **kw)
    te = ServeEngine(tm, 2, MAX_LEN, draft_model=tm, **kw)
    assert _serve(te, prompts, 20) == _serve(je, prompts, 20) == \
        _generate(tm, prompts, 20)
    assert te.metrics.preempted == je.metrics.preempted >= 1
    assert te.spec_compiled_counts() == (1, 0, 1, 0)


def test_draft_and_k_must_come_together(pair, tmp_path, monkeypatch,
                                        capsys):
    """spec_k=None with a draft asks the best-config table; with no
    table it takes the table's fallback, announced once on stderr, as
    the reference engine does."""
    _, tm, _, _ = pair
    monkeypatch.setenv(ttable.ENV_TABLE, str(tmp_path / "none.json"))
    monkeypatch.setattr(ttable, "_WARNED", set())
    eng = ServeEngine(tm, 2, 32, block_size=BS, draft_model=tm)
    assert eng.spec_k == ttable.SPEC_K_FALLBACK == 3
    assert "no best-config table" in capsys.readouterr().err
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(tm, 2, 32, block_size=BS, draft_model=tm, spec_k=0)
    with pytest.raises(ValueError, match="draft_model"):
        ServeEngine(tm, 2, 32, block_size=BS, spec_k=2)


def test_submit_enforces_spec_headroom(pair):
    """prompt + budget + spec_k must fit max_len: the LAST verify round
    still writes a full k+1 window; the reference refuses the same."""
    _, _, je, te = pair
    for eng in (je, te):
        with pytest.raises(ValueError, match="spec_k"):
            eng.submit(np.ones(8, np.int32),
                       max_new_tokens=MAX_LEN - 8 - K + 1)
        eng.submit(np.ones(8, np.int32), max_new_tokens=MAX_LEN - 8 - K)
        eng.run_until_idle()
        assert eng.pending == 0


def test_eta_scales_with_tokens_per_tick():
    base = eta_first_token(5, free_slots=1, wave_size=2, tick_s=1.0)
    assert eta_first_token(5, free_slots=1, wave_size=2, tick_s=1.0,
                           tokens_per_tick=3.0) == pytest.approx(base / 3)

    def eta(tpt, position):
        eng = SimpleNamespace(_tick_ewma=0.15, _tpt_ewma=tpt,
                              tick_hint_s=None,
                              pool=SimpleNamespace(free_count=0,
                                                   num_slots=1))
        return ServeEngine._eta_first_token(eng, position)

    sched = Scheduler(max_queue=8)
    reqs = [Request(np.ones(4, np.int32), 4, deadline_s=0.5, eos_id=None,
                    on_token=None) for _ in range(4)]
    for r in reqs:
        sched.offer(r)
    now = reqs[0].submitted_at
    assert len(sched.shed_overload(now, lambda p: eta(None, p))) == 1
    assert sched.shed_overload(now, lambda p: eta(3.0, p)) == []


def test_spec_engine_feeds_the_eta(pair):
    _, _, _, te = pair
    assert te._tpt_ewma is not None and te._tpt_ewma > 1.0


#: fields that differ between any two runs
_VOLATILE = ("t", "dur_ms", "trace", "span", "parent", "age_s")


def _serve_events(path):
    out, rids = [], {}
    for ln in open(path):
        e = json.loads(ln)
        if not e["name"].startswith("serve."):
            continue
        if e["kind"] == "hist" and e["name"] != "serve.accept_rate":
            e.pop("value")
        if "rid" in e:
            e["rid"] = rids.setdefault(e["rid"], len(rids))
        out.append(json.dumps({k: v for k, v in e.items()
                               if k not in _VOLATILE}, sort_keys=True))
    return out


def test_spec_events_match_reference(pair, tmp_path):
    """The same traffic with a verify fault past retries through two
    fresh spec engines writes the same serve.* events — serve.verify
    spans, spec_proposed/accepted/fallbacks counters and the accept-rate
    histogram's values among them."""
    jm, tm, _, _ = pair
    prompts = _prompts(3, seed=41)
    logs = {}
    kw = dict(block_size=BS, spec_k=K, backoff_base=0.001, backoff_max=0.01)
    for name, eng, ev, fmod in (
            ("jax", JEngine(jm, SLOTS, MAX_LEN, draft_model=jm, **kw),
             jevents, jfaults),
            ("torch", ServeEngine(tm, SLOTS, MAX_LEN, draft_model=tm, **kw),
             tevents, tfaults)):
        path = str(tmp_path / f"{name}.jsonl")
        ev.configure(path=path)
        plan = fmod.FaultPlan([fmod.FaultSpec("serve.verify", "error",
                                              at=2 + i) for i in range(3)])
        try:
            with fmod.active(plan), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _serve(eng, prompts, 6)
        finally:
            ev.configure()
        logs[name] = _serve_events(path)
    names = {json.loads(e)["name"] for e in logs["torch"]}
    assert {"serve.verify", "serve.spec_proposed", "serve.spec_accepted",
            "serve.spec_fallbacks", "serve.accept_rate"} <= names
    assert logs["torch"] == logs["jax"]
