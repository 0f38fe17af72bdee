"""The port's observability layer (singa_tpu_torch.obs) against the JAX
package's: histogram summaries, schema verdicts, the attribution ledger
and the record store agree; spans, traces and flight dumps behave as the
reference's do; the port's records go to a store of their own; and the
step executor's host seams emit their spans."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from singa_tpu.obs import attr as jattr
from singa_tpu.obs import events as jevents
from singa_tpu.obs import schema as jschema
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import opt
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.obs import attr, events, flight, record, schema, trace


@pytest.fixture(autouse=True)
def _reset_events():
    yield
    events.configure(annotate=False)
    attr.uninstall()


def _values(seed, n):
    rng = np.random.RandomState(seed)
    return list(rng.lognormal(1.0, 1.5, n))


@pytest.mark.parametrize("n", [1, 5, 4096, 9000])
def test_hist_summaries_equal_the_reference(n):
    """Exact totals and nearest-rank percentiles, past the ring's
    wrap-around too (9000 > 4096)."""
    j, t = jevents._Hist(), events._Hist()
    for v in _values(n, n):
        j.observe(v)
        t.observe(v)
    assert t.summary() == j.summary()


def test_histogram_registry_matches_the_reference():
    for mod in (jevents, events):
        mod.reset_histograms("t.port")
        for v in (1.0, 2.0, 3.0, 4.0, 100.0):
            mod.histogram("t.port", v)
    assert events.histogram_summary("t.port") == \
        jevents.histogram_summary("t.port")
    events.reset_histograms("t.port")
    assert events.histogram_summary("t.port") is None


def test_attribution_ledgers_agree():
    j, t = jattr.Ledger(), attr.Ledger()
    for i, v in enumerate(_values(2, 300)):
        for led in (j, t):
            led.note("decode" if i % 3 else "prefill_chunk", v * 1e-3)
    assert t.snapshot() == j.snapshot()
    feats = {"decode": {"flops": 1e9, "hbm_bytes": 2e8}}
    assert attr.attribution_payload(t.snapshot(), feats, 2.0) == \
        jattr.attribution_payload(j.snapshot(), feats, 2.0)


def _entry(**over):
    e = {"schema_version": 1, "run_id": "r1", "kind": "incident",
         "platform": "cuda", "smoke": False, "device": "NVIDIA H100",
         "created_at": 1.0,
         "payload": {"site": "serve.decode", "fault": "InjectedFault",
                     "ref": "req:1", "outcome": "recovered", "retries": 2}}
    e.update(over)
    return e


def _without(key):
    e = _entry()
    del e[key]
    return e


def _payload(**over):
    e = _entry()
    e["payload"] = dict(e["payload"], **over)
    return e


ENTRIES = {
    "incident": _entry(),
    "session": _entry(kind="session", stages={
        "probe": {"ok": True, "s": 1.0, "result": "cuda"}}),
    "no_created_at": _without("created_at"),
    "no_platform": _without("platform"),
    "smoke_not_bool": _entry(smoke="no"),
    "unknown_kind": _entry(kind="weather"),
    "bad_outcome": _payload(outcome="shrugged"),
    "negative_retries": _payload(retries=-1),
    "flight_ref_absolute": _payload(flight_ref="/abs/x.jsonl"),
    "serve_throughput": _entry(kind="serve_throughput", payload={
        "tokens_per_s": 1.0, "speedup_vs_sequential": 2.0,
        "ttft_p50_ms": 3.0, "ttft_p99_ms": 4.0, "requests": 16}),
    "serve_throughput_missing": _entry(kind="serve_throughput", payload={
        "tokens_per_s": 1.0}),
    "bench_partial_wire": _entry(kind="bench", payload={
        "headline": {}, "wire_bytes_compressed": 1}),
}


def _verdict(mod, entry):
    try:
        mod.validate_entry(copy.deepcopy(entry))
        return "ok"
    except mod.SchemaError as e:
        return f"rejected: {e}"


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_schema_verdicts_equal_the_reference(name):
    assert _verdict(schema, ENTRIES[name]) == _verdict(jschema, ENTRIES[name])


def test_default_store_is_the_ports_own():
    assert record.DEFAULT_STORE != os.path.join("runs", "records.jsonl")
    assert record.DEFAULT_STORE == os.path.join("runs", "torch",
                                                "records.jsonl")


def test_store_keeps_smoke_from_shadowing_card_entries(tmp_path):
    store = record.RunRecord(str(tmp_path / "records.jsonl"))
    card = record.new_entry("session", "cuda", False, "NVIDIA H100",
                            run_id="r", stages={})
    store.append(card)
    line = store.raw_lines()[0]
    store.append(record.new_entry("session", "cpu", True, "cpu",
                                  run_id="r", stages={}))
    assert store.raw_lines()[0] == line and len(store.raw_lines()) == 2
    assert store.latest("session")["platform"] == "cuda"
    assert store.latest("session", smoke=True)["platform"] == "cpu"
    assert store.validate() == []
    assert record.is_onchip_session_doc(card)


def test_spans_nest_inside_a_trace(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    events.configure(path=path)
    with trace.activate("req-1"):
        with events.span("outer"):
            with events.span("inner", k=1):
                events.counter("c", 3)
    events.configure()
    evs = {e["name"]: e for e in map(json.loads, open(path))}
    assert all(e["trace"] == "req-1" for e in evs.values())
    assert evs["inner"]["parent"] == evs["outer"]["span"]
    assert evs["c"]["value"] == 3 and evs["inner"]["k"] == 1


def test_span_records_the_exception_type(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    events.configure(path=path)
    with pytest.raises(KeyError):
        with events.span("boom"):
            raise KeyError("x")
    events.configure()
    (e,) = map(json.loads, open(path))
    assert e["error"] == "KeyError"


def test_disabled_span_is_a_shared_noop():
    events.configure(sink=None, annotate=False)
    assert not events.enabled()
    assert events.span("a") is events.span("b")


def test_annotated_spans_show_on_the_torch_profiler():
    events.configure(annotate=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with events.span("port.annotated"):
            torch.ones(4).sum()
    assert "port.annotated" in {e.name for e in prof.events()}


def test_flight_dump_refuses_unknown_sites_and_writes_atomically(tmp_path):
    rec = flight.FlightRecorder(capacity=3)
    with trace.activate("tr-9"):
        for i in range(5):
            rec.note("counter", "serve.token", n=i)
    assert [e["n"] for e in rec.snapshot()] == [2, 3, 4]
    with pytest.raises(ValueError, match="unknown flight-dump site"):
        rec.dump("serve.decoed", str(tmp_path))
    path = rec.dump("serve.arena", str(tmp_path), reason="test")
    lines = [json.loads(ln) for ln in open(path)]
    assert [e.get("trace") for e in lines[:3]] == ["tr-9"] * 3
    assert lines[-1]["reason"] == "test"
    assert os.listdir(tmp_path) == [os.path.basename(path)]


@pytest.fixture(scope="module")
def tiny():
    return Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"),
                 generator=torch.Generator().manual_seed(0))


def test_train_step_emits_step_and_execute_spans(tiny, tmp_path):
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, 8)).astype(np.int32))
    tiny.set_optimizer(opt.SGD(lr=0.01))
    tiny.compile([ids], is_train=True, use_graph=True)
    path = str(tmp_path / "ev.jsonl")
    events.configure(path=path)
    led = attr.install()
    for _ in range(2):
        tiny.train_step(ids)
    attr.uninstall()
    events.configure()
    spans = [e for e in map(json.loads, open(path)) if e["kind"] == "span"]
    names = [e["name"] for e in spans]
    assert names.count("model.train_step") == 2
    assert names.count("graph.execute") == 2
    ex = [e for e in spans if e["name"] == "graph.execute"]
    assert [e["step"] for e in ex] == [0, 1]
    # the model's own name, as the reference's f"{m.name}.{tag}"
    assert tiny.name.startswith("llama")
    assert all(e["graph"] == f"{tiny.name}.train" for e in ex)
    assert led.snapshot()["train_step"]["count"] == 2

