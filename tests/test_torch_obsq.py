"""The port's obsq (``singa_tpu_torch/tools/obsq.py``) against the JAX
package's (``tools/obsq.py``), in-process through ``main(argv)`` on the
CPU, over the committed fixture (``tests/data/obsq``) and over the
events and ``serve_load`` record of a tiny port ``ServeEngine`` driven by
the port's load generator: every invocation runs through both tools, which
must print the same text and exit with the same code, a planted SLO
mismatch (exit 1) included.  Exact comparisons: no tolerance."""

import json
import os
import shutil

import pytest
import torch

from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.obs import events as tevents
from singa_tpu_torch.obs import flight as tflight
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import trace as ttrace
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.tools import loadgen as tload
from singa_tpu_torch.tools import obsq as tobsq
from tools import obsq as jobsq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX_RECORDS = os.path.join(REPO, "tests", "data", "obsq", "records.jsonl")
FIX_EVENTS = os.path.join(REPO, "tests", "data", "obsq", "events.jsonl")
CPU = tdevice.create_device("cpu")


def _run(mod, argv, capsys):
    rc = mod.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def both(argv, capsys):
    """(exit code, stdout, stderr) of the port's obsq, held equal to the
    reference's on the same arguments."""
    got = _run(tobsq, argv, capsys)
    assert got == _run(jobsq, argv, capsys)
    return got


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """A tiny f32 engine of the port under the load generator (8 arrivals,
    two tenants behind a shared prefix), its events in a JSONL sink and
    its serve_load record in a store of its own."""
    d = tmp_path_factory.mktemp("obsq")
    ev = str(d / "ev.jsonl")
    m = Llama(LlamaConfig.tiny(), device=CPU,
              generator=torch.Generator().manual_seed(0))
    eng = ServeEngine(m, 4, 48, block_size=8)
    wl = tload.build_workload(8, 400.0, 0, prompt_lens=(6, 10, 16),
                              new_tokens=(4, 8), tenants=2, shared_len=8)
    tevents.configure(path=ev)
    try:
        payload = tload.run_load(eng, wl)
    finally:
        tevents.configure()
        eng.close()
    store = tload.append_record(payload, str(d / "records.jsonl"),
                                device="cpu", prefix="load-obsq")
    evs = tobsq.load_events(ev)
    traces = sorted({e["trace"] for e in evs
                     if e.get("name") == "serve.ttft_ms"})
    return {"events": ev, "store": store, "traces": traces, "dir": d,
            "payload": payload}


def _sources(live):
    return {"fixture": (FIX_RECORDS, FIX_EVENTS),
            "engine": (live["store"], live["events"])}


@pytest.mark.parametrize("source", ["fixture", "engine"])
def test_slo_check_reproduces_the_record(live, capsys, source):
    records, events = _sources(live)[source]
    rc, out, _ = both(["slo", "--check", "--records", records,
                       "--events", events], capsys)
    assert rc == 0 and "reproducible" in out


@pytest.mark.parametrize("source", ["fixture", "engine"])
def test_planted_slo_mismatch_exits_1_on_both(live, capsys, tmp_path,
                                              source):
    records, events = _sources(live)[source]
    entry = trecord.RunRecord(records).entries()[-1]
    entry["payload"]["ttft_p99_ms"] = round(
        entry["payload"]["ttft_p99_ms"] * 1.1, 3)
    store = tmp_path / "records.jsonl"
    store.write_text(json.dumps(entry) + "\n")
    rc, _, err = both(["slo", "--check", "--records", str(store),
                       "--events", events], capsys)
    assert rc == 1 and "ttft_p99_ms" in err


def test_engine_events_derive_as_the_reference(live):
    evs = tobsq.load_events(live["events"])
    assert evs == jobsq.load_events(live["events"])
    assert tobsq.derive_slo(evs) == jobsq.derive_slo(evs)
    assert len(live["traces"]) == live["payload"]["completed"] == 8


def test_trace_renders_prefill_then_decode(live, capsys):
    """Each request's timeline: submitted, its prefill span, then its
    tokens in order (the first from the prefill, the rest decoded)."""
    evs = tobsq.load_events(live["events"])
    for tid in live["traces"]:
        rc, out, _ = both(["trace", tid, "--events", live["events"]],
                          capsys)
        mine = tobsq.trace_events(evs, tid)
        assert rc == 0 and out.startswith(f"trace {tid}  ({len(mine)} ")
        names = [e["name"] for e in mine]
        assert names[0] == "serve.submitted"
        assert names.index("serve.prefill") < names.index("serve.token")
        tokens = [e["n"] for e in mine if e["name"] == "serve.token"]
        assert tokens == list(range(1, len(tokens) + 1)) and \
            len(tokens) >= 4


@pytest.mark.parametrize("trace_id", ["fx/r3", "fx/nope"])
def test_trace_of_the_fixture(capsys, trace_id):
    rc, out, _ = both(["trace", trace_id, "--events", FIX_EVENTS], capsys)
    assert rc == 0
    assert ("tokens=3" in out) == (trace_id == "fx/r3")


def test_trace_merges_a_glob_of_sinks(live, capsys, tmp_path):
    a, b = tmp_path / "ev.jsonl", tmp_path / "ev.jsonl.p0-mp0"
    evs = tobsq.load_events(live["events"])
    half = len(evs) // 2
    a.write_text("".join(json.dumps(e) + "\n" for e in evs[:half]))
    b.write_text("".join(json.dumps(e) + "\n" for e in evs[half:]))
    pattern = str(tmp_path / "ev.jsonl*")
    assert tobsq.expand_event_paths([pattern]) == \
        jobsq.expand_event_paths([pattern])
    tid = live["traces"][0]
    merged = both(["trace", tid, "--events", pattern], capsys)
    assert merged == both(["trace", tid, "--events", live["events"]],
                          capsys)
    rc, _, err = both(["trace", tid, "--events",
                       str(tmp_path / "none*")], capsys)
    assert rc == 1 and "matches no files" in err


def test_malformed_events_fail_on_both(tmp_path):
    p = tmp_path / "ev.jsonl"
    p.write_text('{"t": 1, "kind": "counter"}\n{oops\n')
    for mod in (tobsq, jobsq):
        with pytest.raises(ValueError, match=":2:"):
            mod.load_events(str(p))


DIFFS = {
    "all": (["diff", "serve_load"], 0),
    "fields": (["diff", "serve_load", "--fields",
                "tokens_per_s,ttft_p99_ms"], 0),
    "last1": (["diff", "serve_load", "--last", "1"], 0),
    # the newest is a sweep point at 0.9 x the first record's p99
    "assert_ok": (["diff", "serve_load", "--assert-last",
                   "ttft_p99_ms<=+5%"], 0),
    "assert_fails": (["diff", "serve_load", "--assert-last",
                      "ttft_p99_ms>=+5%"], 1),
    "assert_typo": (["diff", "serve_load", "--assert-last",
                     "no_such_field<=+5%"], 1),
    "no_kind": (["diff", "hlo_audit"], 1),
    "sweep": (["diff", "--sweep", "sw-1"], 0),
}


@pytest.mark.parametrize("case", sorted(DIFFS))
def test_diff_rows_equal_the_reference(live, capsys, tmp_path, case):
    """The engine's record, then a copy with TTFT p99 raised by 10 % and
    two sweep points at 1.0 and 0.9: a trajectory of four."""
    argv, want_rc = DIFFS[case]
    shutil.copy(live["store"], tmp_path / "records.jsonl")
    store = str(tmp_path / "records.jsonl")
    rr = trecord.RunRecord(store)
    first = rr.entries()[0]
    for i, (scale, sweep) in enumerate(((1.1, None), (1.0, "sw-1"),
                                        (0.9, "sw-1"))):
        payload = dict(first["payload"], ttft_p99_ms=round(
            first["payload"]["ttft_p99_ms"] * scale, 3))
        if sweep:
            payload["sweep_id"] = sweep
            payload["knobs"] = {"num_slots": 4 * (i + 1)}
        rr.append(trecord.new_entry("serve_load", "cpu", True, "cpu",
                                    run_id=f"obsq-{i}", payload=payload))
    rc, out, err = both(argv + ["--records", store], capsys)
    assert rc == want_rc, err
    if case == "all":
        header, rows = tobsq.diff_rows(store, "serve_load")
        assert (header, rows) == jobsq.diff_rows(store, "serve_load")
        assert len(rows) == 5 and rows[-1][0].startswith("Δ")


def test_assert_last_catches_a_raised_p99(live, capsys, tmp_path):
    shutil.copy(live["store"], tmp_path / "records.jsonl")
    store = str(tmp_path / "records.jsonl")
    first = trecord.RunRecord(store).entries()[0]
    trecord.RunRecord(store).append(trecord.new_entry(
        "serve_load", "cpu", True, "cpu", run_id="obsq-raised",
        payload=dict(first["payload"], ttft_p99_ms=round(
            first["payload"]["ttft_p99_ms"] * 1.1 + 1.0, 3))))
    rc, _, err = both(["diff", "serve_load", "--records", store,
                       "--assert-last", "ttft_p99_ms<=+5%"], capsys)
    assert rc == 1 and "ASSERT FAILED" in err


@pytest.mark.parametrize("link", [True, False])
def test_incidents_list_the_dumps(capsys, tmp_path, link):
    store = str(tmp_path / "records.jsonl")
    rec = tflight.FlightRecorder()
    with ttrace.activate("tr-inc-1"):
        rec.note("error", "serve.worker_dead", worker="d0")
    ref = tflight.dump_for_store(rec, "serve.respawn", store, "test dump")
    if link:
        trecord.RunRecord(store).append(trecord.new_entry(
            "incident", "cpu", True, "cpu", run_id="t-inc-0",
            payload={"site": "serve.respawn", "fault": "respawn",
                     "ref": "d1", "outcome": "respawned", "retries": 0,
                     "flight_ref": ref}))
    rc, out, err = both(["incidents", "--records", store], capsys)
    assert rc == 0 and "tr-inc-1" in out
    assert ("NO" in out) == (not link) == bool(err)


def test_incidents_without_a_directory_exit_1(capsys, tmp_path):
    rc, _, err = both(["incidents", "--records",
                       str(tmp_path / "records.jsonl")], capsys)
    assert rc == 1 and "no incidents directory" in err


PERF_ATTR = {
    "programs": {
        "decode": {"count": 40, "p50_s": 0.0021, "p99_s": 0.0034,
                   "total_s": 0.0912, "achieved_flops_frac": 0.0125},
        "prefill": {"count": 8, "p50_s": 0.0108, "p99_s": 0.0122,
                    "total_s": 0.0871, "achieved_flops_frac": None}},
    "window_s": 0.25, "attributed_s": 0.1783, "attributed_frac": 0.7132}


@pytest.mark.parametrize("wrapped", [False, True])
def test_attr_table_of_a_payload_dump(capsys, tmp_path, wrapped):
    p = tmp_path / "perf_attr.json"
    p.write_text(json.dumps({"payload": PERF_ATTR} if wrapped
                            else PERF_ATTR))
    rc, out, _ = both(["attr", str(p), "--records",
                       str(tmp_path / "records.jsonl")], capsys)
    assert rc == 0 and "x80.0" in out and "71.3% of window" in out
    assert tobsq.attr_rows(PERF_ATTR) == jobsq.attr_rows(PERF_ATTR)


def test_attr_without_a_record_exits_1(capsys, tmp_path):
    rc, _, err = both(["attr", "--records",
                       str(tmp_path / "records.jsonl")], capsys)
    assert rc == 1 and "no perf_attr record" in err


def test_default_store_is_the_ports_own():
    parser_default = os.path.join(REPO, "runs", "torch", "records.jsonl")
    assert tobsq._STORE == parser_default
