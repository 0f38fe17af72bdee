"""The port's open-loop load generator (singa_tpu_torch.tools.loadgen)
against the JAX package's (tools/loadgen.py), on the CPU: the workload
array for array, `run_load` on a tiny f32 engine and on a 1:1 tier
(every request completes, streams equal generate(), the payload has the
reference's keys), the record the port's schema accepts, and the ratio
parser.  Exact comparisons throughout: no tolerance."""

import json

import numpy as np
import pytest

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import device as tdevice
from singa_tpu_torch.models import (Llama, LlamaConfig, llama,
                                    load_reference_params)
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.serve import Router, ServeEngine, build_pools
from singa_tpu_torch.tools import loadgen as tload
from tools import loadgen as jload

SLOTS, MAX_LEN, BS = 4, 64, 8
WORKLOAD = dict(prompt_lens=(6, 10, 16, 24), new_tokens=(4, 8),
                tenants=3, shared_len=16, vocab=256)


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


@pytest.fixture(scope="module")
def pair():
    """(JAX tiny model, port tiny model with its weights)."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    load_reference_params(tm, {n: np.asarray(t.data)
                               for n, t in jm.get_params().items()})
    return jm, tm


class _Spy:
    """An engine or tier that keeps the handles its submit returns."""

    def __init__(self, target):
        self.target = target
        self.handles = []

    def submit(self, *a, **kw):
        h = self.target.submit(*a, **kw)
        self.handles.append(h)
        return h

    def __getattr__(self, name):
        return getattr(self.target, name)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [{}, WORKLOAD,
                                dict(WORKLOAD, tenants=0),
                                dict(prompt_lens=(256, 384, 512),
                                     new_tokens=(32, 64), shared_len=256,
                                     vocab=32000)])
def test_build_workload_equals_the_reference(seed, kw):
    ref = jload.build_workload(24, 5.0, seed, **kw)
    got = tload.build_workload(24, 5.0, seed, **kw)
    assert len(got) == len(ref) == 24
    for g, r in zip(got, ref):
        assert (g.at_s, g.max_new, g.tenant) == (r.at_s, r.max_new, r.tenant)
        assert g.prompt.dtype == r.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, r.prompt)


def _generate(tm, prompts, n):
    return [list(map(int, tm.generate(p[None], max_new_tokens=n)
                     [0, p.size:])) for p in prompts]


def _check_run(tm, spy, wl, payload):
    assert payload["requests"] == payload["completed"] == len(wl)
    assert payload["shed"] == payload["rejected"] == 0
    assert [h.finish_reason for h in spy.handles] == ["length"] * len(wl)
    got = [list(map(int, h.tokens)) for h in spy.handles]
    assert got == [_generate(tm, [a.prompt], a.max_new)[0] for a in wl]


@pytest.fixture(scope="module")
def reference_payload(pair):
    jm, _ = pair
    eng = JEngine(jm, SLOTS, MAX_LEN, block_size=BS)
    return jload.run_load(eng, jload.build_workload(8, 200.0, 3, **WORKLOAD))


def test_run_load_on_an_engine(pair, reference_payload):
    _, tm = pair
    wl = tload.build_workload(8, 200.0, 3, **WORKLOAD)
    spy = _Spy(ServeEngine(tm, SLOTS, MAX_LEN, block_size=BS))
    payload = tload.run_load(spy, wl)
    _check_run(tm, spy, wl, payload)
    assert payload.keys() == reference_payload.keys()
    assert payload["detail"].keys() == reference_payload["detail"].keys()
    assert payload["model"] == reference_payload["model"] == "llama-d64-L2"
    assert payload["detail"]["prefix_hits"] > 0
    tschema.validate_serve_load_payload(
        {k: v for k, v in payload.items() if k != "detail"})


def test_run_load_on_a_tier(pair, reference_payload):
    _, tm = pair
    wl = tload.build_workload(8, 200.0, 4, **WORKLOAD)
    pw, dw = build_pools(tm, 1, 1, num_slots=SLOTS, max_len=MAX_LEN,
                         block_size=BS)
    spy = _Spy(Router(pw, dw))
    payload = tload.run_load(spy, wl, pass_tenant=True)
    _check_run(tm, spy, wl, payload)
    tier = ("prefill_workers", "decode_workers", "handoffs",
            "handoff_p99_ms")
    assert payload.keys() == (reference_payload.keys() - {"model"}) | \
        set(tier)
    assert (payload["prefill_workers"], payload["decode_workers"],
            payload["handoffs"]) == (1, 1, len(wl))
    assert {"reroutes", "worker_deaths", "handoff_p50_ms"} <= \
        payload["detail"].keys()
    spy.close()


def test_append_record_writes_a_valid_serve_load_entry(tmp_path):
    payload = {"requests": 4, "completed": 4, "shed": 0, "rejected": 1,
               "tokens_per_s": 12.5, "ttft_p50_ms": 3.0,
               "ttft_p99_ms": 9.0, "model": "llama-d64-L2",
               "detail": {"wall_s": 1.5, "retries": {"serve.decode": 1},
                          "prefix_hits": 2}}
    store = tmp_path / "records.jsonl"
    for prefix in ("load", "load"):
        assert tload.append_record(payload, str(store), prefix=prefix,
                                   device="cpu") == str(store)
    entries = [json.loads(line) for line in store.read_text().splitlines()]
    assert len(entries) == 2 and entries[0]["run_id"] != entries[1]["run_id"]
    for e in entries:
        tschema.validate_entry(e)
        assert (e["kind"], e["platform"], e["smoke"]) == \
            ("serve_load", "cpu", True)
        assert "retries" not in e["payload"]
        assert e["payload"]["wall_s"] == 1.5
        assert e["payload"]["prefix_hits"] == 2
    with pytest.raises(Exception):
        tload.append_record({"requests": 1, "detail": {}}, str(store),
                            device="cpu")


@pytest.mark.parametrize("spec", ["3:1,2:2,1:3", " 1:1 ", "2:1,1:2"])
def test_parse_ratios_equals_the_reference(spec):
    assert tload.parse_ratios(spec) == jload.parse_ratios(spec)


@pytest.mark.parametrize("spec", ["3-1", "0:1", "1:0", "a:b", "1:2:3"])
def test_parse_ratios_refuses_as_the_reference(spec):
    with pytest.raises(ValueError) as ref:
        jload.parse_ratios(spec)
    with pytest.raises(ValueError) as got:
        tload.parse_ratios(spec)
    assert str(got.value) == str(ref.value)


def test_cli_serves_and_records_on_the_cpu(tmp_path, capsys):
    store = tmp_path / "records.jsonl"
    assert tload.main(["--device", "cpu", "--requests", "6", "--rate",
                       "100", "--store", str(store)]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out)
    assert payload["completed"] == 6
    # the serve_load headline, then the run's perf_attr entry, as the
    # reference's CLI appends them whenever recording is on
    entry, attr = [json.loads(line)
                   for line in store.read_text().splitlines()]
    assert entry["kind"] == "serve_load" and entry["platform"] == "cpu"
    assert attr["kind"] == "perf_attr" and attr["platform"] == "cpu"
    tschema.validate_entry(attr)


def test_model_configs_keep_their_published_widths():
    mis = tload._model_config("mistral-w4096", layers=4)
    mix = tload._model_config("mixtral-8x7b", layers=2)
    assert (mis.dim, mis.num_heads, mis.num_kv_heads, mis.ffn_dim,
            mis.sliding_window, mis.num_layers, mis.rope_theta) == \
        (4096, 32, 8, 14336, 4096, 4, 10000.0)
    assert (mix.num_experts, mix.moe_top_k, mix.moe_capacity_factor,
            mix.num_layers, mix.rope_theta, mix.sliding_window) == \
        (8, 2, 4.0, 2, 1e6, 0)
    assert tload._model_config("base") == LlamaConfig.base()
    assert tload._model_config("tiny") == LlamaConfig.tiny()
    assert llama.PUBLISHED["mistral-w4096"].num_layers == 32
    assert llama.PUBLISHED["mixtral-8x7b"].num_layers == 32


# -- the rest of the load driver ---------------------------------------------

@pytest.mark.parametrize("smoke", ["disagg", "spec", "spill", "mp"])
def test_smokes_pass_on_the_cpu(smoke, capsys):
    """Each smoke holds its streams bitwise (against generate() and a
    single engine) on the tiny model, as the reference's smoke does."""
    assert getattr(tload, f"{smoke}_smoke")(device="cpu") == 0
    assert f"{smoke}-smoke: OK" in capsys.readouterr().out


def test_smoke_flags_run_their_smoke(monkeypatch):
    ran = []
    for name in ("disagg", "spec", "spill", "mp"):
        monkeypatch.setattr(tload, f"{name}_smoke",
                            lambda name=name, **kw: ran.append((name, kw))
                            or 0)
    for name in ("disagg", "spec", "spill", "mp"):
        assert tload.main([f"--{name}-smoke", "--device", "cpu",
                           "--config", "base", "--layers", "2"]) == 0
    assert ran == [(n, {"config": "base", "layers": 2, "device": "cpu"})
                   for n in ("disagg", "spec", "spill", "mp")]


#: argument sets the reference's CLI refuses (the last two after building
#: its model)
REFUSED = [
    ["--spec-k", "-1"],
    ["--kv-dtype", "int8", "--prefill-workers", "1",
     "--decode-workers", "1"],
    ["--spill-blocks", "8", "--ratio-sweep", "1:1"],
    ["--kv-dtype", "int8", "--spec-compare"],
    ["--spill-blocks", "4", "--procs"],
    ["--procs", "--spec-compare"],
    ["--procs"],
    ["--procs", "--prefill-workers", "1"],
    ["--procs", "--ratio-sweep", "1:1", "--tenant-quota", "2"],
    ["--elastic-max", "3"],
    ["--kv-dtype", "bf16"],
    ["--prefill-workers", "1"],
    ["--tenant-quota", "2"],
]


@pytest.mark.parametrize("argv", REFUSED, ids=[" ".join(a) for a in REFUSED])
def test_cli_refuses_as_the_reference(argv, capsys):
    with pytest.raises(SystemExit) as ref:
        jload.main(argv + ["--no-record"])
    ref_err = capsys.readouterr().err.strip().splitlines()[-1]
    with pytest.raises(SystemExit) as got:
        tload.main(argv + ["--no-record", "--device", "cpu"])
    got_err = capsys.readouterr().err.strip().splitlines()[-1]
    assert got.value.code == ref.value.code == 2
    assert got_err.split("error: ")[-1] == ref_err.split("error: ")[-1]


def _pair_args(**kw):
    import argparse
    base = dict(config="tiny", layers=None, device="cpu", seed=0,
                num_slots=4, block_size=8, spill_blocks=None,
                num_blocks=None, no_share=False, max_queue=None, spec_k=3,
                max_len=64, requests=6, rate=200.0, tenants=3,
                shared_prefix=16, deadline=30.0, prompt_lens="6,10",
                new_tokens="8")
    base.update(kw)
    return argparse.Namespace(**base)


def test_spec_compare_pair_records_as_the_reference(tmp_path):
    """The plain/spec pair: one serve_load record each, sharing a
    spec_pair_id, with the reference's payload keys; self-speculation
    accepts everything and pick_spec_k can read the pair."""
    from singa_tpu_torch.autotune import table as ttable
    from singa_tpu_torch.obs import record as trecord

    store = str(tmp_path / "pair.jsonl")
    rows = tload.spec_compare(_pair_args(), store, trials=1)
    ref = jload.spec_compare(_pair_args(), None, trials=1)
    assert ref == 0
    entries = trecord.RunRecord(store).entries()
    assert [e["payload"]["spec_k"] for e in entries] == [0, 3]
    assert len({e["payload"]["spec_pair_id"] for e in entries}) == 1
    for e in entries:
        tschema.validate_entry(e)
        assert e["payload"]["model"] == "llama-d64-L2"
        assert e["payload"]["completed"] == 6
    assert rows[1]["accept_rate"] == 1.0
    assert {"spec_pair_id", "spec_seq", "spec_k", "spec_trials"} <= \
        rows[0].keys()
    assert rows[1].keys() - rows[0].keys() == {"accept_rate",
                                               "tokens_per_dispatch"}
    picked = ttable.pick_spec_k(entries, "cpu", model="llama-d64-L2")
    win = rows[1]["tokens_per_s"] > rows[0]["tokens_per_s"]
    assert (picked is not None) == win


def test_cli_spec_int8_spill_and_perf_attr_on_the_cpu(tmp_path, capsys):
    """--spec-k, --kv-dtype int8 and --spill-blocks each serve every
    request; the records carry the reference's field groups (spec pair,
    the spill trio), and --perf-attr dumps a payload the port's schema
    accepts, the int8 arena's decode as its own program."""
    from singa_tpu_torch.obs import record as trecord

    store = tmp_path / "r.jsonl"
    dump = tmp_path / "attr.json"
    common = ["--device", "cpu", "--requests", "6", "--rate", "200",
              "--store", str(store)]
    assert tload.main(common + ["--spec-k", "2"]) == 0
    assert tload.main(common + ["--kv-dtype", "int8", "--perf-attr",
                                str(dump)]) == 0
    assert tload.main(common + ["--spill-blocks", "32", "--num-blocks",
                                "24"]) == 0
    capsys.readouterr()
    loads = [e["payload"] for e in trecord.RunRecord(str(store)).entries()
             if e["kind"] == "serve_load"]
    assert [p["completed"] for p in loads] == [6, 6, 6]
    assert loads[0]["accept_rate"] == 1.0 and "tokens_per_dispatch" in \
        loads[0]
    assert {"spilled_blocks", "prefetch_hits", "prefetch_wait_ms"} <= \
        loads[2].keys()
    payload = json.loads(dump.read_text())
    tschema.validate_perf_attr_payload(payload)
    assert set(payload["programs"]) == {"prefill_chunk", "decode_int8"}
    assert 0.0 < payload["attributed_frac"] <= 1.0
    for row in payload["programs"].values():
        assert row["modeled_flops"] > 0 and row["modeled_hbm_bytes"] > 0


def test_tier_with_a_tenant_quota_on_the_cpu(tmp_path, capsys):
    store = tmp_path / "r.jsonl"
    assert tload.main(["--device", "cpu", "--requests", "8", "--rate",
                       "500", "--prefill-workers", "1", "--decode-workers",
                       "1", "--tenant-quota", "1", "--store",
                       str(store)]) == 0
    payload = json.loads(capsys.readouterr().out.split("\n}\n")[0] + "}")
    assert payload["prefill_workers"] == payload["decode_workers"] == 1
    assert payload["completed"] + payload["rejected"] + payload["shed"] \
        + payload["detail"]["router_faults"] <= 8
    assert payload["rejected"] >= 1          # the quota refused someone


@pytest.mark.slow
def test_process_tier_cli_and_mp_ratio_sweep(tmp_path):
    """--procs with an elastic policy, and the mp ratio sweep: records
    carry the transport trio and the process provenance (the reference
    marks its mp sweep slow too)."""
    from singa_tpu_torch.obs import record as trecord

    store = tmp_path / "r.jsonl"
    common = ["--device", "cpu", "--requests", "8", "--rate", "60",
              "--store", str(store)]
    assert tload.main(common + ["--procs", "--prefill-workers", "1",
                                "--decode-workers", "1", "--elastic-max",
                                "3"]) == 0
    assert tload.main(common + ["--procs", "--ratio-sweep", "1:1,1:2"]) == 0
    loads = [e["payload"] for e in trecord.RunRecord(str(store)).entries()
             if e["kind"] == "serve_load"]
    assert len(loads) == 3
    for p in loads:
        tschema.validate_serve_load_payload(p)
        assert p["completed"] == 8 and p["handoff_wire_bytes"] > 0
        assert p["model"] == "llama-d64-L2" and p["host_cores"] >= 1
    assert [p["procs"] for p in loads] == [2, 2, 3]
    assert len({p["mp_sweep_id"] for p in loads[1:]}) == 1
