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
    (entry,) = [json.loads(line) for line in store.read_text().splitlines()]
    assert entry["kind"] == "serve_load" and entry["platform"] == "cpu"


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
