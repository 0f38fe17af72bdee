"""The port's record-driven autotuner (singa_tpu_torch.autotune and its
CLI singa_tpu_torch.tools.autotune) against the JAX package's
(singa_tpu.autotune), on the CPU: the knob registry equal, the
predictor's fit, leave-one-out report and argbest equal to 1e-12 on the
same numpy-seeded points, the table's validation, resolution and
spec_k pick giving the reference's answers on the reference's own
committed table and records (read as files), the sweep records the
port's schema accepts, and the consumers (engine, load driver, elastic
policy) resolving through a table given by SINGA_AUTOTUNE_TABLE."""

import argparse
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import tensor as jtensor
from singa_tpu.autotune import knobs as jknobs
from singa_tpu.autotune import predictor as jpred
from singa_tpu.autotune import sweep as jsweep
from singa_tpu.autotune import table as jtable
from singa_tpu.serve import ServeEngine as JEngine
from singa_tpu_torch import autotune as tat
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import graph as tgraph
from singa_tpu_torch.autotune import knobs as tknobs
from singa_tpu_torch.autotune import predictor as tpred
from singa_tpu_torch.autotune import sweep as tsweep
from singa_tpu_torch.autotune import table as ttable
from singa_tpu_torch.models import Llama, LlamaConfig
from singa_tpu_torch.obs import cost as tcost
from singa_tpu_torch.obs import record as trecord
from singa_tpu_torch.obs import schema as tschema
from singa_tpu_torch.serve import ServeEngine
from singa_tpu_torch.serve.net import elastic as telastic
from singa_tpu_torch.tools import autotune as tcli
from singa_tpu_torch.tools import loadgen as tload
from tools import loadgen as jload

REPO = Path(__file__).resolve().parent.parent
#: the reference's committed table and record store, read as files
REF_TABLE = REPO / "tools" / "autotune" / "data" / "best.json"
REF_STORE = REPO / "runs" / "records.jsonl"
TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Each test starts with the warn-once registries empty and the
    port's models on the CPU."""
    monkeypatch.setattr(ttable, "_WARNED", set())
    monkeypatch.setattr(jtable, "_WARNED", set())
    tdevice.set_default_device(tdevice.create_device("cpu"))
    yield
    tdevice.set_default_device(None)


@pytest.fixture(scope="module")
def tiny():
    """(JAX tiny model, port tiny model): model_key and engines."""
    jtensor.set_seed(0)
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    jm.eval()
    jm.compile([jtensor.from_numpy(np.zeros((1, 4), np.int32))],
               is_train=False, use_graph=False)
    tm = Llama(LlamaConfig.tiny(), device=tdevice.create_device("cpu"))
    return jm, tm


# -- the knob registry --------------------------------------------------------

def test_knob_registry_equals_the_reference():
    assert tknobs.KNOBS == jknobs.KNOBS
    assert tknobs.DEFAULTS == jknobs.DEFAULTS
    assert tknobs.OBJECTIVES == jknobs.OBJECTIVES
    assert tat.__all__ == __import__("singa_tpu.autotune",
                                     fromlist=["x"]).__all__


@pytest.mark.parametrize("domain,knobs", [
    ("serve", {"num_slots": 8, "block_size": 16}),
    ("serve", {"num_slot": 8}),
    ("serve", {"spec_k": True}),
    ("serve", {}),
    ("serve", None),
    ("train", {"batch": 2.0, "int8_ring": 1, "ce_chunk": "16"}),
    ("eval", {"batch": 2}),
])
def test_validate_knobs_answers_as_the_reference(domain, knobs):
    assert tknobs.validate_knobs(domain, knobs, "c") == \
        jknobs.validate_knobs(domain, knobs, "c")


@pytest.mark.parametrize("grid", [
    {"num_slots": [4, 8, 12], "block_size": [4, 8]},
    {"spec_k": [0, 3], "num_slots": [2], "block_size": [16, 32]},
    {"batch": [2, 4], "ce_chunk": [16, 64], "int8_ring": [0, 1]},
])
def test_grid_points_equal_the_reference(grid):
    domain = "train" if "batch" in grid else "serve"
    assert tknobs.grid_points(domain, grid) == \
        jknobs.grid_points(domain, grid)


@pytest.mark.parametrize("domain,grid", [
    ("serve", {}), ("serve", {"num_slots": []}),
    ("serve", {"batch": [1]}), ("nope", {"batch": [1]})])
def test_grid_points_refuse_as_the_reference(domain, grid):
    with pytest.raises(jknobs.KnobError) as ref:
        jknobs.grid_points(domain, grid)
    with pytest.raises(tknobs.KnobError) as got:
        tknobs.grid_points(domain, grid)
    assert str(got.value) == str(ref.value)


# -- the predictor ------------------------------------------------------------

def _points(seed, n, features=True):
    """n serve points with numpy-seeded knobs, objective and features."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = {"knobs": {"num_slots": int(rng.choice([2, 4, 8, 16])),
                       "block_size": int(rng.choice([8, 16, 32])),
                       "spec_k": int(rng.choice([0, 3]))},
             "objective": float(rng.uniform(100.0, 5000.0))}
        if features:
            p["features"] = {"tick_flops": float(rng.uniform(1e6, 1e9)),
                             "graph_pool_bytes": float(
                                 rng.randint(0, 1 << 30)),
                             "constant": 7.0}
        out.append(p)
    return out


@pytest.mark.parametrize("seed,n,features", [(0, 6, True), (1, 12, True),
                                             (2, 9, False), (3, 2, True)])
def test_fit_and_loo_equal_the_reference(seed, n, features):
    pts = _points(seed, n, features)
    tp, trep = tpred.fit_points("serve", pts)
    jp, jrep = jpred.fit_points("serve", pts)
    assert trep.keys() == jrep.keys() and trep["n"] == jrep["n"] == n
    for k in ("loo_rel_err", "loo_rel_err_max"):
        assert abs(trep[k] - jrep[k]) <= TOL * max(1.0, abs(jrep[k]))
    assert (tp.knob_names, tp.feature_names) == \
        (jp.knob_names, jp.feature_names)
    np.testing.assert_allclose(tp._weights, jp._weights, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tp._mean, jp._mean, rtol=TOL)
    np.testing.assert_allclose(tp._scale, jp._scale, rtol=TOL)
    assert abs(tp._bias - jp._bias) <= TOL * abs(jp._bias)
    for q in _points(seed + 100, 4, features):
        a = tp.predict(q["knobs"], q.get("features"))
        b = jp.predict(q["knobs"], q.get("features"))
        assert abs(a - b) <= TOL * max(1.0, abs(b))
        assert tp.nearest(q["knobs"], q.get("features")) is \
            pts[jp.points.index(jp.nearest(q["knobs"], q.get("features")))]
    assert tpred.best_point("serve", pts) is jpred.best_point("serve", pts)
    train = [{"knobs": {"batch": b, "ce_chunk": 16, "int8_ring": 0},
              "objective": o} for b, o in ((2, 3.0), (4, 2.5), (8, 4.0))]
    assert tpred.best_point("train", train) is \
        jpred.best_point("train", train)


@pytest.mark.parametrize("bad", [
    [], [{"knobs": {"num_slots": 2}, "objective": 1.0},
         {"knobs": {"block_size": 2}, "objective": 1.0}],
    [{"knobs": {"num_slots": 2}, "objective": True}],
    [{"knobs": {"num_slotz": 2}, "objective": 1.0}]])
def test_predictor_refuses_as_the_reference(bad):
    with pytest.raises(ValueError) as ref:
        jpred.fit_points("serve", bad)
    with pytest.raises(ValueError) as got:
        tpred.fit_points("serve", bad)
    assert type(got.value).__name__ == type(ref.value).__name__
    if bad:
        assert str(got.value) == str(ref.value)


# -- the table ----------------------------------------------------------------

def _ref_doc():
    return json.loads(REF_TABLE.read_text())


def _ref_entries():
    return [json.loads(line) for line in REF_STORE.read_text().splitlines()
            if line.strip()]


def _mutations(doc):
    """The reference's table and broken variants of it."""
    yield doc
    yield {**doc, "configs": {}}
    yield {**doc, "configs": {"serve/llama": {}}}
    bad = json.loads(json.dumps(doc))
    key = sorted(bad["configs"])[0]
    bad["configs"][key]["knobs"]["num_slotz"] = 3
    bad["configs"][key]["objective"] = "fast"
    del bad["configs"][key]["sweep_id"]
    yield bad
    ev = json.loads(json.dumps(doc))
    for entry in ev["configs"].values():
        entry["spec_evidence"] = {"pair_id": "p"}
    yield ev
    yield [doc]


def test_validate_table_answers_as_the_reference():
    doc = _ref_doc()
    assert jtable.validate_table(doc) == ttable.validate_table(doc) == []
    for variant in _mutations(doc):
        assert ttable.validate_table(variant, "t") == \
            jtable.validate_table(variant, "t")
    ids = {e["run_id"] for e in _ref_entries()}
    assert ttable.validate_table(doc, "t", ids) == \
        jtable.validate_table(doc, "t", ids)
    for some in (set(), {"ghost"}):
        got = ttable.validate_table(doc, "t", some)
        assert got and got == jtable.validate_table(doc, "t", some)
    stale = {**doc, "schema_version": 0}
    (got,), (ref,) = (ttable.validate_table(stale),
                      jtable.validate_table(stale))
    assert "stale" in got and "stale" in ref


@pytest.mark.parametrize("explicit", [
    {}, {"num_slots": 3}, {"num_slots": None, "block_size": 4},
    {"spec_k": 0, "spill_blocks": 32}, {"pool_ratio": 0.25}])
def test_resolve_precedence_equals_the_reference(explicit):
    """flag > entry > default, on every entry of the reference's
    committed table and on a key it lacks."""
    path = str(REF_TABLE)
    keys = [k.split("/") for k in _ref_doc()["configs"]] + \
        [["serve", "llama-d2048-L2", "cuda"], ["train", "x", "cpu"]]
    for domain, model, platform in keys:
        got = ttable.resolve(domain, model, platform, explicit, path=path)
        assert got == jtable.resolve(domain, model, platform, explicit,
                                     path=path)
        if domain == "serve" and explicit.get("num_slots"):
            assert got["num_slots"] == explicit["num_slots"]
    assert ttable.best_knobs("serve", "llama-d64-L2", "cpu", path) == \
        jtable.best_knobs("serve", "llama-d64-L2", "cpu", path)


def test_missing_table_falls_back_loudly_once(tmp_path, capsys):
    missing = str(tmp_path / "none.json")
    r1 = ttable.resolve("serve", "llama-d64-L2", "cpu", {}, path=missing)
    r2 = ttable.resolve("serve", "llama-d64-L2", "cpu", {}, path=missing)
    assert r1 == r2 == tknobs.DEFAULTS["serve"]
    assert capsys.readouterr().err.count("no best-config table") == 1
    assert ttable.load_table(missing) is None
    with pytest.raises(FileNotFoundError):
        ttable.load_table(missing, required=True)


def test_pick_spec_k_answers_as_the_reference():
    """On the reference's committed store (its --spec-compare pairs)
    and on pairs made to win, lose, and belong to another model."""
    def entry(rid, pair, k, tps, tpd=None, model="llama-d64-L2"):
        p = {"spec_pair_id": pair, "spec_k": k, "tokens_per_s": tps,
             "model": model}
        if k:
            p["accept_rate"] = 1.0
            p["tokens_per_dispatch"] = tpd
        return {"kind": "serve_load", "platform": "cpu", "run_id": rid,
                "payload": p}

    made = [entry("p0", "A", 0, 100.0), entry("s3", "A", 3, 140.0, 3.5),
            entry("s7", "A", 7, 130.0, 6.8), entry("p1", "B", 0, 100.0),
            entry("s9", "B", 9, 90.0, 9.5),
            entry("p2", "C", 0, 50.0, model="other"),
            entry("s5", "C", 5, 99.0, 4.9, model="other")]
    for entries in (_ref_entries(), made, made[3:5], []):
        for platform in ("cpu", "cuda"):
            for model in (None, "llama-d64-L2", "llama-d256-L4", "other"):
                assert ttable.pick_spec_k(entries, platform, model) == \
                    jtable.pick_spec_k(entries, platform, model)
    assert ttable.pick_spec_k(made, "cpu", "llama-d64-L2")["spec_k"] == 3


def test_model_key_equals_the_reference(tiny):
    jm, tm = tiny
    assert ttable.model_key(tm) == jtable.model_key(jm) == "llama-d64-L2"
    assert ttable.model_key(object()) == jtable.model_key(object())
    assert ttable.platform_of(tm) == "cpu"


def test_update_table_rebuilds_over_a_stale_table(tmp_path, capsys):
    path = tmp_path / "best.json"
    path.write_text(json.dumps({**_ref_doc(), "schema_version": 0}))
    entry = {"knobs": {"num_slots": 4, "block_size": 8},
             "objective_name": "tokens_per_s", "objective": 1.0,
             "sweep_id": "s", "run_id": "r", "loo_rel_err": 0.5,
             "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    assert ttable.update_table("serve/llama-d64-L2/cuda", entry,
                               str(path)) == str(path)
    doc = ttable.load_table(str(path))
    assert list(doc["configs"]) == ["serve/llama-d64-L2/cuda"]
    assert doc["configs"]["serve/llama-d64-L2/cuda"] == entry
    assert "discarding invalid" in capsys.readouterr().err
    with pytest.raises(ValueError):
        ttable.update_table("serve/llama-d64-L2", entry, str(path))


def test_the_port_reads_its_own_table_by_default(monkeypatch):
    monkeypatch.delenv(ttable.ENV_TABLE, raising=False)
    path = Path(ttable.table_path())
    assert path == REPO / "singa_tpu_torch" / "autotune" / "data" / \
        "best.json"
    assert ttable.DEFAULT_TABLE == "singa_tpu_torch/autotune/data/best.json"
    doc = ttable.load_table()
    if doc is not None:
        assert all(k.endswith("/cuda") for k in doc["configs"])
        assert all(e.get("card") for e in doc["configs"].values())


# -- sweeps and records -------------------------------------------------------

def _measure(knobs):
    """A deterministic stand-in measurement."""
    obj = 100.0 * knobs["num_slots"] + 3.0 * knobs["block_size"]
    return obj, {"tick_flops": 2.0 * knobs["num_slots"]}


def test_sweep_records_equal_the_reference(tmp_path):
    grid = {"num_slots": [2, 4, 8], "block_size": [8, 16]}
    stores, groups = {}, {}
    for name, sweep, knobs in (("t", tsweep, tknobs), ("j", jsweep,
                                                        jknobs)):
        store = str(tmp_path / f"{name}.jsonl")
        sid, entries = sweep.run_sweep(
            "serve", "llama-d64-L2", knobs.grid_points("serve", grid),
            _measure, store, platform="cpu", device="cpu")
        stores[name] = store
        groups[name] = sweep.sweep_points_from_store(store, "serve")
        assert groups[name][0] == sid and groups[name][2] is None
    strip = ("sweep_id", "run_id")
    (_, tpts, _), (_, jpts, _) = groups["t"], groups["j"]
    assert [{k: v for k, v in p.items() if k not in strip} for p in tpts] \
        == [{k: v for k, v in p.items() if k not in strip} for p in jpts]
    _, rep = tpred.fit_points("serve", tpts)
    best = tpred.best_point("serve", tpts)
    tsweep.append_fit(stores["t"], domain="serve", model="llama-d64-L2",
                      platform="cpu", device="cpu", sweep_id=tpts[0][
                          "sweep_id"], best=best, report=rep)
    sid, pts, fit = tsweep.sweep_points_from_store(stores["t"], "serve")
    assert fit["point"] == tsweep.FIT_POINT and len(pts) == 6
    assert fit["knobs"] == {"num_slots": 8, "block_size": 16}
    rec = trecord.RunRecord(stores["t"])
    assert rec.validate() == []
    for e in rec.entries():
        tschema.validate_entry(e)
    assert tcli.check_errors(stores["t"], str(tmp_path / "no.json")) == []
    with pytest.raises(LookupError):
        tsweep.sweep_points_from_store(stores["t"], "train")
    with pytest.raises(LookupError):
        tsweep.sweep_points_from_store(stores["t"], "serve",
                                       sweep_id="nope")
    with pytest.raises(tknobs.KnobError):
        tsweep.run_sweep("serve", "m", [{"num_slotz": 1}], _measure,
                         stores["t"], platform="cpu", device="cpu")


def test_check_flags_a_table_citing_a_missing_run(tmp_path):
    store = str(tmp_path / "records.jsonl")
    _, entries = tsweep.run_sweep(
        "serve", "llama-d64-L2", [{"num_slots": 2, "block_size": 8}],
        _measure, store, platform="cuda", device="card")
    table = str(tmp_path / "best.json")
    doc = {"schema_version": 1, "configs": {"serve/llama-d64-L2/cuda": {
        "knobs": {"num_slots": 2}, "objective_name": "tokens_per_s",
        "objective": 1.0, "sweep_id": "s", "run_id": "ghost-run",
        "loo_rel_err": 1.0}}}
    Path(table).write_text(json.dumps(doc))
    errors = tcli.check_errors(store, table)
    assert any("ghost-run" in e and "does not exist" in e for e in errors)
    doc["configs"]["serve/llama-d64-L2/cuda"]["run_id"] = \
        entries[0]["run_id"]
    Path(table).write_text(json.dumps(doc))
    assert tcli.check_errors(store, table) == []


# -- consumers ----------------------------------------------------------------

def test_engine_resolves_spec_k_from_the_env_table(tiny, monkeypatch):
    """ServeEngine(draft_model=m, spec_k=None) takes the table's spec_k
    for (model, device) — the reference's committed table gives the
    tiny model spec_k 7 on the CPU, to both engines; an explicit spec_k
    wins, and a table advising no speculation falls back loudly."""
    jm, tm = tiny
    monkeypatch.setenv(ttable.ENV_TABLE, str(REF_TABLE))
    monkeypatch.setenv(jtable.ENV_TABLE, str(REF_TABLE))
    eng = ServeEngine(tm, 2, 64, block_size=8, draft_model=tm)
    ref = JEngine(jm, 2, 64, block_size=8, draft_model=jm)
    assert eng.spec_k == ref.spec_k == 7
    assert ServeEngine(tm, 2, 64, block_size=8, draft_model=tm,
                       spec_k=2).spec_k == 2
    assert ServeEngine(tm, 2, 64, block_size=8).spec_k == 0
    with pytest.raises(ValueError, match="BOTH draft_model"):
        ServeEngine(tm, 2, 64, block_size=8, draft_model=tm, spec_k=0)
    assert ttable.resolve_spec_k(tm, "cuda") == ttable.SPEC_K_FALLBACK


def test_load_driver_resolves_as_the_reference(tiny, monkeypatch):
    jm, tm = tiny
    monkeypatch.setenv(ttable.ENV_TABLE, str(REF_TABLE))
    monkeypatch.setenv(jtable.ENV_TABLE, str(REF_TABLE))
    for given in ({"num_slots": None, "block_size": None},
                  {"num_slots": 5, "block_size": 4},
                  {"num_slots": None, "block_size": 16,
                   "spill_blocks": 32}):
        ta, ja = (argparse.Namespace(**{"spill_blocks": None, **given})
                  for _ in range(2))
        assert tload._resolve_serve_knobs(ta, tm) == \
            jload._resolve_serve_knobs(ja, jm)
        assert vars(ta) == vars(ja)


def test_elastic_share_reads_the_table(tmp_path, monkeypatch, capsys):
    path = tmp_path / "best.json"
    monkeypatch.setenv(ttable.ENV_TABLE, str(path))
    assert telastic.target_decode_share("llama-d64-L2", "cpu") == 0.5
    assert "no best-config table" in capsys.readouterr().err
    doc = {"schema_version": 1, "configs": {"serve/llama-d64-L2/cpu": {
        "knobs": {"pool_ratio": 0.75}, "objective_name": "tokens_per_s",
        "objective": 1.0, "sweep_id": "s", "run_id": "r",
        "loo_rel_err": 0.1}}}
    path.write_text(json.dumps(doc))
    assert telastic.target_decode_share("llama-d64-L2", "cpu") == 0.75
    assert telastic.target_decode_share("llama-d64-L2", "cuda") == 0.5
    pol = telastic.ElasticPolicy()
    router = argparse.Namespace(model_key="llama-d64-L2",
                                fabric=argparse.Namespace(device="cpu"))
    assert pol.decode_share(router) == 0.75
    path.write_text("{not json")
    with pytest.raises(ValueError):
        telastic.target_decode_share("llama-d64-L2", "cpu")


# -- features -----------------------------------------------------------------

def test_recorder_counts_the_bytes_each_op_moves():
    a, b = torch.ones(8, 16), torch.ones(16, 4)

    def body():
        y = a @ b                          # reads 512 + 256 B, writes 128
        y.view(4, 8)                       # a view moves nothing
        return y.add_(1.0)                 # reads and writes 128 B

    _, g = tgraph.record("t", body)
    assert g.bytes_accessed() == 4 * (128 + 64 + 32) + 4 * (32 + 32)
    assert g.cost_analysis() == {"flops": 2 * 8 * 16 * 4,
                                 "bytes accessed": g.bytes_accessed()}


def test_engine_features_come_from_the_recorded_programs(tiny):
    _, tm = tiny
    eng = ServeEngine(tm, 2, 32, block_size=8, kv_dtype="int8")
    assert tcost.engine_features(eng) == {}
    eng.submit(np.arange(5, dtype=np.int32), max_new_tokens=3)
    eng.run_until_idle()
    feats = tcost.engine_features(eng)
    assert set(feats) == {"prefill_chunk", "decode_int8"}
    for row in feats.values():
        assert row["flops"] > 0 and row["hbm_bytes"] > 0
    assert feats["prefill_chunk"]["hbm_bytes"] == \
        eng._prefill.graph.bytes_accessed()
    with pytest.raises(RuntimeError, match="no in-process engine"):
        tcost.perf_attr_payload({}, argparse.Namespace(), 1.0)


# -- the CLI ------------------------------------------------------------------

def test_cli_smoke_fit_best_and_check_on_the_cpu(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setenv(ttable.ENV_TABLE, str(tmp_path / "best.json"))
    assert tcli.main(["smoke", "--device", "cpu"]) == 0
    assert "autotune smoke: OK" in capsys.readouterr().out
    store, table = tmp_path / "r.jsonl", tmp_path / "best.json"
    _, entries = tsweep.run_sweep(
        "train", "llama-d64-L1-dp1",
        tknobs.grid_points("train", {"batch": [2, 4], "ce_chunk": [16],
                                     "int8_ring": [0, 1]}),
        lambda k: (1.0 + k["batch"] + 5.0 * k["int8_ring"],
                   {"wire_bytes": 0.0}), str(store), platform="cuda",
        device="card")
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    assert tcli.main(["fit", "--domain", "train", "--store", str(store),
                      "--table", str(table), "--card", card,
                      "--update-best"]) == 0
    out = capsys.readouterr().out
    entry = json.loads(out)["train/llama-d64-L1-dp1/cuda"]
    assert entry["knobs"] == {"batch": 2, "ce_chunk": 16, "int8_ring": 0}
    assert entry["card"] == card and entry["run_id"] == entries[0]["run_id"]
    assert ttable.load_table(str(table))["configs"] == \
        {"train/llama-d64-L1-dp1/cuda": entry}
    assert tcli.main(["check", "--store", str(store), "--table",
                      str(table)]) == 0
    capsys.readouterr()
    assert tcli.main(["best", "--domain", "train", "--model",
                      "llama-d64-L1-dp1", "--table", str(table)]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "train/llama-d64-L1-dp1/cuda": {"batch": 2, "ce_chunk": 16,
                                        "int8_ring": 0}}
    assert tcli.main(["sweep", "--domain", "serve", "--grid",
                      "num_slots"]) == 1
    assert tcli.train_model_key("base", 2) == "llama-d2048-L2-dp1"


def test_cli_train_sweep_runs_distopt_on_a_group_of_one(tmp_path):
    """The train measure on the CPU: tiny cut to 1 layer, a gloo group
    of one made and torn down around the sweep, int8_ring and plain
    points, the captured step's features."""
    store = tmp_path / "r.jsonl"
    assert tcli.main(["sweep", "--domain", "train", "--device", "cpu",
                      "--store", str(store), "--steps", "1", "--grid",
                      "batch=2", "--grid", "ce_chunk=16", "--grid",
                      "int8_ring=0,1"]) == 0
    assert not torch.distributed.is_initialized()
    _, pts, _ = tsweep.sweep_points_from_store(str(store), "train")
    assert [p["knobs"]["int8_ring"] for p in pts] == [0, 1]
    for p in pts:
        assert p["model"] == "llama-d64-L1-dp1" and p["objective"] > 0
        assert p["features"]["flops"] > 0
        assert p["features"]["wire_bytes"] == 0.0       # a world of 1


def test_sweep_defaults_follow_the_device():
    """A sweep on the CPU runs the reference's grids; on the card it is
    the card sweep: base() cut to 2 layers, serve points under the load
    driver's chat traffic in an arena that holds its longest request,
    train points at T = 1024, keyed as the committed table is."""
    from tools import autotune as jcli
    for domain in ("serve", "train"):
        assert tcli.sweep_defaults("cpu", domain)["grid"] == \
            jcli._DEFAULT_GRIDS[domain]
    assert tcli.sweep_defaults("cpu", "train")["layers"] == 1
    card = tcli.sweep_defaults("cuda", "serve")
    wl = card["workload"]
    assert wl == tload.CHAT_WORKLOAD
    longest = wl["shared_len"] + max(wl["prompt_lens"]) + \
        max(wl["new_tokens"]) + max(card["grid"]["spec_k"]) + 1
    assert longest <= card["max_len"] <= LlamaConfig.base().max_position
    assert tcli.sweep_defaults("cuda", "train")["seq"] == 1024
    cfg = tload._model_config(card["config"], card["layers"])
    assert tcli.train_model_key(card["config"], card["layers"]) == \
        f"{ttable.arch_key('Llama', cfg)}-dp1" == "llama-d2048-L2-dp1"
    assert tcli.train_model_key("base", 2, world=4) == "llama-d2048-L2-dp4"
    doc = ttable.load_table(str(REPO / ttable.DEFAULT_TABLE))
    assert set(doc["configs"]) == {"serve/llama-d2048-L2/cuda",
                                   "train/llama-d2048-L2-dp1/cuda"}


def test_committed_table_cites_the_committed_sweep():
    """The committed table validates against the autotuner's committed
    store, and each entry is the measured best of its card sweep: its
    run is a cuda point of that sweep with the entry's knobs and
    objective, under the card sweep's grid."""
    store = str(REPO / tcli.STORE)
    table = str(REPO / ttable.DEFAULT_TABLE)
    assert tcli.check_errors(store, table) == []
    entries = trecord.RunRecord(store).entries()
    for key, entry in ttable.load_table(table)["configs"].items():
        domain = key.split("/")[0]
        pts = [e for e in entries if e["kind"] == "autotune_sweep"
               and e["payload"]["sweep_id"] == entry["sweep_id"]
               and e["payload"]["point"] >= 0]
        assert {e["platform"] for e in pts} == {"cuda"}
        grid = tcli.CARD_GRIDS[domain]
        assert len(pts) == int(np.prod([len(v) for v in grid.values()]))
        for name, vals in grid.items():
            assert {e["payload"]["knobs"][name] for e in pts} == set(vals)
        best = tpred.best_point(domain, [e["payload"] for e in pts])
        assert best["knobs"] == entry["knobs"]
        assert best["objective"] == entry["objective"]

