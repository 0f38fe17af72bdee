"""The harness finds everything by name, a new cell runs with files and
entries added and no file edited, and nothing it runs imports JAX or
the JAX package."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import BENCH, ROOT, make_tree
from harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "singa_tpu", "singa"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert set(_imports(path)) <= {"__future__", "math", "typing",
                                       "torch"}, path


def test_every_cell_finds_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert (BENCH / "drivers" / f"{cell.driver}.py").exists()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        readers = spec.metric_readers(cell)
        assert all(hasattr(r, "read") for r in readers.values())


def test_a_new_cell_mix_config_and_metric_are_files(tmp_path):
    root = make_tree(tmp_path)
    before = {p: p.read_bytes() for p in (BENCH).rglob("*")
              if p.is_file() and "tests" not in p.parts
              and "__pycache__" not in p.parts}
    (root / "portbench" / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "host_clock",
                           "layer": "model step",
                           "moves": "train_samples_per_s",
                           "workloads": ["tiny-dense.tiny-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("tiny-dense.tiny-train", root)
    readers = spec.metric_readers(cell)
    assert "steps_seen" in readers and "train_mfu" in readers
    res = spec.driver(cell).run(cell, 2 ** 31 + 3, 2.5, True, "cpu",
                                readers, 0.0)
    assert res["per_layer"]["steps_seen"] == res["attempted"] > 0
    assert "train_mfu" in res["per_layer"]
    # a reader that finds nothing to read gives nothing: no trace of a card
    assert "device_idle_pct.train" not in res["per_layer"]
    after = {p: p.read_bytes() for p in before}
    assert before == after


def test_a_metric_finds_its_own_reader_else_its_familys(tmp_path):
    (tmp_path / "device_idle_pct.py").write_text("")
    (tmp_path / "device_idle_pct.odd.py").write_text("")
    assert spec.reader_path(tmp_path, "device_idle_pct.train").name == \
        "device_idle_pct.py"
    assert spec.reader_path(tmp_path, "device_idle_pct.odd").name == \
        "device_idle_pct.odd.py"


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    make_tree(tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tiny-dense.tiny-train", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "singa_tpu_torch_like", object())
    assert "singa_tpu_torch_like" not in spec.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in spec.forbidden_modules()
