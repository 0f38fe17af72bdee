"""What a run is, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``mixes/<traffic>.json``), the
driver that mix names (``drivers/<kind>.py``), the readers of its
per-layer metrics (``metrics/<name>.py``) and the limits of its
correctness check (``limits/<cell>.json``).  A later cell, mix, metric
or driver is a new file and a new entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
# modules a run may not hold: JAX, its libraries and the JAX package,
# compared by whole top-level name (the port's own name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "singa_tpu", "singa")


@dataclass
class Cell:
    name: str
    root: Path                  # the checkout: BENCHMARK.json's directory
    bench: dict                 # BENCHMARK.json
    workload: dict              # its entry under "workloads"
    config: dict                # the configuration file
    mix: dict                   # mixes/<traffic>.json
    limits: dict                # limits/<cell>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.mix["driver"]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: Path) -> Path:
    """The directory of the harness inside `root` (``paths``' first)."""
    return root / _read(root / "BENCHMARK.json")["paths"][0]


def load_cell(name: str, root: Path) -> Cell:
    root = Path(root)
    bench = _read(root / "BENCHMARK.json")
    here = root / bench["paths"][0]
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read(root / cfg_entry["file"])
    mix = _read(here / "mixes" / f"{w['traffic']}.json")
    lim_path = here / "limits" / f"{name}.json"
    limits = _read(lim_path) if lim_path.exists() else {}

    def mine(m):
        return name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per = [m for m in bench["per_layer"] if mine(m)]
    return Cell(name, root, bench, w, config, mix, limits, e2e, per)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file `path` as a module named `name` (file names may
    hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    return load_module(bench_dir(cell.root) / "drivers" / f"{cell.driver}.py",
                       f"portbench_driver_{cell.driver}")


def reader_path(here: Path, name: str) -> Path:
    """``metrics/<name>.py``, else the family's reader,
    ``metrics/<name before its first dot>.py``: one reader serves
    ``device_idle_pct.train`` and ``device_idle_pct.batch`` alike."""
    own = here / f"{name}.py"
    return own if own.exists() else here / f"{name.split('.', 1)[0]}.py"


def metric_readers(cell: Cell) -> Dict[str, ModuleType]:
    here = bench_dir(cell.root) / "metrics"
    return {m["name"]: load_module(reader_path(here, m["name"]),
                                   "portbench_metric_" + m["name"]
                                   .replace(".", "_").replace("-", "_"))
            for m in cell.per_layer}


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that `sys.modules` holds."""
    tops = {n.split(".", 1)[0] for n in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
