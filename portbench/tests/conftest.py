"""The benchmark's tests: the harness, its arithmetic and generators, the
reference against the program at a tiny size, and runs with faults
planted under the timed path.  CPU tests run anywhere; tests marked
``cuda`` skip inside their fixture without a card.

    python -m pytest portbench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DENSE = {"hidden_size": 64, "intermediate_size": 128,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "num_hidden_layers": 2, "vocab_size": 256,
              "max_position_embeddings": 512, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0, "sliding_window": 48}
TINY_MOE = dict(TINY_DENSE, sliding_window=None, num_local_experts=4,
                num_experts_per_tok=2,
                assumed={"moe_capacity_factor": 2.0, "moe_aux_weight": 0.01})
TINY_TRAIN = {"driver": "train", "batch": 2, "seq_len": 64,
              "optimizer": "adafactor_relative", "remat": True,
              "fused_loss": True, "distinct_batches": 8, "warm_steps": 1,
              "trace_seconds": 1}
# an open-loop chat mix at a tiny size: no cell of BENCHMARK.json runs
# the open loop yet, so its tiny cell has limits of its own (a widest
# logit gap over the served tokens, none unfinished)
TINY_CHAT = {"driver": "serve", "why": "tests", "loop": "open",
             "tokens_metric": "serve_tokens_per_s", "num_slots": 4,
             "max_len": 96, "block_size": 8, "share_prefix": True,
             "param_dtype": "bfloat16", "max_queue": 1024, "rate_rps": 20.0,
             "tenants": 8, "system_len": 16,
             "suffix": {"median": 12, "sigma": 0.8, "min": 4, "max": 40},
             "output": {"median": 8, "sigma": 0.7, "min": 2, "max": 24},
             "population_seed": 20261019, "warm_s": 1, "drain_s": 20,
             "sample_requests": 3, "trace_seconds": 4}
TINY_CHAT_LIMITS = {"numbers": {"logit_gap": {"limit": 0.3},
                                "unfinished": {"limit": 0}}}
# the cells the tiny ones stand for: theirs are the limits applied
STANDS_FOR = {"tiny-dense.tiny-train": "mistral-7b.train-8k",
              "tiny-moe.tiny-train": "mistral-7b.train-8k",
              "tiny-dense.tiny-chat": TINY_CHAT_LIMITS,
              "tiny-moe.tiny-batch": "mixtral-8x7b.serve-batch"}


def _tiny_mixes(bench: Path) -> dict:
    batch = json.loads((bench / "mixes" / "serve-batch.json").read_text())
    batch.update(num_slots=4, max_len=64, block_size=8, outstanding=8,
                 max_queue=8, pool=256, warm_s=1, drain_s=5,
                 sample_requests=3, prompt={"uniform": [8, 24]},
                 output={"median": 16, "sigma": 0.5, "min": 4, "max": 32})
    return {"tiny-train": TINY_TRAIN, "tiny-chat": TINY_CHAT,
            "tiny-batch": batch}


def make_tree(dst: Path) -> Path:
    """A checkout-like tree in `dst`: the benchmark's files and
    BENCHMARK.json, plus tiny cells added the way a later change adds
    cells (new files, new entries), each under the limits of the cell it
    stands for."""
    bench = dst / "portbench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in (("tiny-dense", TINY_DENSE), ("tiny-moe", TINY_MOE)):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"portbench/configs/{name}.json",
                                "reduced": [], "why": "tests"})
    for name, mix in _tiny_mixes(bench).items():
        (bench / "mixes" / f"{name}.json").write_text(json.dumps(mix))
    for cell, real in STANDS_FOR.items():
        c, t = cell.split(".")
        spec["workloads"].append({"name": cell, "config": c, "traffic": t,
                                  "chips": 1, "why": "tests"})
        lim = bench / "limits" / f"{cell}.json"
        if isinstance(real, dict):
            lim.write_text(json.dumps(real))
            real = "mixtral-8x7b.serve-batch"   # its metrics
        else:
            shutil.copy(bench / "limits" / f"{real}.json", lim)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dst


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    """Skips here without an NVIDIA card (decided inside the fixture)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
