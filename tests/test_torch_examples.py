"""The port's counterparts of the JAX package's example scripts
(singa_tpu_torch.tools.train_mlp, resume_demo, serve_demo, onnx_bert,
onnx_gpt2) against ``examples/mlp/train.py``,
``examples/mlp/resume_demo.py``, ``examples/llama/serve_demo.py`` and
``examples/onnx/{bert,gpt2}.py``, each reference run in this process
(its ``main()`` under a patched ``sys.argv``, JAX on the CPU) with its
seed-0 parameters carried into the port's model.

Limits: MLP_LOSS_ATOL (1e-4) on each MLP step's loss; RESUME_LOSS_ATOL
(1e-5) on the resume demo's final loss against the reference demo's
(both unrounded, 60 Adam steps); serving streams exactly; the ONNX round
trips within the scripts' own absolute 1e-2 (0 here on the CPU, where
import and native run the same f32 ops); the port's resumed run bitwise
its uninterrupted run."""

import argparse
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from singa_tpu import serve as jserve
from singa_tpu import train as jtrain
from singa_tpu.model import Model as JModel
from singa_tpu.utils import data as jdata
from singa_tpu.utils import metrics as jmetrics
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch.tools import (onnx_bert, onnx_gpt2, resume_demo,
                                   serve_demo, train_mlp)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = tdevice.create_device("cpu")
MLP_LOSS_ATOL = 1e-4
RESUME_LOSS_ATOL = 1e-5

# tool: (its reference script, the options the reference lacks)
TOOLS = {
    train_mlp: (EXAMPLES / "mlp" / "train.py", set()),
    resume_demo: (EXAMPLES / "mlp" / "resume_demo.py", {"--device"}),
    serve_demo: (EXAMPLES / "llama" / "serve_demo.py", {"--device"}),
    onnx_bert: (EXAMPLES / "onnx" / "bert.py", set()),
    onnx_gpt2: (EXAMPLES / "onnx" / "gpt2.py", set()),
}


class _Parsed(Exception):
    pass


def reference_parser(path, monkeypatch):
    """The ArgumentParser a reference script builds in its main()."""
    seen = {}

    def parse_args(self, *a, **k):
        seen["parser"] = self
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    monkeypatch.setattr(sys, "argv", [str(path)])
    with pytest.raises(_Parsed):
        runpy.run_path(str(path), run_name="__main__")
    monkeypatch.undo()
    return seen["parser"]


def options(parser):
    """{option string: (default, choices)} of a parser."""
    return {s: (a.default, a.choices) for a in parser._actions
            for s in a.option_strings if s not in ("-h", "--help")}


def run_reference(path, argv, monkeypatch, patches=()):
    """A reference script's main() over `argv` in this process, with
    `patches` ((object, name, wrap(original, seen)) each) in place: its
    parameters right after its first compile, and what the patches
    recorded in `seen`."""
    seen = {"params": None}
    compile_ = JModel.compile

    def compile(self, *a, **k):
        out = compile_(self, *a, **k)
        if seen["params"] is None:
            seen["params"] = {n: np.asarray(t.data)
                              for n, t in self.get_params().items()}
        return out
    monkeypatch.setattr(JModel, "compile", compile)
    for obj, name, wrap in patches:
        monkeypatch.setattr(obj, name, wrap(getattr(obj, name), seen))
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        monkeypatch.undo()
    return seen


@pytest.mark.parametrize("tool", list(TOOLS), ids=lambda t: t.__name__)
def test_options_are_the_reference_scripts(tool, monkeypatch):
    path, added = TOOLS[tool]
    ref = options(reference_parser(path, monkeypatch))
    port = options(tool.build_parser())
    assert set(port) == set(ref) | added
    for opt, (default, choices) in ref.items():
        if opt == "--device":
            assert choices == ["auto", "cpu", "tpu"]
        else:
            assert port[opt] == (default, choices), opt
    assert port["--device"] == ("auto", ["auto", "cuda", "cpu"])


@pytest.mark.parametrize("tool", list(TOOLS), ids=lambda t: t.__name__)
def test_auto_device_raises_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(["--device", "auto"])


def _recorded_means(orig, seen):
    def update(self, v, *a, **k):
        seen.setdefault("losses", []).append(float(v))
        return orig(self, v, *a, **k)
    return update


def _numpy_pipeline(orig, seen):
    return lambda: False


def test_train_mlp_follows_the_reference(monkeypatch, capsys):
    """The reference's loader takes its native pipeline where its C++
    library is built, whose shuffle is not numpy's; here it takes the
    numpy pipeline, as it does without the library, and as the port's
    loader does by default."""
    argv = ["--device", "cpu", "--epochs", "1", "--log-every", "8"]
    ref = run_reference(EXAMPLES / "mlp" / "train.py", argv, monkeypatch,
                        [(jmetrics.MeanMeter, "update", _recorded_means),
                         (jdata._core, "available", _numpy_pipeline)])
    ref_out = capsys.readouterr().out
    args = train_mlp.build_parser().parse_args(argv)
    args.model, args.seed = "mlp", 0
    m, data = train_mlp.build(args, CPU, params=ref["params"])
    out = train_mlp.train_classifier(m, args, *data)
    port_out = capsys.readouterr().out
    (ep,) = out["epochs"]
    np.testing.assert_allclose(ep["losses"], ref["losses"], rtol=0,
                               atol=MLP_LOSS_ATOL)
    assert len(ep["losses"]) == 2048 // 64
    assert ep["losses"][-1] < ep["losses"][0]
    assert [ln.split(" loss ")[0] for ln in port_out.splitlines()] == \
        [ln.split(" loss ")[0] for ln in ref_out.splitlines()]


def _recorded_steps(orig, seen):
    def init(self, *a, on_step=None, **k):
        def step(i, outs):
            seen.setdefault("losses", []).append(
                float(np.asarray(outs[1].data)))
            return on_step(i, outs)
        return orig(self, *a, on_step=step, **k)
    return init


def test_resume_demo_resumes_bitwise_and_follows_the_reference(
        tmp_path, monkeypatch, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    crash = subprocess.run(
        [sys.executable, "-m", "singa_tpu_torch.tools.resume_demo",
         "--device", "cpu", "--crash-at", "25"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert crash.returncode == 1, crash.stderr[-2000:]
    assert "simulating hard crash" in crash.stdout
    monkeypatch.chdir(tmp_path)
    resumed = resume_demo.main(["--device", "cpu"])
    whole = resume_demo.main(["--device", "cpu", "--ckpt-dir", "whole"])
    assert resumed["resumed_from"] >= 0 and whole["resumed_from"] == -1
    assert resumed["steps"] == whole["steps"] == 60
    n = len(resumed["losses"])
    assert resumed["losses"] == whole["losses"][-n:]
    assert resumed["final_loss"] == whole["final_loss"]
    printed = capsys.readouterr().out
    assert "python -m singa_tpu_torch.tools.ckpt_fsck ckpts_resume_demo" \
        in printed
    ref = run_reference(EXAMPLES / "mlp" / "resume_demo.py",
                        ["--ckpt-dir", str(tmp_path / "ref")], monkeypatch,
                        [(jtrain.TrainRunner, "__init__", _recorded_steps)])
    args = resume_demo.build_parser().parse_args(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path / "carried")])
    carried = resume_demo.run(args, *resume_demo.build(
        args, CPU, params=ref["params"]))
    assert len(ref["losses"]) == len(carried["losses"]) == 60
    assert abs(carried["final_loss"] - ref["losses"][-1]) <= RESUME_LOSS_ATOL
    assert carried["final_loss"] < carried["losses"][0]


def _recorded_handles(orig, seen):
    def submit(self, *a, **k):
        h = orig(self, *a, **k)
        seen.setdefault("handles", []).append(h)
        return h
    return submit


def test_serve_demo_streams_are_generate_and_the_references(monkeypatch,
                                                            capsys):
    ref = run_reference(EXAMPLES / "llama" / "serve_demo.py", [],
                        monkeypatch,
                        [(jserve.ServeEngine, "submit", _recorded_handles)])
    # the first request is the warm-up
    want = [list(map(int, h.tokens)) for h in ref["handles"][1:]]
    args = serve_demo.build_parser().parse_args(["--device", "cpu"])
    m = serve_demo.build(args, CPU, params=ref["params"])
    out = serve_demo.run(args, m)
    assert out["streams"] == want and len(want) == 10
    assert all(len(s) == args.new_tokens for s in out["streams"])
    for p, s in zip(out["prompts"], out["streams"]):
        gen = m.generate(p[None], max_new_tokens=args.new_tokens)
        assert gen[0, p.size:].tolist() == s
    assert out["captured"] == (0, 0) and out["compiled_counts"] == (1, 1)
    printed = capsys.readouterr().out
    assert "captured programs (prefill, decode): (0, 0)" in printed


def test_onnx_bert_round_trip_and_finetune():
    out = onnx_bert.main(["--device", "cpu", "--compile", "--finetune", "2"])
    assert out["max_abs_diff"] < onnx_bert.ROUND_TRIP_ATOL
    assert out["shape"] == [2, 64, 128] and out["nodes"] > 0
    assert np.isfinite(out["finetune_losses"]).all()
    assert out["finetune_losses"][1] < out["finetune_losses"][0]


def test_onnx_gpt2_round_trip_then_the_imported_graph_alone(tmp_path):
    out = onnx_gpt2.main(["--device", "cpu", "--steps", "4"])
    assert out["max_abs_diff"] < onnx_bert.ROUND_TRIP_ATOL
    assert out["generated"][:2] == out["checked_tokens"]
    # a file of the same export: no native weights, the graph re-run
    args = onnx_gpt2.build_parser().parse_args(["--device", "cpu"])
    dev = onnx_bert.onnx_device("cpu")
    native, prompt = onnx_gpt2.build(args, dev)
    ids = np.zeros((1, args.seq), np.int64)
    ids[0, :prompt.shape[1]] = prompt
    tsonnx.save(tsonnx.to_onnx(native, [torch.as_tensor(ids)]),
                str(tmp_path / "gpt2.onnx"))
    alone = onnx_gpt2.main(["--device", "cpu", "--steps", "4", "--onnx",
                            str(tmp_path / "gpt2.onnx")])
    assert alone["generated"] == out["generated"]
    assert "max_abs_diff" not in alone
