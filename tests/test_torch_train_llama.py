"""The port's Llama trainer (singa_tpu_torch.tools.train_llama) against the
JAX package's ``examples/llama/train.py``, run in this process (its
``main()`` under a patched ``sys.argv``, JAX on the CPU).

The reference's seed-0 parameters are read right after its ``compile``
and carried into the port's model (``build(..., params=)``), so both
train the same weights on the same ids.  Limits: each step's loss within
LOSS_ATOL (1e-4) of the reference's unrounded loss (tiny, f32, 3 steps);
generated tokens and planned bytes exactly."""

import argparse
import re
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import parallel as jparallel
from singa_tpu.model import Model as JModel
from singa_tpu.parallel import planner as jplanner
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch.tools import train_llama

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "examples" / "llama" / "train.py"
CPU = tdevice.create_device("cpu")
LOSS_ATOL = 1e-4
STEPS = ("--steps", "3")

# case: the flags both scripts take (tiny, 3 steps)
CASES = {
    "adamw": ("--opt", "adamw", "--generate", "8"),
    "adafactor": ("--opt", "adafactor"),
    "sgd": ("--opt", "sgd"),
    "fused_loss": ("--fused-loss",),
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


def run_reference(path, argv, monkeypatch, capsys):
    """A reference script's main() over `argv` in this process: its
    parameters right after its first compile, the unrounded loss of each
    train_step, and what it printed."""
    seen = {"params": None, "losses": []}
    compile_, train_step_ = JModel.compile, JModel.train_step

    def compile(self, *a, **k):
        out = compile_(self, *a, **k)
        if seen["params"] is None:
            seen["params"] = {n: np.asarray(t.data)
                              for n, t in self.get_params().items()}
        return out

    def train_step(self, *a, **k):
        out = train_step_(self, *a, **k)
        seen["losses"].append(float(np.asarray(out[1].data)))
        return out
    monkeypatch.setattr(JModel, "compile", compile)
    monkeypatch.setattr(JModel, "train_step", train_step)
    monkeypatch.setattr(sys, "argv", [str(path), *argv])
    capsys.readouterr()
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        monkeypatch.undo()
    seen["out"] = capsys.readouterr().out
    return seen


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_options_are_the_reference_parsers(monkeypatch):
    ref = options(reference_parser(REF, monkeypatch))
    port = options(train_llama.build_parser())
    assert set(ref) - {"--force-host-devices"} == set(port)
    for opt, (default, choices) in ref.items():
        if opt == "--device":
            assert choices == ["auto", "cpu", "tpu"]
            assert port[opt] == ("auto", ["auto", "cuda", "cpu"])
        elif opt != "--force-host-devices":
            assert port[opt] == (default, choices), opt


@pytest.mark.parametrize("argv,message", [
    (("--ep", "2"), "--ep needs --experts"),
    (("--window", "16", "--sp", "2"), "--window does not compose with --sp"),
    (("--experts", "3", "--ep", "2"), "--experts 3 must divide by --ep 2"),
])
def test_refusals_are_the_references(argv, message, monkeypatch, capsys):
    with pytest.raises(SystemExit) as ref:
        run_reference(REF, ("--device", "cpu", *argv), monkeypatch, capsys)
    ref_err = capsys.readouterr().err
    with pytest.raises(SystemExit) as port:
        train_llama.main(["--device", "cpu", *argv])
    port_err = capsys.readouterr().err
    assert ref.value.code == port.value.code == 2
    assert message in ref_err and message in port_err
    assert ref_err.splitlines()[-1].split(": error: ")[1] == \
        port_err.splitlines()[-1].split(": error: ")[1]


@pytest.fixture(scope="module")
def reference_runs():
    """Each case's reference run, made at its first use."""
    return {}


def _reference(case, reference_runs, monkeypatch, capsys):
    if case not in reference_runs:
        reference_runs[case] = run_reference(
            REF, ("--device", "cpu", *STEPS, *CASES[case]), monkeypatch,
            capsys)
    return reference_runs[case]


@pytest.mark.parametrize("case", list(CASES))
def test_losses_follow_the_reference(case, reference_runs, monkeypatch,
                                     capsys):
    ref = _reference(case, reference_runs, monkeypatch, capsys)
    args = train_llama.build_parser().parse_args(
        ["--device", "cpu", *STEPS, *CASES[case]])
    out = train_llama.run(args, CPU, params=ref["params"])
    printed = capsys.readouterr().out
    assert len(out["losses"]) == len(ref["losses"]) == 3
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=0,
                               atol=LOSS_ATOL)
    assert out["losses"][-1] < out["losses"][0]
    # the same lines in the same order: mesh, params (the reference
    # counts its lazy parameters before they exist: 0.0M), a line a step
    for prefix in ("mesh axes: {'data': 1}  devices: 1", "params: ",
                   "step 0: loss", "step 2: loss"):
        assert len(_lines(printed, prefix)) == len(
            _lines(ref["out"], prefix)) == 1, prefix
    assert [ln.split()[0] for ln in printed.splitlines()] == \
        [ln.split()[0] for ln in ref["out"].splitlines()]


def test_generate_gives_the_reference_tokens(reference_runs, monkeypatch,
                                             capsys):
    ref = _reference("adamw", reference_runs, monkeypatch, capsys)
    (line,) = _lines(ref["out"], "generated 8 tokens")
    want = [int(t) for t in re.findall(r"\d+", line.split(":", 1)[1])]
    args = train_llama.build_parser().parse_args(
        ["--device", "cpu", *STEPS, *CASES["adamw"]])
    out = train_llama.run(args, CPU, params=ref["params"])
    assert out["generated"] == want and len(want) == 8


@pytest.mark.parametrize("preset", ["tiny", "8b"])
def test_plan_gives_the_references_global_bytes(preset, capsys):
    cfg = {"tiny": jmodels.LlamaConfig.tiny,
           "8b": jmodels.LlamaConfig.llama3_8b}[preset]()
    ref = jplanner.plan_train_step(
        jmodels.Llama(cfg), jopt.AdamW(lr=3e-4),
        (jax.ShapeDtypeStruct((8, 128), jnp.int32),),
        mesh=jparallel.make_mesh({"data": 1}), lower=False)
    out = train_llama.main(["--preset", preset, "--plan"])
    printed = capsys.readouterr().out.splitlines()
    assert out["plan"]["param_bytes_global"] == ref.param_bytes_global
    assert [ln.split(":")[0] for ln in printed] == [
        "mesh axes", "params (global)", "params / device",
        "moments / device", "grads / device", "state / device",
        "fits h100 (75% HBM)", "fits h200 (75% HBM)"]
    # AdamW at a world of 1: 8B's 128 GB of state fit neither card
    assert out["fits"] == {"h100": preset == "tiny",
                           "h200": preset == "tiny"}


def test_zero1_plans_the_moments_over_the_data_axis():
    whole = train_llama.main(["--plan", "--dp", "4"])["plan"]
    cut = train_llama.main(["--plan", "--dp", "4", "--zero1"])["plan"]
    assert cut["param_bytes_per_device"] == whole["param_bytes_per_device"]
    assert 4 * cut["slot_bytes_per_device"] >= whole["slot_bytes_per_device"]
    assert cut["slot_bytes_per_device"] < whole["slot_bytes_per_device"]


def test_auto_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_llama.main(["--device", "auto", "--steps", "1"])


def test_a_train_step_frees_the_last_gradients_before_its_backward():
    """Each train_step drops the parameters' last gradients before its
    body runs, so a step never holds two gradient sets; after the step
    they are its own."""
    m = tmodels.Llama(tmodels.LlamaConfig.tiny(), device=CPU,
                      generator=torch.Generator().manual_seed(0))
    m.set_optimizer(topt.SGD(lr=0.1))
    body = m.train_one_batch
    at_entry = []

    def recorded(*a):
        at_entry.append([p.grad is None for p in m.get_params().values()])
        return body(*a)
    m.train_one_batch = recorded
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (2, 16)))
    m.compile([ids], is_train=True, use_graph=True)
    held = []
    for _ in range(3):
        m.train_step(ids)
        held.append([p.grad for p in m.get_params().values()])
    assert len(at_entry) == 3 and all(all(e) for e in at_entry)
    assert all(g is not None for g in held[-1])
    assert all(a is not b for a, b in zip(held[0], held[1]))
