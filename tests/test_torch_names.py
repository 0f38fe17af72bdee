"""Layer and model names, and the state methods' `prefix`, against the
JAX package's, on the CPU.

Held on the same trees in both packages (a `Sequential`, a tiny Llama, a
tiny GPT-2 and a ResNet `BasicBlock`):
- explicit names, and the automatic ones with their ``_1``, ``_2``
  suffixes (both packages' counters fresh for each test);
- the keys of `get_params`, `get_states`, `_get_buffers` under
  ``prefix=""`` and ``prefix="enc."``, and the `param_name` each
  parameter records against the reference's tensor ``.name``;
- `set_params` and `set_states` with a prefix: the prefixed keys load
  and the rest are ignored, the same arrays giving equal states in both;
- the ``model.train_step`` span's ``model`` and the step graph's name
  (``graph.execute`` and the captured graph), for an unnamed and a named
  tiny Llama, read from each package's obs events;
- the port's `TypeError` for a name that is not a str, so a device
  passed where `name` now stands fails at construction.
No tolerance: names and keys are compared exactly, state values
bitwise."""

import json

import numpy as np
import pytest
import torch

from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.obs import events as jevents
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch.models import resnet as tresnet
from singa_tpu_torch.obs import events as tevents

CPU = tdevice.create_device("cpu")
PREFIXES = ["", "enc."]
IDS = np.random.RandomState(0).randint(0, 256, (2, 8)).astype(np.int32)


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)


@pytest.fixture
def fresh(monkeypatch):
    """Both packages' automatic-name counters, empty for this test."""
    monkeypatch.setattr(jlayer, "_name_counter", {})
    monkeypatch.setattr(tlayer, "_name_counter", {})


def _seq():
    x = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    j = jlayer.Sequential(jlayer.Linear(8), jlayer.ReLU(), jlayer.Linear(4))
    j(jtensor.from_numpy(x))
    t = tlayer.Sequential(tlayer.Linear(8, 6, device=CPU), tlayer.ReLU(),
                          tlayer.Linear(4, 8, device=CPU))
    return j, t


def _compiled(jm):
    jm.compile([jtensor.from_numpy(IDS)], is_train=False, use_graph=False)
    return jm


def _llama():
    return (_compiled(jmodels.Llama(jmodels.LlamaConfig.tiny())),
            tmodels.Llama(tmodels.LlamaConfig.tiny(), device=CPU))


def _gpt2():
    return (_compiled(jmodels.GPT2(jmodels.GPT2Config.tiny())),
            tmodels.GPT2(tmodels.GPT2Config.tiny(), device=CPU))


def _block():
    x = np.random.RandomState(2).randn(1, 5, 5, 4).astype(np.float32)
    j = jresnet.BasicBlock(4)
    j(jtensor.from_numpy(x))
    return j, tresnet.BasicBlock(4, 4, device=CPU)


KINDS = {"sequential": _seq, "llama": _llama, "gpt2": _gpt2,
            "basicblock": _block}


@pytest.fixture(scope="module")
def trees():
    """(reference tree, port tree) of each kind, built once for the file;
    the load tests build trees of their own."""
    return {k: b() for k, b in KINDS.items()}


def _np(d):
    return {k: np.asarray(v.data if isinstance(v, jtensor.Tensor)
                          else v.detach().numpy()) for k, v in d.items()}


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("prefix", PREFIXES)
def test_state_keys_and_recorded_names_are_the_references(trees, kind,
                                                          prefix):
    j, t = trees[kind]
    for method in ("get_params", "get_states", "_get_buffers"):
        jkeys = sorted(getattr(j, method)(prefix))
        tkeys = sorted(getattr(t, method)(prefix))
        assert tkeys == jkeys, method
        assert all(k.startswith(prefix) for k in tkeys)
    jp, tp = j.get_params(prefix), t.get_params(prefix)
    assert {k: p.param_name for k, p in tp.items()} == \
        {k: p.name for k, p in jp.items()}
    assert all(p.param_name == k for k, p in tp.items())


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("method", ["set_params", "set_states"])
def test_prefixed_loads_take_their_keys_as_the_references(kind, method):
    j, t = KINDS[kind]()
    getter = "get_params" if method == "set_params" else "get_states"
    before = _np(getattr(t, getter)())
    new = {k: (v + 1 if v.dtype.kind == "f" else v)
           for k, v in _np(getattr(t, getter)("enc.")).items()}
    # keys without the prefix are not this tree's: nothing changes
    getattr(t, method)({k[4:]: v for k, v in new.items()}, prefix="enc.")
    unchanged = _np(getattr(t, getter)())
    for k, v in before.items():
        np.testing.assert_array_equal(unchanged[k], v)
    for tree in (j, t):
        getattr(tree, method)(new, prefix="enc.")
    tgot = _np(getattr(t, getter)("enc."))
    jgot = _np(getattr(j, getter)("enc."))
    assert sorted(tgot) == sorted(new) == sorted(jgot)
    for k, v in new.items():
        np.testing.assert_array_equal(tgot[k], v)
        np.testing.assert_array_equal(jgot[k], v)


def test_explicit_names_are_kept(fresh):
    for jl, tl in (
            (jlayer.Linear(4, name="fc"), tlayer.Linear(4, 3, name="fc")),
            (jlayer.ReLU(name="act"), tlayer.ReLU(name="act")),
            (jlayer.LSTM(4, name="rnn"),
             tlayer.LSTM(4, 3, name="rnn")),
            (jlayer.MoE(2, 8, name="moe"),
             tlayer.MoE(2, 8, dim=4, name="moe")),
            (jlayer.Sequential(name="trunk"), tlayer.Sequential(name="trunk")),
            (jresnet.BasicBlock(4, name="b0"),
             tresnet.BasicBlock(4, 4, name="b0")),
            (jmodel.Model(name="net"), tmodel.Model(name="net"))):
        assert tl.name == jl.name
    assert repr(jlayer.Linear(4, name="fc")) == "<Linear fc>"


def test_automatic_names_count_as_the_references(fresh):
    def build(L, M, linear, lstm, block):
        out = [linear(), linear(), L.ReLU(), linear(name="fc"), linear(),
               L.ReLU(), L.Sequential(), lstm(), L.Dropout(0.1),
               L.Remat(L.ReLU()), M.Model(), M.Model(), block()]
        return [x.name for x in out]
    jnames = build(jlayer, jmodel, lambda **kw: jlayer.Linear(4, **kw),
                   lambda: jlayer.LSTM(4), lambda: jresnet.BasicBlock(4))
    tnames = build(tlayer, tmodel, lambda **kw: tlayer.Linear(4, 3, **kw),
                   lambda: tlayer.LSTM(4, 3),
                   lambda: tresnet.BasicBlock(4, 4))
    assert tnames == jnames
    assert tnames[:5] == ["linear", "linear_1", "relu", "fc", "linear_2"]
    assert tnames[10:12] == ["model", "model_1"]


def test_a_name_that_is_not_a_str_raises():
    with pytest.raises(TypeError, match="name must be a str"):
        tlayer.Linear(10, 4, True, CPU)
    with pytest.raises(TypeError, match="name must be a str"):
        tmodel.Model(CPU)
    with pytest.raises(TypeError, match="name must be a str"):
        tlayer.ReLU(CPU)
    assert tlayer.Linear(10, 4, name="fc").name == "fc"


def _events(path):
    spans = [e for e in map(json.loads, open(path)) if e["kind"] == "span"]
    return ([e["model"] for e in spans if e["name"] == "model.train_step"],
            [e["graph"] for e in spans if e["name"] == "graph.execute"])


@pytest.mark.parametrize("name", [None, "m21"])
def test_train_step_span_and_graph_carry_the_models_name(fresh, tmp_path,
                                                         name):
    jm = jmodels.Llama(jmodels.LlamaConfig.tiny())
    tm = tmodels.Llama(tmodels.LlamaConfig.tiny(), device=CPU,
                       generator=torch.Generator().manual_seed(0))
    if name is not None:
        jm.name = tm.name = name
    assert tm.name == jm.name == (name or "llama")
    jm.set_optimizer(jopt.SGD(lr=0.01))
    jm.compile([jtensor.from_numpy(IDS)], is_train=True, use_graph=True)
    tm.set_optimizer(topt.SGD(lr=0.01))
    tm.compile([torch.from_numpy(IDS)], is_train=True, use_graph=True)
    got = {}
    for pkg, ev, run in (("j", jevents, lambda: jm.train_step(
            jtensor.from_numpy(IDS))), ("t", tevents, lambda: tm.train_step(
                torch.from_numpy(IDS)))):
        path = str(tmp_path / f"{pkg}.jsonl")
        ev.configure(path=path)
        try:
            for _ in range(2):
                run()
        finally:
            ev.configure()
        got[pkg] = _events(path)
    assert got["t"] == got["j"]
    want = name or "llama"
    assert got["t"] == ([want] * 2, [f"{want}.train"] * 2)
    assert tm.graph.name == jm.graph.name == f"{want}.train"
