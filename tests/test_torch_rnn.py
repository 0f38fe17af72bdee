"""The port's recurrent layers, their ONNX export and the char-rnn
trainer, and the vision layers SeparableConv2d, SiLU and LeakyReLU,
against the JAX package's, on the CPU in f32.

Weights are carried from each reference layer or model into the port's
by name (``load_reference_states``); inputs come from numpy seeds.
Covered: ``layer.RNN`` / ``LSTM`` outputs and their gradients with
respect to the input and every weight; the reference's
``TestRecurrentExport`` net (Embedding → LSTM → RNN → Linear) exported
by the port as real ``LSTM`` and ``RNN`` nodes and read back, and the
reference's export of the same weights read by the port; the tiny
char-rnn's loss trajectory against the reference example's
``CharRNN``; the trainer's command line; the vision layers' outputs and
gradients.

Tolerances (f32 on both sides; the recurrence hoists the input product
out of the loop where the reference adds it step by step, so sums are
ordered differently): outputs and gradients within rtol 1e-5, atol
1e-5; an export read back within 1e-5 of its native model; four Adam
steps of the char-rnn within rtol 1e-4 in every loss."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch.models import load_reference_states
from singa_tpu_torch.tools import train_rnn

RTOL = ATOL = 1e-5
EXPORT_TOL = 1e-5
LOSS_RTOL = 1e-4
CPU = tdevice.create_device("cpu")
ROOT = Path(__file__).resolve().parent.parent
# the tiny char-rnn: (hidden, embed, layers, seqlen, batch, Adam steps)
TINY = dict(hidden=16, embed=8, num_layers=2)
SEQ, BATCH, STEPS = 8, 4, 4


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _states(jl):
    return {n: np.asarray(t.data) for n, t in jl.get_states().items()}


def _ref_run(jl, x, dy):
    """A reference layer's output on `x` (built there by this first
    call) and the gradients of <output, dy> by name, with "x" the
    input's."""
    jautograd.set_training(False)
    jl(jtensor.from_numpy(x))
    jautograd.set_training(True)
    xt = jtensor.Tensor(data=jnp.asarray(x), requires_grad=True,
                        stores_grad=True)
    y = jl(xt)
    grads = {id(p): np.asarray(g.data) for p, g in jautograd.backward(
        y, jnp.asarray(dy))}
    named = {n: grads[id(t)] for n, t in jl.get_params().items()}
    named["x"] = grads[id(xt)]
    jautograd.set_training(False)
    return np.asarray(y.data), named


def _port_run(tl, x, dy):
    tautograd.set_training(True)
    xt = torch.tensor(x, requires_grad=True)
    y = tl(xt)
    params = tl.get_params()
    grads = torch.autograd.grad(y, [xt, *params.values()],
                                torch.from_numpy(dy))
    named = dict(zip(params, (g.numpy() for g in grads[1:])))
    named["x"] = grads[0].numpy()
    return y.detach().numpy(), named


def _parity(jl, tl, x):
    want = jl(jtensor.from_numpy(x))    # builds the reference's params
    dy = _r(*want.shape, seed=9)
    load_reference_states(tl, _states(jl))
    (ry, rg), (y, g) = _ref_run(jl, x, dy), _port_run(tl, x, dy)
    np.testing.assert_allclose(y, ry, rtol=RTOL, atol=ATOL)
    assert sorted(g) == sorted(rg)
    for n in rg:
        np.testing.assert_allclose(g[n], rg[n], rtol=RTOL, atol=ATOL,
                                   err_msg=n)


# -- the recurrent layers -------------------------------------------------------

@pytest.mark.parametrize("kind", ["RNN", "LSTM"])
def test_recurrent_layer_matches_reference(kind):
    jtensor.set_seed(1)
    H, D = 6, 5
    x = _r(3, 7, D)
    jl = getattr(jlayer, kind)(H)
    tl = getattr(tlayer, kind)(H, D, device=CPU,
                               generator=torch.Generator().manual_seed(0))
    g = 4 if kind == "LSTM" else 1
    assert {n: tuple(p.shape) for n, p in tl.get_params().items()} == {
        "Wx": (D, g * H), "Wh": (H, g * H), "b": (g * H,)}
    assert not tl.b.any()
    _parity(jl, tl, x)


# -- ONNX: the reference's TestRecurrentExport net ------------------------------

class _TNet(tmodel.Model):
    def __init__(self):
        super().__init__(device=CPU)
        g = torch.Generator().manual_seed(0)
        kw = dict(device=CPU, generator=g)
        self.emb = tlayer.Embedding(37, 16, **kw)
        self.lstm = tlayer.LSTM(24, 16, **kw)
        self.rnn = tlayer.RNN(20, 24, **kw)
        self.head = tlayer.Linear(5, 20, **kw)

    def forward(self, ids):
        x = self.rnn(self.lstm(self.emb(ids)))
        B, T, H = x.shape
        return self.head(x.reshape(B * T, H))


def _jnet():
    class Net(jmodel.Model):
        def __init__(self):
            super().__init__()
            self.emb = jlayer.Embedding(37, 16)
            self.lstm = jlayer.LSTM(24)
            self.rnn = jlayer.RNN(20)
            self.head = jlayer.Linear(5)

        def forward(self, ids):
            x = self.rnn(self.lstm(self.emb(ids)))
            B, T, H = x.shape
            return self.head(x.reshape((B * T, H)))
    return Net()


@pytest.fixture(scope="module")
def recurrent_net():
    """The reference's net from seed 0 (weights by name, eval output on
    `ids`, its ONNX export) and the ids (3, 9)."""
    ids = np.random.RandomState(0).randint(0, 37, (3, 9)).astype(np.int32)
    jtensor.set_seed(0)
    jm = _jnet()
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    jm.eval()
    out = np.asarray(jm(jtensor.from_numpy(ids)).data)
    data = jsonnx.to_onnx(jm, [jtensor.from_numpy(ids)]).SerializeToString()
    return {"ids": ids, "arrays": _states(jm), "out": out, "onnx": data}


def _tnet(recurrent_net):
    m = _TNet()
    load_reference_states(m, recurrent_net["arrays"])
    m.eval()
    return m


def test_recurrent_net_matches_reference(recurrent_net):
    m = _tnet(recurrent_net)
    with torch.no_grad():
        out = m(torch.from_numpy(recurrent_net["ids"])).numpy()
    np.testing.assert_allclose(out, recurrent_net["out"], rtol=RTOL,
                               atol=ATOL)


def test_port_export_holds_lstm_and_rnn_nodes_and_round_trips(
        recurrent_net):
    m = _tnet(recurrent_net)
    ids = torch.from_numpy(recurrent_net["ids"])
    with torch.no_grad():
        want = m(ids).numpy()
    proto = tsonnx.to_onnx(m, [ids])
    ops = [n.op_type for n in proto.graph.node]
    assert ops.count("LSTM") == 1 and ops.count("RNN") == 1, ops
    data = proto.SerializeToString()
    tsonnx.check_model(tsonnx.load_model_from_string(data))
    (got,) = tsonnx.prepare(data, device=CPU).run([recurrent_net["ids"]])
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=EXPORT_TOL,
                               atol=EXPORT_TOL)
    # and the reference's backend reads the port's export alike
    (jgot,) = jsonnx.prepare(data).run(
        [jtensor.from_numpy(recurrent_net["ids"])])
    np.testing.assert_allclose(np.asarray(jgot.data), want,
                               rtol=EXPORT_TOL, atol=EXPORT_TOL)


def test_reference_export_imports_into_the_port(recurrent_net):
    (got,) = tsonnx.prepare(recurrent_net["onnx"], device=CPU).run(
        [recurrent_net["ids"]])
    np.testing.assert_allclose(got.detach().numpy(), recurrent_net["out"],
                               rtol=EXPORT_TOL, atol=EXPORT_TOL)


# -- the char-rnn -----------------------------------------------------------------

def _ref_example():
    spec = importlib.util.spec_from_file_location(
        "_ref_char_rnn", ROOT / "examples" / "rnn" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_char_rnn_losses_follow_the_reference_example():
    ref = _ref_example()
    assert train_rnn.CORPUS == ref._CORPUS
    chars = sorted(set(train_rnn.CORPUS))
    data = np.asarray([chars.index(c) for c in train_rnn.CORPUS], np.int32)
    rng = np.random.RandomState(0)
    batches = [train_rnn.batches(data, BATCH, SEQ, rng)
               for _ in range(STEPS + 1)]
    jtensor.set_seed(0)
    jm = ref.CharRNN(len(chars), **TINY)
    jm.set_optimizer(jopt.Adam(lr=3e-3))
    jm.compile([jtensor.from_numpy(batches[0][0])], is_train=True,
               use_graph=True)
    arrays = _states(jm)
    jl = [float(np.asarray(jm.train_step(jtensor.from_numpy(x),
                                         jtensor.from_numpy(y))[1].data))
          for x, y in batches[1:]]
    tm = train_rnn.CharRNN(len(chars), device=CPU, **TINY)
    assert list(tm.get_params()) == list(arrays)
    load_reference_states(tm, arrays)
    tm.set_optimizer(topt.Adam(lr=3e-3))
    tm.compile([batches[0][0]], is_train=True, use_graph=True)
    tl = [tm.train_step(x, y)[1].item() for x, y in batches[1:]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]


def test_train_rnn_command_line_trains_on_the_cpu():
    out = train_rnn.main(["--device", "cpu", "--steps", "12", "--hidden",
                          "16", "--layers", "1", "--seqlen", "16",
                          "--batch-size", "8", "--sample", "5"])
    assert out["device"] == "cpu" and len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]
    assert out["chars_per_s"] > 0 and len(out["sample"]) == 32 + 5
    assert not out["train_captured"]          # no CUDA graph on the CPU


# -- the vision layers ------------------------------------------------------------

@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
def test_separable_conv2d_matches_reference(data_format):
    jtensor.set_seed(2)
    x = _r(2, 6, 6, 4, seed=3)
    if data_format == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    jl = jlayer.SeparableConv2d(5, 3, padding=1, bias=True,
                                data_format=data_format)
    tl = tlayer.SeparableConv2d(5, 3, 4, padding=1, bias=True,
                                data_format=data_format, device=CPU)
    assert tl.depthwise.groups == 4
    assert {n: tuple(p.shape) for n, p in tl.get_params().items()} == {
        "depthwise.W": (3, 3, 1, 4), "depthwise.b": (4,),
        "pointwise.W": (1, 1, 4, 5), "pointwise.b": (5,)}
    _parity(jl, tl, x)


def test_separable_conv2d_builds_at_its_first_call():
    tl = tlayer.SeparableConv2d(5, 3, device=CPU)
    assert tl.get_params() == {}
    y = tl(torch.zeros(1, 4, 4, 3))
    assert y.shape == (1, 2, 2, 5) and tl.depthwise.groups == 3
    assert list(tl.get_params()) == ["depthwise.W", "pointwise.W"]


@pytest.mark.parametrize("name,args", [("SiLU", ()), ("LeakyReLU", ()),
                                       ("LeakyReLU", (0.2,))])
def test_activation_layers_match_reference(name, args):
    x = _r(3, 4, seed=5)
    x[0, :2] = 0.0
    _parity(getattr(jlayer, name)(*args), getattr(tlayer, name)(*args), x)
