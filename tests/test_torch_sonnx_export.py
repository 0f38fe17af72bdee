"""The port's sonnx on whole models, on the CPU, against the JAX
package's and against torch: files written by torch's TorchScript
exporter, the reference's exports of its tiny BERT and GPT-2 imported
and trained by both packages, the port's own exporter read back by the
reference's backend, file IO, the device default and the shared
checkpoint format.

Tolerances (f32 on both sides; the packages differ in op order and
elementwise implementations only):
  * outputs of a file through both backends and torch: rtol 1e-4, atol
    1e-5 against torch (the reference's own test of these files), 1e-5
    between the two backends;
  * an import's forward logits in both packages: 1e-5 (rtol and atol);
    three SGD steps: every loss within 1e-5, every parameter after
    them within 1e-4;
  * the reference's import of a port export against the port's and the
    reference's native outputs: 1e-5 (1e-3 for the CNN, as the
    reference's own test allows);
  * a bf16 export read back against the bf16 native forward: 0.05, the
    reference's own bf16 bound."""

import io

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import model as jmodel
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu.models import transformer as jtr
from singa_tpu_torch import _unit
from singa_tpu_torch import autograd as tautograd
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tlayer
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch.sonnx import proto as tproto

CPU = tdevice.create_device("cpu")
TOL = 1e-5
TORCH_RTOL, TORCH_ATOL = 1e-4, 1e-5
PARAM_TOL = 1e-4
CNN_TOL = 1e-3
BF16_TOL = 0.05
STEPS = 3


@pytest.fixture(autouse=True)
def _port_cpu():
    tdevice.set_default_device(CPU)
    yield
    tdevice.set_default_device(None)
    tautograd.set_training(False)
    jautograd.set_training(False)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t):
    return t.detach().float().numpy()


def _both(data, inputs):
    """`data` through the reference's and the port's backend."""
    j = jsonnx.prepare(data).run([jtensor.from_numpy(a) for a in inputs])
    t = tsonnx.prepare(data, device=CPU).run(inputs)
    return [np.asarray(o.data) for o in j], [_np(o) for o in t]


# ---------------------------------------------------------------------------
# files from torch's TorchScript exporter (tests/test_sonnx_external.py)
# ---------------------------------------------------------------------------

def _torch_export_bytes(model, args, opset=14, fold=True) -> bytes:
    """Serialize via torch's TorchScript ONNX exporter; its one step
    that needs the `onnx` wheel splices onnxscript functions into the
    proto, which standard aten models have none of, so it is the
    identity here."""
    try:
        from torch.onnx._internal.torchscript_exporter import \
            onnx_proto_utils
    except ImportError:
        pytest.skip("torchscript exporter internals moved")
    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda b, custom_opsets: b
    try:
        buf = io.BytesIO()
        torch.onnx.export(model.eval(), args, buf, dynamo=False,
                          opset_version=opset, do_constant_folding=fold)
        return buf.getvalue()
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


class _TorchMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(16, 32)
        self.ln = torch.nn.LayerNorm(32)
        self.fc2 = torch.nn.Linear(32, 4)

    def forward(self, x):
        return self.fc2(torch.nn.functional.gelu(self.ln(self.fc1(x))))


class _TorchGPT2Block(torch.nn.Module):
    T = 12

    def __init__(self, vocab=97, dim=32, heads=4):
        super().__init__()
        self.heads, self.hd = heads, dim // heads
        self.wte = torch.nn.Embedding(vocab, dim)
        self.wpe = torch.nn.Embedding(self.T, dim)
        self.ln1 = torch.nn.LayerNorm(dim)
        self.qkv = torch.nn.Linear(dim, 3 * dim)
        self.proj = torch.nn.Linear(dim, dim)
        self.ln2 = torch.nn.LayerNorm(dim)
        self.fc1 = torch.nn.Linear(dim, 4 * dim)
        self.fc2 = torch.nn.Linear(4 * dim, dim)
        self.lnf = torch.nn.LayerNorm(dim)
        self.head = torch.nn.Linear(dim, vocab, bias=False)
        self.register_buffer("pos", torch.arange(self.T))
        self.register_buffer("causal", torch.tril(
            torch.ones(self.T, self.T, dtype=torch.bool)))

    def forward(self, ids):
        T, H, hd = self.T, self.heads, self.hd
        x = self.wte(ids) + self.wpe(self.pos)
        q, k, v = self.qkv(self.ln1(x)).chunk(3, dim=-1)
        q, k, v = (t.view(-1, T, H, hd).transpose(1, 2) for t in (q, k, v))
        att = (q @ k.transpose(-2, -1)) * (1.0 / hd ** 0.5)
        att = att.masked_fill(~self.causal, float("-inf"))
        y = (att.softmax(-1) @ v).transpose(1, 2).reshape(-1, T, H * hd)
        x = x + self.proj(y)
        x = x + self.fc2(torch.nn.functional.gelu(self.fc1(self.ln2(x))))
        return self.head(self.lnf(x))


class _TorchConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c1 = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.b1 = torch.nn.BatchNorm2d(8)
        self.c2 = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1)
        self.b2 = torch.nn.BatchNorm2d(16)
        self.pool = torch.nn.MaxPool2d(2)
        self.gap = torch.nn.AdaptiveAvgPool2d(1)
        self.fc = torch.nn.Linear(16, 5)

    def forward(self, x):
        x = torch.relu(self.b1(self.c1(x)))
        x = self.pool(torch.relu(self.b2(self.c2(x))))
        return self.fc(self.gap(x).flatten(1))


class _TorchRNN(torch.nn.Module):
    def __init__(self, kind, bidir):
        super().__init__()
        cls = {"LSTM": torch.nn.LSTM, "GRU": torch.nn.GRU,
               "RNN": torch.nn.RNN}[kind]
        self.rnn = cls(8, 12, bidirectional=bidir)

    def forward(self, x):
        return self.rnn(x)[0]


def _gen(seed):
    return torch.Generator().manual_seed(seed)


TORCH_FILES = {
    "mlp": (_TorchMLP, lambda: [torch.randn(3, 16, generator=_gen(1))],
            {"Gemm", "ReduceMean", "Erf"}),
    "gpt2_block": (_TorchGPT2Block,
                   lambda: [torch.randint(0, 97, (2, 12), generator=_gen(1))],
                   {"Gather", "MatMul", "Softmax", "Where", "Erf"}),
    "convnet": (_TorchConvNet,
                lambda: [torch.randn(2, 3, 16, 16, generator=_gen(1))],
                {"Conv", "BatchNormalization", "MaxPool",
                 "GlobalAveragePool"}),
    **{f"{k.lower()}_{'bi' if b else 'uni'}": (
        (lambda k=k, b=b: _TorchRNN(k, b)),
        lambda: [torch.randn(6, 3, 8, generator=_gen(1))], {k})
       for k in ("LSTM", "GRU", "RNN") for b in (False, True)},
}


@pytest.mark.parametrize("name", list(TORCH_FILES))
def test_torch_exported_file_imports_alike(name):
    make, inputs, ops = TORCH_FILES[name]
    torch.manual_seed(0)
    m = make()
    xs = inputs()
    data = _torch_export_bytes(m, tuple(xs), fold=name != "convnet")
    assert ops <= {n.op_type for n in
                   tsonnx.load_model_from_string(data).graph.node}
    with torch.no_grad():
        want = m(*xs).numpy()
    arrays = [x.numpy().astype(np.int32) if x.dtype == torch.int64
              else x.numpy() for x in xs]
    (j,), (t,) = _both(data, arrays)
    np.testing.assert_allclose(t, want, rtol=TORCH_RTOL, atol=TORCH_ATOL)
    _close(t, j)


def test_torch_exported_file_trains_on_the_port():
    """The torch MLP's float initializers train after import: the loss
    falls and the rep's parameters are its initializers."""
    torch.manual_seed(0)
    data = _torch_export_bytes(_TorchMLP(), (torch.randn(2, 16),))
    rep = tsonnx.prepare(data, device=CPU)
    rep.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    rng = np.random.RandomState(0)
    x = rng.randn(16, 16).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.int32)
    rep.compile([x], is_train=True, use_graph=True)
    losses = [float(rep.train_step(x, y)[1]) for _ in range(12)]
    assert losses[-1] < losses[0] * 0.9, losses
    assert len(rep.get_params()) == 6


# ---------------------------------------------------------------------------
# the reference's exports of its tiny BERT and GPT-2, in both packages
# ---------------------------------------------------------------------------

B, T = 2, 8


def _ids(vocab=256, seed=3):
    return np.random.RandomState(seed).randint(0, vocab, (B, T)).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref_exports():
    """The reference tiny BERT (2 labels) and GPT-2 in eval, their
    exports' bytes, native outputs and parameters by name."""
    out = {}
    for seed, name, make in (
            (0, "gpt2", lambda: jtr.GPT2(jtr.GPT2Config.tiny())),
            (1, "bert", lambda: jtr.BERT(jtr.BERTConfig.tiny(num_labels=2)))):
        jtensor.set_seed(seed)
        jm = make()
        x = jtensor.from_numpy(_ids())
        jm.compile([x], is_train=False, use_graph=False)
        jm.eval()
        native = np.asarray(jm(x).data)
        out[name] = dict(
            model=jm, data=jsonnx.to_onnx(jm, [x]).SerializeToString(),
            native=native,
            params={n: np.asarray(t.data) for n, t in
                    jm.get_params().items()})
    return out


def _lm_loss_j(out, y):
    b, t, v = out.shape
    return jautograd.softmax_cross_entropy(
        jautograd.reshape(out, (b * t, v)), y)


def _lm_loss_t(out, y):
    b, t, v = out.shape
    return tautograd.softmax_cross_entropy(out.reshape(b * t, v), y)


@pytest.mark.parametrize("name", ["bert", "gpt2"])
def test_reference_export_imports_alike(ref_exports, name):
    r = ref_exports[name]
    (j,), (t,) = _both(r["data"], [_ids()])
    _close(t, j)
    _close(t, r["native"])


@pytest.mark.parametrize("name", ["bert", "gpt2"])
def test_reference_export_trains_alike(ref_exports, name):
    """Three SGD steps of each package's import of the same bytes."""
    r = ref_exports[name]
    ids = _ids()
    if name == "gpt2":
        y = np.roll(ids, -1, axis=1).reshape(-1).astype(np.int32)
        jl, tl = _lm_loss_j, _lm_loss_t
    else:
        y = np.array([0, 1], np.int32)
        jl = jautograd.softmax_cross_entropy
        tl = tautograd.softmax_cross_entropy
    jrep = jsonnx.prepare(r["data"])
    jrep.set_optimizer(jopt.SGD(lr=0.02, momentum=0.9))
    jrep.set_loss(jl)
    jx = jtensor.from_numpy(ids)
    jrep.compile([jx], is_train=True, use_graph=False)
    jlosses = [float(np.asarray(jrep.train_step(jx, jtensor.from_numpy(y))
                                [1].data)) for _ in range(STEPS)]
    trep = tsonnx.prepare(r["data"], device=CPU)
    trep.set_optimizer(topt.SGD(lr=0.02, momentum=0.9))
    trep.set_loss(tl)
    trep.compile([ids], is_train=True, use_graph=True)
    tlosses = [float(trep.train_step(ids, y)[1]) for _ in range(STEPS)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=TOL, atol=TOL)
    assert tlosses[-1] < tlosses[0]
    jparams = {n: np.asarray(p.data) for n, p in jrep.get_params().items()}
    tparams = trep.get_params()
    assert set(tparams) == set(jparams)
    for n, p in tparams.items():
        _close(_np(p), jparams[n], PARAM_TOL)


# ---------------------------------------------------------------------------
# the port's exporter, read back by the reference's backend
# ---------------------------------------------------------------------------

class _RefTinyFFN(jmodel.Model):
    def __init__(self):
        super().__init__()
        self.ln = jlayer.LayerNorm(8)
        self.fc1 = jlayer.Linear(16, 8)
        self.fc2 = jlayer.Linear(8, 16)

    def forward(self, x):
        h = jautograd.gelu(self.fc1(self.ln(x)))
        return jautograd.add(self.fc2(h), x)


class _TinyFFN(tmodel.Model):
    def __init__(self):
        super().__init__(device=CPU)
        self.ln = tlayer.LayerNorm(8, device=CPU)
        self.fc1 = tlayer.Linear(16, 8, device=CPU)
        self.fc2 = tlayer.Linear(8, 16, device=CPU)

    def forward(self, x):
        h = tautograd.gelu(self.fc1(self.ln(x)))
        return self.fc2(h) + x


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name: (reference factory, port factory, input, tolerance)
EXPORTS = {
    "bert": (lambda: jtr.BERT(jtr.BERTConfig.tiny(num_labels=2)),
             lambda: tmodels.BERT(tmodels.BERTConfig.tiny(num_labels=2)),
             _ids(), TOL),
    "gpt2": (lambda: jtr.GPT2(jtr.GPT2Config.tiny()),
             lambda: tmodels.GPT2(tmodels.GPT2Config.tiny()), _ids(), TOL),
    "mlp": (lambda: jmodels.MLP(perceptron_size=16, num_classes=5),
            lambda: tmodels.MLP(16, 5, input_shape=(12,)), _x((3, 12)), TOL),
    "cnn": (lambda: jmodels.CNN(num_classes=4),
            lambda: tmodels.CNN(num_classes=4, input_shape=(12, 12, 1)),
            _x((2, 12, 12, 1)), CNN_TOL),
    "tiny_ffn": (_RefTinyFFN, _TinyFFN, _x((2, 5, 8)), TOL),
}


@pytest.fixture(scope="module")
def port_exports():
    """Each model of EXPORTS in both packages with the reference's
    weights, the port's export and the reference's, and both native
    outputs."""
    out = {}
    for name, (jmake, tmake, x, tol) in EXPORTS.items():
        jtensor.set_seed(0)
        jm = jmake()
        jx = jtensor.from_numpy(x)
        jm.compile([jx], is_train=False, use_graph=False)
        jm.eval()
        jnative = np.asarray(jm(jx).data)
        tdevice.set_default_device(CPU)
        tm = tmake()
        tmodels.load_reference_params(tm, {
            n: np.asarray(t.data) for n, t in jm.get_params().items()})
        tm.eval()
        with torch.no_grad():
            tnative = _np(tm(torch.as_tensor(x)))
        out[name] = dict(x=x, tol=tol, jnative=jnative, tnative=tnative,
                         proto=tsonnx.to_onnx(tm, [x]),
                         ref_proto=jsonnx.to_onnx(jm, [jx]))
    tdevice.set_default_device(None)
    return out


@pytest.mark.parametrize("name", list(EXPORTS))
def test_port_export_reads_back_in_the_reference(port_exports, name):
    e = port_exports[name]
    data = e["proto"].SerializeToString()
    tsonnx.check_model(tsonnx.load_model_from_string(data))
    (j,), (t,) = _both(data, [e["x"]])
    _close(j, e["tnative"], e["tol"])
    _close(j, e["jnative"], e["tol"])
    _close(t, e["tnative"], e["tol"])


@pytest.mark.parametrize("name", list(EXPORTS))
def test_port_export_parameters_equal_the_reference_export(port_exports,
                                                          name):
    """The initializers named after parameters: the same names and
    arrays as the reference's export of the same model."""
    e = port_exports[name]

    def params(m):
        names = {vi.name for vi in m.graph.input}
        return {t.name: tproto.to_array(t) for t in m.graph.initializer
                if not t.name.startswith(("const_", "shape_", "axes_",
                                          "starts_", "ends_", "steps_",
                                          "scale_", "neg_inf_",
                                          "causal_mask_"))
                and t.name not in names}
    ref = tproto.ModelProto.FromString(e["ref_proto"].SerializeToString())
    mine, want = params(e["proto"]), params(ref)
    assert set(mine) == set(want)
    for n, a in mine.items():
        np.testing.assert_array_equal(a, want[n])


@pytest.mark.parametrize("name,ops", [
    ("tiny_ffn", ["LayerNormalization", "MatMul", "Add", "Gelu", "MatMul",
                  "Add", "Add"]),
    ("bert", None), ("gpt2", None)])
def test_layernorm_and_gelu_export_as_single_nodes(port_exports, name, ops):
    got = [n.op_type for n in port_exports[name]["proto"].graph.node]
    if ops is not None:
        assert got == ops
    assert "LayerNormalization" in got and "Gelu" in got
    assert not {"ReduceMean", "Erf", "Tanh", "Pow", "Sqrt"} & set(
        got) - ({"Tanh"} if name == "bert" else set())


# the port's own models beyond the reference's exports: (factory, input,
# tolerance of the reference's import against the port's native output)
ZOO = {
    "resnet18": (lambda: tmodels.resnet18(num_classes=10),
                 lambda: torch.from_numpy(_x((2, 16, 16, 3))), CNN_TOL),
    "lenet": (lambda: tmodels.LeNet5(),
              lambda: torch.from_numpy(_x((2, 28, 28, 1))), CNN_TOL),
    "cnn_nchw": (lambda: tmodels.CNN(data_format="NCHW"),
                 lambda: torch.from_numpy(_x((2, 1, 28, 28))), CNN_TOL),
    "llama": (lambda: tmodels.Llama(tmodels.LlamaConfig.tiny()),
              lambda: torch.from_numpy(_ids(vocab=100)), TOL),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_port_model_export_round_trips(name):
    """A port model exports, checks, and reads back in the port within
    1e-5 (Llama's RMSNorm exports decomposed) and in the reference
    within the tolerance."""
    make, x, tol = ZOO[name]
    torch.manual_seed(0)
    m, x = make(), x()
    m.eval()
    with torch.no_grad():
        want = _np(m(x))
    data = tsonnx.to_onnx(m, [x]).SerializeToString()
    tsonnx.check_model(tsonnx.load_model_from_string(data))
    (j,), (t,) = _both(data, [x.numpy()])
    _close(t, want)
    _close(j, want, tol)


def test_gpt2_tied_head_is_one_initializer(port_exports):
    m = port_exports["gpt2"]["proto"]
    uses = [n for n in m.graph.node if "wte.table" in n.input]
    assert [n.op_type for n in uses] == ["Gather", "Transpose"]
    assert [t.name for t in m.graph.initializer].count("wte.table") == 1


class _AttnNet(tmodel.Model):
    def __init__(self):
        super().__init__(device=CPU)
        self.attn = tlayer.MultiHeadAttention(
            2, 16, causal=True, device=CPU,
            generator=torch.Generator().manual_seed(0))

    def forward(self, x):
        return self.attn(x)


def test_bf16_export_constants_and_round_trip():
    """A bf16 trace emits its scale and neg_inf constants in bf16; the
    file reads back in both packages (the port's CPU rep computes in
    f32, the dtype rule of sonnx/backend.py)."""
    m = _AttnNet()
    x = torch.from_numpy(_x((1, 8, 16))).bfloat16()
    m.eval()
    with torch.no_grad():
        native = _np(m(x))
    p = tsonnx.to_onnx(m, [x])
    inits = {t.name: t for t in p.graph.initializer}
    consts = [t for n, t in inits.items() if "scale" in n or "neg_inf" in n]
    assert len(consts) == 2
    for t in consts:
        assert t.data_type == tproto.TensorProto.BFLOAT16
        assert tproto.to_array(t).dtype == torch.bfloat16
    data = p.SerializeToString()
    rep = tsonnx.prepare(data, device=CPU)
    assert set(rep.get_params()) == {n.replace(".", "_")
                                     for n in m.get_params()}
    (out,) = rep.run([x])
    assert out.dtype == torch.float32
    _close(_np(out), native, BF16_TOL)
    import ml_dtypes
    jx = jtensor.from_numpy(x.float().numpy().astype(ml_dtypes.bfloat16))
    (jout,) = jsonnx.prepare(data).run([jx])
    _close(np.asarray(jout.data, np.float32), native, BF16_TOL)


def test_exported_attention_mask_is_a_graph_input():
    """A padding mask given as a graph input stays an input of the
    exported graph (the reference freezes the trace's mask): padded
    positions' ids leave the logits as they were."""
    tdevice.set_default_device(CPU)
    m = tmodels.BERT(tmodels.BERTConfig.tiny(num_labels=2))
    ids, tt = _ids(), np.zeros((B, T), np.int32)
    mask = np.ones((B, T), np.int32)
    mask[:, -3:] = 0
    p = tsonnx.to_onnx(m, [ids, tt, mask])
    rep = tsonnx.prepare(p.SerializeToString(), device=CPU)
    other = ids.copy()
    other[:, -3:] = (other[:, -3:] + 1) % 256
    a, b = (_np(rep.run([i, tt, mask])[0]) for i in (ids, other))
    m.eval()
    with torch.no_grad():
        want = _np(m(*(torch.as_tensor(v) for v in (ids, tt, mask))))
    _close(a, want)
    np.testing.assert_array_equal(a, b)


def test_recorder_is_released_and_the_marker_is_inert():
    m = tmodels.MLP(8, 3, input_shape=(6,), device=CPU)
    x = torch.from_numpy(_x((2, 6)))
    assert _unit._recorder is None
    tsonnx.to_onnx(m, [x])
    assert _unit._recorder is None
    w = torch.randn(6, 3)
    assert torch.equal(tautograd.linear(x, w), x @ w)
    assert tautograd.linear.__name__ == "linear"


# ---------------------------------------------------------------------------
# file IO, the device default, the dtype rule, the checkpoint format
# ---------------------------------------------------------------------------

def test_export_path_and_prepare_path_round_trip(tmp_path):
    m = tmodels.MLP(8, 3, input_shape=(6,), device=CPU)
    x = _x((2, 6))
    with torch.no_grad():
        want = _np(m(torch.as_tensor(x)))
    path = str(tmp_path / "mlp.onnx")
    p = tsonnx.export(m, [x], path)
    assert tsonnx.load(path).SerializeToString() == p.SerializeToString()
    (y,) = tsonnx.prepare(path, device=CPU).run([x])
    _close(_np(y), want)
    (y,) = tsonnx.prepare(tsonnx.load(path), device="cpu").run([x])
    _close(_np(y), want)


def test_prepare_defaults_to_the_card_and_raises_without_one(monkeypatch,
                                                             port_exports):
    data = port_exports["mlp"]["proto"].SerializeToString()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tdevice.set_default_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsonnx.prepare(data)
    rep = tsonnx.prepare(data, device=CPU)
    assert rep.device is CPU and rep.compute_dtype == torch.float32


def test_float_casts_run_in_the_compute_dtype():
    """Cast to BFLOAT16 or FLOAT16 of a device value gives the compute
    dtype (f32 on the CPU, unrounded); to INT32 casts as written; a
    host constant's Cast rounds as numpy (bf16 through torch)."""
    mk = tproto.make_node
    nodes = [mk("Cast", ["x"], ["b"], to=tproto.TensorProto.BFLOAT16),
             mk("Cast", ["b"], ["h"], to=tproto.TensorProto.FLOAT16),
             mk("Cast", ["h"], ["i"], to=tproto.TensorProto.INT32),
             mk("Cast", ["c"], ["cb"], to=tproto.TensorProto.BFLOAT16),
             mk("Add", ["h", "cb"], ["y"])]
    g = tproto.make_graph(
        nodes, "casts",
        [tproto.make_tensor_value_info("x", tproto.TensorProto.FLOAT, [4])],
        [tproto.make_tensor_value_info(n, tproto.TensorProto.FLOAT, [4])
         for n in ("h", "i", "y")],
        [tproto.from_array(np.float32(1.00390625), "c")])
    x = np.asarray([1.001, -2.5, 3.75, 0.1], np.float32)
    h, i, y = tsonnx.prepare(tproto.make_model(g), device=CPU).run([x])
    assert h.dtype == y.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(_np(h), x)
    np.testing.assert_array_equal(i.numpy(), [1, -2, 3, 0])
    np.testing.assert_array_equal(_np(y), x + 1.0)   # c rounds to 1.0


def test_cumsum_exclusive_and_reverse():
    """ONNX CumSum's exclusive and reverse attributes (the reference's
    handler ignores them: ROADMAP.md queue 3)."""
    x = _x((3, 4))
    for excl in (0, 1):
        for rev in (0, 1):
            g = tproto.make_graph(
                [tproto.make_node("CumSum", ["x", "ax"], ["y"],
                                  exclusive=excl, reverse=rev)], "c",
                [tproto.make_tensor_value_info("x", 1, [3, 4])],
                [tproto.make_tensor_value_info("y", 1, [3, 4])],
                [tproto.from_array(np.int64(1), "ax")])
            (y,) = tsonnx.prepare(tproto.make_model(g), device=CPU).run([x])
            src = x[:, ::-1] if rev else x
            want = np.cumsum(src, 1) - (src if excl else 0)
            _close(_np(y), want[:, ::-1] if rev else want)


def test_onehot_negative_indices_count_from_the_end():
    """ONNX OneHot: an index in [-depth, 0) counts from the end, one
    outside [-depth, depth) is a row of off values (the reference's
    handler gives negative indices a row of off values: ROADMAP.md
    queue 3)."""
    g = tproto.make_graph(
        [tproto.make_node("OneHot", ["i", "d", "v"], ["y"], axis=-1)], "o",
        [tproto.make_tensor_value_info("i", 7, [4])],
        [tproto.make_tensor_value_info("y", 1, [4, 3])],
        [tproto.from_array(np.int64(3), "d"),
         tproto.from_array(np.asarray([0, 5], np.int64), "v")])
    (y,) = tsonnx.prepare(tproto.make_model(g), device=CPU).run(
        [np.asarray([-1, -3, 4, 1], np.int64)])
    np.testing.assert_array_equal(_np(y), [[0, 0, 5], [5, 0, 0], [0, 0, 0],
                                           [0, 5, 0]])


def test_dropout_node_draws_from_the_rep_generator():
    g = tproto.make_graph(
        [tproto.make_node("Dropout", ["x", "r", "t"], ["y"])], "d",
        [tproto.make_tensor_value_info("x", 1, [64])],
        [tproto.make_tensor_value_info("y", 1, [64])],
        [tproto.from_array(np.float32(0.5), "r"),
         tproto.from_array(np.asarray(True), "t")])
    rep = tsonnx.prepare(tproto.make_model(g), device=CPU)
    x = np.ones(64, np.float32)
    assert torch.equal(rep.run([x])[0], torch.ones(64))   # eval: identity
    tmodel_gens = tmodel._dropout_generators(rep)
    assert tmodel_gens == (rep.dropout.generator,)
    draws = []
    with tautograd.train_mode():
        for _ in range(2):
            rep.dropout.generator.manual_seed(7)
            draws.append(rep.run([x])[0])
    assert torch.equal(draws[0], draws[1])
    assert set(draws[0].unique().tolist()) == {0.0, 2.0}


def test_checkpoint_of_an_import_loads_into_the_reference(tmp_path,
                                                          ref_exports):
    """save_states of the port's rep after a step, load_states into the
    reference's rep of the same bytes: the same outputs."""
    r = ref_exports["bert"]
    ids = _ids()
    trep = tsonnx.prepare(r["data"], device=CPU)
    trep.set_optimizer(topt.SGD(lr=0.1))
    trep.compile([ids], is_train=True, use_graph=True)
    trep.train_step(ids, np.array([0, 1], np.int32))
    path = str(tmp_path / "rep.npz")
    trep.save_states(path)
    jrep = jsonnx.prepare(r["data"])
    jrep.load_states(path)
    trep.eval()
    (t,) = trep.run([ids])
    (j,) = jrep.run([jtensor.from_numpy(ids)])
    _close(_np(t), np.asarray(j.data))
    assert not np.allclose(np.asarray(j.data), r["native"], atol=1e-6)
