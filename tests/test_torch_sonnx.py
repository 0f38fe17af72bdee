"""The port's sonnx (singa_tpu_torch.sonnx) against the JAX package's
(singa_tpu.sonnx), on the CPU: the wire codec, the structural checker,
and every op of the import backend.

Each op of ``supported_ops()`` is built as a small helper graph; the
same bytes and the same numpy-seeded inputs go through
``singa_tpu.sonnx.prepare(...).run`` and the port's
``prepare(..., device=create_device("cpu")).run``.  Tolerances (f32 on
both sides):
  * float outputs within rtol 1e-5, atol 1e-5; integer and bool outputs
    exactly (values; the JAX side narrows int64 to int32);
  * for float ops with a gradient, the gradient of sum(first output)
    with respect to each float input of ndim > 0 (given as an
    initializer, so a trainable parameter on both sides) within rtol
    1e-4, atol 1e-4.
The codec's bytes are compared byte for byte."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import sonnx as jsonnx
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import sonnx as tsonnx
from singa_tpu_torch.sonnx import proto as tproto

TP = tproto.TensorProto
CPU = tdevice.create_device("cpu")
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _codec_models(p):
    """The messages of tests/test_sonnx.py's codec cases, built through
    the helpers of proto module `p`."""
    rng = np.random.RandomState(0)
    out = {"f32": p.from_array(rng.randn(3, 4).astype(np.float32), "w")}
    for dt in (np.int64, np.int32, np.bool_, np.float16, np.float64,
               np.uint8):
        out[np.dtype(dt).name] = p.from_array(
            (rng.randn(2, 5) * 3).astype(dt), "t")
    out["typed"] = p.TensorProto(dims=[2, 2], data_type=p.TensorProto.FLOAT,
                                 float_data=[1.0, 2.0, 3.0, 4.0])
    n = p.make_node("Add", ["a", "b"], ["c"], alpha=1.5, beta=2)
    g = p.make_graph(
        [n], "g",
        [p.make_tensor_value_info("a", p.TensorProto.FLOAT, [2, "N"]),
         p.make_tensor_value_info("b", p.TensorProto.FLOAT, [2, 1])],
        [p.make_tensor_value_info("c", p.TensorProto.FLOAT, [2, None])],
        initializer=[p.from_array(np.ones((2, 1), np.float32), "b")])
    out["model"] = p.make_model(g, opset_version=17)
    out["tensor"] = p.make_tensor("k", p.TensorProto.INT64, [3], [1, -2, 3])
    return out


def test_codec_bytes_equal_the_reference():
    from singa_tpu.sonnx import proto as jproto
    mine, ref = _codec_models(tproto), _codec_models(jproto)
    for k in ref:
        assert mine[k].SerializeToString() == ref[k].SerializeToString(), k


def test_each_package_parses_the_others_bytes():
    from singa_tpu.sonnx import proto as jproto
    for src, dst in ((tproto, jproto), (jproto, tproto)):
        m = _codec_models(src)["model"]
        back = dst.ModelProto.FromString(m.SerializeToString())
        assert back.SerializeToString() == m.SerializeToString()
        assert back.opset_import[0].version == 17
        assert back.graph.input[0].type.tensor_type.shape.dim[1] \
            .dim_param == "N"
        for k, t in _codec_models(src).items():
            if k == "model":
                continue
            got = dst.to_array(dst.TensorProto.FromString(
                t.SerializeToString()))
            np.testing.assert_array_equal(got, src.to_array(t))


def test_bf16_round_trips_bitwise_both_ways():
    import ml_dtypes
    from singa_tpu.sonnx import proto as jproto
    bits = np.random.RandomState(1).randint(0, 2 ** 16, (4, 5)) \
        .astype(np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0      # no NaN/inf patterns
    ref_t = jproto.from_array(bits.view(ml_dtypes.bfloat16), "t")
    mine = tproto.to_array(TP.FromString(ref_t.SerializeToString()))
    assert mine.dtype == torch.bfloat16
    np.testing.assert_array_equal(mine.view(torch.int16).numpy()
                                  .view(np.uint16), bits)
    t = tproto.from_array(mine, "t")
    assert t.SerializeToString() == ref_t.SerializeToString()
    back = jproto.to_array(jproto.TensorProto.FromString(
        t.SerializeToString()))
    np.testing.assert_array_equal(back.view(np.uint16), bits)
    made = tproto.make_tensor("m", TP.BFLOAT16, [2], [1.5, -2.25])
    assert tproto.to_array(made).tolist() == [1.5, -2.25]
    scalar = tproto.from_array(torch.tensor(-0.125, dtype=torch.bfloat16))
    back = tproto.to_array(TP.FromString(scalar.SerializeToString()))
    assert back.shape == () and back.item() == -0.125


def test_bf16_needs_no_ml_dtypes():
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from singa_tpu_torch.sonnx import proto\n"
        "x = torch.randn(3, 4).bfloat16()\n"
        "t = proto.TensorProto.FromString(proto.from_array(x, 'x')"
        ".SerializeToString())\n"
        "assert t.data_type == proto.TensorProto.BFLOAT16\n"
        "y = proto.to_array(t)\n"
        "assert y.dtype == torch.bfloat16 and torch.equal(x, y)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# ---------------------------------------------------------------------------
# checker: the verdicts of tests/test_sonnx_external.py's cases
# ---------------------------------------------------------------------------

def _ref_export_bytes():
    from singa_tpu import layer, model

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(8)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(3)

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

    jtensor.set_seed(0)
    x = jtensor.from_numpy(np.random.RandomState(0).randn(2, 4)
                           .astype(np.float32))
    return jsonnx.to_onnx(Net(), [x]).SerializeToString()


def _mutations():
    def ssa(m):
        m.graph.node[0].input[0] = "never_defined"

    def dup(m):
        m.graph.node[-1].output[0] = m.graph.node[0].output[0]

    def truncated(m):
        init = next(t for t in m.graph.initializer if t.raw_data)
        init.raw_data = init.raw_data[:-2]

    def no_opset(m):
        m.opset_import = []

    def dangling(m):
        m.graph.output[0].name = "nowhere"

    def no_op_type(m):
        m.graph.node[0].op_type = ""

    def two_families(m):
        m.graph.node[0].attribute = [tproto.AttributeProto(
            name="a", type=tproto.AttributeProto.INT, i=1, f=2.0)]

    def bad_dtype(m):
        m.graph.initializer[0].data_type = 99

    def no_ir(m):
        m.ir_version = 0

    return {"valid": lambda m: None, "ssa": ssa, "duplicate": dup,
            "truncated": truncated, "no_opset": no_opset,
            "dangling": dangling, "no_op_type": no_op_type,
            "two_families": two_families, "bad_dtype": bad_dtype,
            "no_ir_version": no_ir}


def _verdict(check, m):
    try:
        check(m)
    except ValueError as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", list(_mutations()))
def test_checker_verdicts_equal_the_reference(case):
    data = _ref_export_bytes()
    mine = tsonnx.load_model_from_string(data)
    ref = jsonnx.load_model_from_string(data)
    _mutations()[case](mine)
    if case == "two_families":
        ref.graph.node[0].attribute = [jsonnx.AttributeProto(
            name="a", type=jsonnx.AttributeProto.INT, i=1, f=2.0)]
    else:
        _mutations()[case](ref)
    got, want = _verdict(tsonnx.check_model, mine), \
        _verdict(jsonnx.check_model, ref)
    assert got == want
    assert (got is None) == (case == "valid")


def test_checker_is_the_reference_checker():
    """A verbatim copy: the same source below the module docstring."""
    import inspect
    from singa_tpu.sonnx import checker as jchecker
    from singa_tpu_torch.sonnx import checker as tchecker

    def body(mod):
        src = inspect.getsource(mod)
        return src[src.index("from __future__"):]
    assert body(tchecker) == body(jchecker)


# ---------------------------------------------------------------------------
# every op: the same bytes through both backends
# ---------------------------------------------------------------------------

def _u(*shape, lo=-1.0, hi=1.0, seed=0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def _i(*vals):
    return np.asarray(vals, np.int64)


def _c(name, op, ins, attrs=None, consts=None, n_out=1, opset=18,
       grad=True):
    """A case: `ins` the graph inputs (name -> array), `consts` the
    initializers (shape arguments and the like), `n_out` outputs."""
    return dict(name=name, op=op, ins=ins, attrs=attrs or {},
                consts=consts or {}, n_out=n_out, opset=opset, grad=grad)


def _unary(op, lo=-1.0, hi=1.0, grad=True, **attrs):
    return [_c(op, op, {"x": _u(3, 4, lo=lo, hi=hi)}, attrs, grad=grad)]


_RNN_T, _RNN_B, _RNN_I, _RNN_H = 5, 2, 3, 4


def _rnn(op, tag, d=1, **attrs):
    g = {"LSTM": 4, "GRU": 3, "RNN": 1}[op]
    H = _RNN_H
    ins = {"x": _u(_RNN_T, _RNN_B, _RNN_I, seed=1),
           "w": _u(d, g * H, _RNN_I, seed=2, lo=-0.5, hi=0.5),
           "r": _u(d, g * H, H, seed=3, lo=-0.5, hi=0.5),
           "b": _u(d, 2 * g * H, seed=4, lo=-0.5, hi=0.5)}
    n_out = 3 if op == "LSTM" else 2
    return _c(f"{op}-{tag}", op, ins, dict(hidden_size=H, **attrs),
              n_out=n_out)


CASES = {
    **{op: _unary(op) for op in (
        "Abs", "Asin", "Asinh", "Atan", "Cos", "Cosh", "Erf", "Exp",
        "HardSwish", "Identity", "Mish", "Neg", "Relu", "Selu", "Sigmoid",
        "Sign", "Sin", "Sinh", "Softplus", "Tan", "Tanh", "Floor", "Ceil")},
    "Acos": _unary("Acos", -0.9, 0.9),
    "Atanh": _unary("Atanh", -0.9, 0.9),
    "Acosh": _unary("Acosh", 1.1, 3.0),
    "Log": _unary("Log", 0.5, 2.0),
    "Sqrt": _unary("Sqrt", 0.5, 2.0),
    "Reciprocal": _unary("Reciprocal", 0.5, 2.0),
    "Round": _unary("Round", -3.0, 3.0),
    "Elu": _unary("Elu", alpha=0.7),
    "LeakyRelu": _unary("LeakyRelu", alpha=0.2),
    "HardSigmoid": _unary("HardSigmoid", alpha=0.3, beta=0.4),
    "Gelu": [_c("Gelu-tanh", "Gelu", {"x": _u(3, 4)},
                dict(approximate="tanh")),
             _c("Gelu-erf", "Gelu", {"x": _u(3, 4)})],
    "Not": [_c("Not", "Not", {"x": _u(3, 4) > 0})],
    **{op: [_c(op, op, {"a": _u(3, 4), "b": _u(4, seed=1, lo=0.5, hi=2)})]
       for op in ("Add", "Sub", "Mul")},
    "Div": [_c("Div", "Div", {"a": _u(3, 4), "b": _u(4, seed=1, lo=0.5,
                                                        hi=2)}),
            _c("Div-int", "Div", {"a": _i(7, -7, 7, -7, 0)},
               consts={"b": _i(2, 2, -2, -2, 3)})],
    "Pow": [_c("Pow", "Pow", {"a": _u(3, 4, lo=0.5, hi=2),
                              "b": _u(3, 4, seed=1, lo=-1, hi=2)})],
    **{op: [_c(op, op, {"a": _u(3, 4), "b": _u(3, 4, seed=1)})]
       for op in ("Equal", "Greater", "GreaterOrEqual", "Less",
                  "LessOrEqual")},
    **{op: [_c(op, op, {"a": _u(3, 4) > 0, "b": _u(3, 4, seed=1) > 0})]
       for op in ("And", "Or", "Xor")},
    "Mod": [_c("Mod-floor", "Mod", {"a": _i(7, -7, 7, -7)},
               consts={"b": _i(3, 3, -3, -3)}),
            _c("Mod-fmod", "Mod", {"a": _u(3, 4, lo=-3, hi=3)},
               dict(fmod=1), consts={"b": np.float32(0.7)}, grad=False)],
    **{op: [_c(op, op, {"a": _u(3, 4), "b": _u(3, 4, seed=1),
                        "c": _u(4, seed=2)})]
       for op in ("Min", "Max", "Sum", "Mean")},
    "Clip": [_c("Clip", "Clip", {"x": _u(3, 4)},
                consts={"lo": np.float32(-0.5), "hi": np.float32(0.4)})],
    "PRelu": [_c("PRelu", "PRelu", {"x": _u(3, 4), "s": _u(4, seed=1)})],
    "Softmax": [_c("Softmax-13", "Softmax", {"x": _u(2, 3, 4)},
                   dict(axis=1), opset=13),
                _c("Softmax-11", "Softmax", {"x": _u(2, 3, 4)},
                   dict(axis=1), opset=11)],
    "LogSoftmax": [_c("LogSoftmax-13", "LogSoftmax", {"x": _u(2, 3, 4)},
                      opset=13),
                   _c("LogSoftmax-11", "LogSoftmax", {"x": _u(2, 3, 4)},
                      dict(axis=1), opset=11)],
    "MatMul": [_c("MatMul", "MatMul", {"a": _u(2, 3, 4),
                                       "b": _u(4, 5, seed=1)})],
    "Gemm": [_c("Gemm", "Gemm", {"a": _u(4, 3), "b": _u(5, 3, seed=1),
                                 "c": _u(5, seed=2)},
                dict(alpha=0.5, beta=2.0, transB=1))],
    "Einsum": [_c("Einsum", "Einsum", {"a": _u(3, 4), "b": _u(4, 5, seed=1)},
                  dict(equation="ij,jk->ik"))],
    "Shape": [_c("Shape", "Shape", {"x": _u(2, 3, 4)}, dict(start=1))],
    "Size": [_c("Size", "Size", {"x": _u(2, 3, 4)})],
    "Constant": [_c("Constant", "Constant", {},
                    dict(value=_u(2, 3)))],
    "ConstantOfShape": [_c("ConstantOfShape", "ConstantOfShape", {},
                           dict(value=np.asarray([2.5], np.float32)),
                           consts={"shape": _i(2, 3)})],
    "Cast": [_c("Cast-int", "Cast", {"x": _u(3, 4, lo=-3, hi=3)},
                dict(to=TP.INT64)),
             _c("Cast-float", "Cast", {"x": _u(3, 4)}, dict(to=TP.FLOAT))],
    "CastLike": [_c("CastLike", "CastLike", {"x": _i(1, -2, 3)},
                    consts={"like": np.ones(2, np.float32)})],
    "Reshape": [_c("Reshape", "Reshape", {"x": _u(2, 3, 4)},
                   consts={"shape": _i(0, -1)})],
    "Transpose": [_c("Transpose", "Transpose", {"x": _u(2, 3, 4)},
                     dict(perm=[2, 0, 1]))],
    "Flatten": [_c("Flatten", "Flatten", {"x": _u(2, 3, 4)}, dict(axis=2))],
    "Squeeze": [_c("Squeeze", "Squeeze", {"x": _u(2, 1, 4)},
                   consts={"axes": _i(1)}),
                _c("Squeeze-11", "Squeeze", {"x": _u(2, 1, 4)},
                   dict(axes=[-2]), opset=11)],
    "Unsqueeze": [_c("Unsqueeze", "Unsqueeze", {"x": _u(2, 4)},
                     consts={"axes": _i(0, -1)})],
    "Concat": [_c("Concat", "Concat", {"a": _u(2, 3), "b": _u(2, 2, seed=1)},
                  dict(axis=1))],
    "Split": [_c("Split", "Split", {"x": _u(2, 4)}, dict(axis=1),
                 consts={"split": _i(1, 3)}, n_out=2)],
    "Slice": [_c("Slice", "Slice", {"x": _u(4, 6)},
                 consts={"st": _i(1, 5), "en": _i(3, 0), "ax": _i(0, 1),
                         "sp": _i(1, -2)})],
    "Gather": [_c("Gather", "Gather", {"x": _u(3, 5)}, dict(axis=1),
                  consts={"idx": _i(-1, 0, 2, 2)}),
               _c("Gather-rows", "Gather", {"x": _u(6, 4)},
                  consts={"idx": np.asarray([[0, 5], [5, -2]], np.int64)})],
    "GatherElements": [_c("GatherElements", "GatherElements",
                          {"x": _u(3, 4)}, dict(axis=1),
                          consts={"idx": np.asarray([[0, -1], [2, 2],
                                                     [1, 3]], np.int64)})],
    "Expand": [_c("Expand", "Expand", {"x": _u(3, 1)},
                  consts={"shape": _i(2, 3, 4)})],
    "Tile": [_c("Tile", "Tile", {"x": _u(2, 3)}, consts={"reps": _i(2, 3)})],
    "Range": [_c("Range", "Range", {},
                 consts={"s": np.int64(1), "l": np.int64(9),
                         "d": np.int64(3)})],
    "Where": [_c("Where", "Where", {"cond": _u(3, 4, seed=2) > 0,
                                    "a": _u(3, 4), "b": _u(3, 4, seed=1)})],
    "Trilu": [_c("Trilu", "Trilu", {"x": _u(4, 4)}, dict(upper=0),
                 consts={"k": np.int64(1)})],
    "LSTM": [_rnn("LSTM", "bidirectional", 2, direction="bidirectional"),
             _rnn("LSTM", "clip", clip=0.5)],
    "GRU": [_rnn("GRU", "lbr1-reverse", linear_before_reset=1,
                 direction="reverse"),
            _rnn("GRU", "lbr0-bidirectional", 2,
                 direction="bidirectional")],
    "RNN": [_rnn("RNN", "forward"),
            _rnn("RNN", "relu-bidirectional", 2, direction="bidirectional",
                 activations=["Relu", "Tanh"])],
    "OneHot": [_c("OneHot", "OneHot", {"idx": _i(0, 3, 5, 2)},
                  dict(axis=0), consts={"depth": np.int64(4),
                                        "vals": _i(-1, 2)})],
    "CumSum": [_c("CumSum", "CumSum", {"x": _u(3, 4)},
                  consts={"axis": np.int64(1)})],
    "Pad": [_c("Pad", "Pad", {"x": _u(2, 3)},
               consts={"pads": _i(1, 0, 0, 2),
                       "cval": np.float32(0.5)}),
            _c("Pad-reflect", "Pad", {"x": _u(3, 4)}, dict(mode="reflect"),
               consts={"pads": _i(1, 2, 2, 1)})],
    **{op: [_c(op, op, {"x": _u(2, 3, 4, lo=0.5, hi=1.5)},
               dict(keepdims=0), consts={"axes": _i(1, -1)}),
            _c(f"{op}-all", op, {"x": _u(2, 3, 4, lo=0.5, hi=1.5)})]
       for op in ("ReduceSum", "ReduceMean", "ReduceMax", "ReduceMin",
                  "ReduceProd", "ReduceL2")},
    **{op: [_c(op, op, {"x": _u(3, 4, 5)}, dict(axis=1, keepdims=0))]
       for op in ("ArgMax", "ArgMin")},
    "Conv": [_c("Conv", "Conv", {"x": _u(2, 3, 6, 6), "w": _u(4, 3, 3, 3,
                                                              seed=1),
                                 "b": _u(4, seed=2)},
                dict(pads=[1, 0, 1, 2], strides=[2, 1])),
             _c("Conv-1d", "Conv", {"x": _u(2, 3, 7), "w": _u(4, 3, 3,
                                                              seed=1)},
                dict(auto_pad="SAME_UPPER")),
             _c("Conv-group", "Conv", {"x": _u(1, 4, 5, 5),
                                       "w": _u(4, 2, 3, 3, seed=1)},
                dict(group=2, dilations=[2, 1]))],
    "MaxPool": [_c("MaxPool", "MaxPool", {"x": _u(1, 2, 6, 6)},
                   dict(kernel_shape=[3, 3], strides=[2, 2],
                        pads=[1, 1, 1, 1]))],
    "AveragePool": [_c("AveragePool", "AveragePool", {"x": _u(1, 2, 5, 5)},
                       dict(kernel_shape=[3, 3], strides=[1, 1],
                            pads=[1, 1, 1, 1])),
                    _c("AveragePool-include", "AveragePool",
                       {"x": _u(1, 2, 5, 5)},
                       dict(kernel_shape=[2, 2], pads=[1, 1, 1, 1],
                            count_include_pad=1))],
    "GlobalAveragePool": [_c("GlobalAveragePool", "GlobalAveragePool",
                             {"x": _u(2, 3, 4, 4)})],
    "GlobalMaxPool": [_c("GlobalMaxPool", "GlobalMaxPool",
                         {"x": _u(2, 3, 4, 4)})],
    "BatchNormalization": [_c("BatchNormalization", "BatchNormalization",
                              {"x": _u(2, 3, 4, 4), "s": _u(3, seed=1),
                               "b": _u(3, seed=2), "m": _u(3, seed=3),
                               "v": _u(3, seed=4, lo=0.5, hi=1.5)},
                              dict(epsilon=1e-3))],
    "LayerNormalization": [_c("LayerNormalization", "LayerNormalization",
                              {"x": _u(2, 3, 4), "s": _u(4, seed=1),
                               "b": _u(4, seed=2)}),
                           _c("LayerNormalization-axis1",
                              "LayerNormalization",
                              {"x": _u(2, 3, 4), "s": _u(3, 4, seed=1)},
                              dict(axis=1, epsilon=1e-3))],
    "InstanceNormalization": [_c("InstanceNormalization",
                                 "InstanceNormalization",
                                 {"x": _u(2, 3, 4, 4), "s": _u(3, seed=1),
                                  "b": _u(3, seed=2)})],
    "Dropout": [_c("Dropout", "Dropout", {"x": _u(3, 4)}, dict(),
                   consts={"ratio": np.float32(0.3),
                           "train": np.asarray(False)})],
}


def _dtype_of(a):
    return tproto.np_dtype_to_tensor_dtype(np.asarray(a).dtype)


def _graph_bytes(case, as_inits=()):
    """The case's ModelProto bytes; inputs named in `as_inits` become
    initializers."""
    names = list(case["ins"]) + list(case["consts"])
    node = tproto.make_node(case["op"], names,
                            [f"y{i}" for i in range(case["n_out"])],
                            **case["attrs"])
    inputs = [tproto.make_tensor_value_info(n, _dtype_of(a), a.shape)
              for n, a in case["ins"].items() if n not in as_inits]
    inits = [tproto.from_array(np.asarray(a), n)
             for n, a in list(case["ins"].items()) + list(
                 case["consts"].items())
             if n in as_inits or n in case["consts"]]
    outs = [tproto.make_tensor_value_info(f"y{i}", TP.FLOAT, None)
            for i in range(case["n_out"])]
    g = tproto.make_graph([node], case["name"], inputs, outs, inits)
    return tproto.make_model(g, opset_version=case["opset"]) \
        .SerializeToString()


def _compare(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    if want.dtype.kind in "fc":
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        assert got.dtype.kind == want.dtype.kind
        np.testing.assert_array_equal(got, want)


def _float_inputs(case):
    return [n for n, a in case["ins"].items()
            if a.dtype.kind == "f" and a.ndim > 0]


def _check_case(case):
    data = _graph_bytes(case)
    ins = list(case["ins"].values())
    jouts = jsonnx.prepare(data).run([jtensor.from_numpy(a) for a in ins])
    touts = tsonnx.prepare(data, device=CPU).run(ins)
    assert len(touts) == len(jouts) == case["n_out"]
    for t, j in zip(touts, jouts):
        _compare(t, np.asarray(j.data), FWD_TOL)
    floats = _float_inputs(case)
    if not (case["grad"] and floats and touts[0].is_floating_point()):
        return
    data = _graph_bytes(case, as_inits=floats)
    rest = [a for n, a in case["ins"].items() if n not in floats]
    jrep = jsonnx.prepare(data)
    names = {id(t): n for n, t in jrep.get_params().items()}
    with jautograd.train_mode():
        out = jrep.run([jtensor.from_numpy(a) for a in rest])[0]
        jgrads = {names[id(p)]: np.asarray(g.data) for p, g in
                  jautograd.backward(jautograd.reduce_sum(out))}
    trep = tsonnx.prepare(data, device=CPU)
    params = trep.get_params()
    tgrads = torch.autograd.grad(trep.run(rest)[0].sum(),
                                 list(params.values()))
    assert set(params) == set(jgrads) == set(floats)
    for n, g in zip(params, tgrads):
        _compare(g, jgrads[n], GRAD_TOL)


def test_supported_ops_equal_the_reference():
    assert tsonnx.supported_ops() == jsonnx.supported_ops()
    assert len(tsonnx.supported_ops()) == 104
    assert sorted(CASES) == tsonnx.supported_ops()


@pytest.mark.parametrize("op", jsonnx.supported_ops())
def test_op_matches_the_reference(op):
    for case in CASES[op]:
        _check_case(case)
