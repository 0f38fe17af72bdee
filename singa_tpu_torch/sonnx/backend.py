"""sonnx import backend — ONNX graph → PyTorch execution, ported from
``singa_tpu/sonnx/backend.py``.

``prepare(onnx_model, device)`` returns a ``SingaRep`` whose ``.run(inputs)``
replays the graph node by node through plain torch functions; torch
autograd is the tape, so an imported model is training-capable.  A
``SingaRep`` is a port ``model.Model``: ``compile(is_train=True,
use_graph=True)`` captures the whole imported graph's train step as one
CUDA graph on the card, as the native models are captured.  The backend
fuses no patterns: an imported attention is ``MatMul``/``Softmax``, never
the flash kernels.

Two value lanes.  Shape computation chains (Shape → Gather/Concat/... →
Reshape/Expand/Slice) are evaluated on the host in numpy: ``Shape`` yields
a concrete vector because tensor shapes are static, and any node whose
inputs are all host constants folds when the graph is read.  A
data-dependent value that reaches a shape position is rejected
(`_require_host`); nothing in ``forward`` reads a device tensor on the
host, so a step captures.  Device values are ``torch.Tensor`` on the
rep's device.  A host constant reaches the device once: the rep keeps
each uploaded constant (keyed by its bytes), so a captured step copies
nothing from the host.

Dtypes.  Float initializers with ndim > 0 are f32 master parameters
(under `_sanitize`d names); 0-d floats and every integer or bool stay
constants.  Every float value the graph computes lives in the rep's
compute dtype, ``device.default_dtype``: bf16 on the card, f32 on the
CPU, where the rep equals the JAX package's.  A master is cast to the
compute dtype where a node reads it (a ``Gather`` from a float table
reads the f32 master and casts the rows, as ``layer.Embedding`` does).
``Cast`` and ``CastLike`` to any float type (FLOAT16, BFLOAT16, FLOAT,
DOUBLE) cast a device value to the compute dtype, whichever float type
the file names; to an integer or bool type they cast as written.  (The
JAX package's rep runs the file's own float types.)  On the host lane a
``Cast`` is numpy's, BFLOAT16 rounding through torch.
``LayerNormalization``, ``BatchNormalization``, ``InstanceNormalization``,
``Softmax`` and ``LogSoftmax`` compute their statistics in f32 and
return the compute dtype.

A training-mode ``Dropout`` node draws its masks from the generator of
the rep's ``dropout`` submodule (a ``layer.Dropout``, present when the
graph has a Dropout node), which a captured train step registers, so
each replay draws new masks.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import autograd
from .. import layer
from .. import model as model_mod
from ..device import create_device
from ..ops import rnn as rnn_ops
from . import proto
from .proto import (ModelProto, NodeProto, TensorProto, attribute_value,
                    to_array)

__all__ = ["prepare", "SingaBackend", "SingaRep", "supported_ops"]


# ---------------------------------------------------------------------------
# value lanes: host constants (numpy — shape math, folded when read)
# vs device tensors (torch — the compute lane)
# ---------------------------------------------------------------------------

_HostVal = (np.ndarray, np.generic, int, float, bool)

_FLOAT_TYPES = (TensorProto.FLOAT16, TensorProto.BFLOAT16, TensorProto.FLOAT,
                TensorProto.DOUBLE)


def _is_host(v) -> bool:
    return isinstance(v, _HostVal)


def _host(v) -> np.ndarray:
    return np.asarray(v)


def _require_host(v, node: NodeProto, what: str) -> np.ndarray:
    if not _is_host(v):
        raise ValueError(
            f"ONNX node {node.op_type} ({node.name}): {what} must be a "
            f"compile-time constant — a captured step needs static shapes; "
            f"a data-dependent value reached a shape position")
    return _host(v)


def _numpy(a) -> np.ndarray:
    """A proto array on the host lane: bf16 (a torch tensor from
    proto.to_array) becomes f32, exactly."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return a


class _Ctx:
    def __init__(self, rep: "SingaRep", training: bool):
        self.rep = rep
        self.dtype = rep.compute_dtype
        self.opset = rep.opset
        self.training = training
        # names read by downstream nodes / graph outputs — used to reject
        # requests for aux outputs we don't compute (norm stats etc.)
        self.consumed = rep._consumed

    def tensor(self, v, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """`v` on the device lane: floats in `dtype` (default: the
        compute dtype), other types as they are."""
        want = dtype or self.dtype
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() and v.dtype != want:
                return v.to(want)
            return v
        return self.rep._upload(_host(v), want)


def _attrs(node: NodeProto) -> Dict[str, Any]:
    out = {}
    for a in node.attribute:
        v = attribute_value(a)
        if isinstance(v, list):
            v = [_numpy(x) for x in v]
        out[a.name] = _numpy(v)
    return out


# ---------------------------------------------------------------------------
# handler registry
# ---------------------------------------------------------------------------

_HANDLERS: Dict[str, Callable] = {}


def handles(*op_types: str):
    def deco(fn):
        for t in op_types:
            _HANDLERS[t] = fn
        return fn
    return deco


def supported_ops() -> List[str]:
    return sorted(_HANDLERS)


# -- elementwise unary -------------------------------------------------------

_UNARY = {
    "Relu": (torch.relu, lambda a: np.maximum(a, 0)),
    "Sigmoid": (torch.sigmoid, lambda a: 1 / (1 + np.exp(-a))),
    "Tanh": (torch.tanh, np.tanh),
    "Exp": (torch.exp, np.exp),
    "Log": (torch.log, np.log),
    "Sqrt": (torch.sqrt, np.sqrt),
    "Abs": (torch.abs, np.abs),
    "Neg": (torch.neg, np.negative),
    "Erf": (torch.erf, None),
    "Floor": (torch.floor, np.floor),
    "Ceil": (torch.ceil, np.ceil),
    "Round": (torch.round, np.round),
    "Sign": (torch.sign, np.sign),
    "Reciprocal": (torch.reciprocal, lambda a: 1.0 / a),
    "Softplus": (F.softplus, None),
    "Not": (torch.logical_not, np.logical_not),
    "Identity": (lambda t: t, lambda a: a),
    "Sin": (torch.sin, np.sin), "Cos": (torch.cos, np.cos),
    "Tan": (torch.tan, np.tan), "Asin": (torch.asin, np.arcsin),
    "Acos": (torch.acos, np.arccos), "Atan": (torch.atan, np.arctan),
    "Sinh": (torch.sinh, np.sinh), "Cosh": (torch.cosh, np.cosh),
    "Asinh": (torch.asinh, np.arcsinh),
    "Acosh": (torch.acosh, np.arccosh),
    "Atanh": (torch.atanh, np.arctanh),
    "HardSwish": (F.hardswish, None),
    "Mish": (F.mish, None),
}


@handles(*_UNARY)
def _h_unary(ctx, node, attrs, ins):
    t_fn, np_fn = _UNARY[node.op_type]
    (x,) = ins
    if _is_host(x) and np_fn is not None:
        return [np_fn(_host(x))]
    return [t_fn(ctx.tensor(x))]


# -- elementwise binary / variadic ------------------------------------------

def _onnx_div_torch(a, b):
    """ONNX Div: C-style truncating division for integer operands
    (torch exports chunk/shape arithmetic as int64 Div; true division
    would leak floats into downstream Slice/Reshape bounds)."""
    if not a.is_floating_point() and not b.is_floating_point():
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


def _onnx_div_np(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if (np.issubdtype(a.dtype, np.integer)
            and np.issubdtype(b.dtype, np.integer)):
        return np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))
    return np.divide(a, b)


_BINARY = {
    "Add": (torch.add, np.add),
    "Sub": (torch.sub, np.subtract),
    "Mul": (torch.mul, np.multiply),
    "Div": (_onnx_div_torch, _onnx_div_np),
    "Pow": (torch.pow, np.power),
    "Equal": (torch.eq, np.equal),
    "Greater": (torch.gt, np.greater),
    "GreaterOrEqual": (torch.ge, np.greater_equal),
    "Less": (torch.lt, np.less),
    "LessOrEqual": (torch.le, np.less_equal),
    "And": (torch.logical_and, np.logical_and),
    "Or": (torch.logical_or, np.logical_or),
    "Xor": (torch.logical_xor, np.logical_xor),
}


@handles(*_BINARY)
def _h_binary(ctx, node, attrs, ins):
    t_fn, np_fn = _BINARY[node.op_type]
    a, b = ins
    if _is_host(a) and _is_host(b):
        return [np_fn(_host(a), _host(b))]
    return [t_fn(ctx.tensor(a), ctx.tensor(b))]


@handles("Mod")
def _h_mod(ctx, node, attrs, ins):
    # fmod=1 -> C fmod (sign of dividend); fmod=0 -> floor-mod
    fmod = bool(attrs.get("fmod", 0))
    t_fn = torch.fmod if fmod else torch.remainder
    np_fn = np.fmod if fmod else np.mod
    a, b = ins
    if _is_host(a) and _is_host(b):
        return [np_fn(_host(a), _host(b))]
    return [t_fn(ctx.tensor(a), ctx.tensor(b))]


@handles("Min", "Max", "Sum", "Mean")
def _h_variadic(ctx, node, attrs, ins):
    t_fn = {"Min": torch.minimum, "Max": torch.maximum,
            "Sum": torch.add, "Mean": torch.add}[node.op_type]
    if all(_is_host(v) for v in ins):
        np_fn = {"Min": np.minimum, "Max": np.maximum,
                 "Sum": np.add, "Mean": np.add}[node.op_type]
        out = _host(ins[0])
        for v in ins[1:]:
            out = np_fn(out, _host(v))
        if node.op_type == "Mean":
            out = out / len(ins)
        return [out]
    out = ctx.tensor(ins[0])
    for v in ins[1:]:
        out = t_fn(out, ctx.tensor(v))
    if node.op_type == "Mean":
        out = out / len(ins)
    return [out]


@handles("Clip")
def _h_clip(ctx, node, attrs, ins):
    x = ins[0]
    lo = attrs.get("min")
    hi = attrs.get("max")
    if len(ins) > 1 and ins[1] is not None:
        lo = float(_require_host(ins[1], node, "min"))
    if len(ins) > 2 and ins[2] is not None:
        hi = float(_require_host(ins[2], node, "max"))
    lo = -np.inf if lo is None else float(lo)
    hi = np.inf if hi is None else float(hi)
    if _is_host(x):
        return [np.clip(_host(x), lo, hi)]
    return [torch.clamp(ctx.tensor(x), lo, hi)]


@handles("LeakyRelu")
def _h_leaky(ctx, node, attrs, ins):
    return [F.leaky_relu(ctx.tensor(ins[0]), float(attrs.get("alpha", 0.01)))]


@handles("Elu")
def _h_elu(ctx, node, attrs, ins):
    return [F.elu(ctx.tensor(ins[0]), float(attrs.get("alpha", 1.0)))]


@handles("Selu")
def _h_selu(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1.6732632))
    gamma = float(attrs.get("gamma", 1.050701))
    a = ctx.tensor(ins[0])
    return [gamma * torch.where(a > 0, a, alpha * (torch.exp(a) - 1))]


@handles("HardSigmoid")
def _h_hardsigmoid(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 0.2))
    beta = float(attrs.get("beta", 0.5))
    return [torch.clamp(alpha * ctx.tensor(ins[0]) + beta, 0, 1)]


@handles("Gelu")
def _h_gelu(ctx, node, attrs, ins):
    approx = attrs.get("approximate", "none")
    if isinstance(approx, bytes):
        approx = approx.decode()
    # ONNX default is the exact erf form; only approximate="tanh" maps
    # to the tanh approximation
    return [autograd.gelu(ctx.tensor(ins[0]), approximate=(approx == "tanh"))]


@handles("PRelu")
def _h_prelu(ctx, node, attrs, ins):
    a, s = ctx.tensor(ins[0]), ctx.tensor(ins[1])
    return [torch.where(a > 0, a, s * a)]


def _f32_stats(fn):
    """`fn` computed in f32, its result in the input's dtype."""
    def run(x, axis):
        return fn(x.float(), axis).to(x.dtype)
    return run


def _softmax_like(ctx, node, attrs, ins, fn):
    x = ctx.tensor(ins[0])
    fn = _f32_stats(fn)
    if ctx.opset >= 13:
        return [fn(x, int(attrs.get("axis", -1)))]
    # opset 1-12: coerce to 2-D — flatten dims [axis:] and normalize over
    # the whole flattened block jointly
    axis = int(attrs.get("axis", 1))
    shape = x.shape
    axis = axis % len(shape)
    lead = int(np.prod(shape[:axis])) if axis > 0 else 1
    return [fn(x.reshape(lead, -1), -1).reshape(shape)]


@handles("Softmax")
def _h_softmax(ctx, node, attrs, ins):
    return _softmax_like(ctx, node, attrs, ins, torch.softmax)


@handles("LogSoftmax")
def _h_logsoftmax(ctx, node, attrs, ins):
    return _softmax_like(ctx, node, attrs, ins, torch.log_softmax)


# -- matmul family -----------------------------------------------------------

@handles("MatMul")
def _h_matmul(ctx, node, attrs, ins):
    return [torch.matmul(ctx.tensor(ins[0]), ctx.tensor(ins[1]))]


@handles("Gemm")
def _h_gemm(ctx, node, attrs, ins):
    alpha = float(attrs.get("alpha", 1.0))
    beta = float(attrs.get("beta", 1.0))
    ta, tb = attrs.get("transA", 0), attrs.get("transB", 0)
    a, b = ctx.tensor(ins[0]), ctx.tensor(ins[1])
    y = torch.matmul(a.t() if ta else a, b.t() if tb else b)
    if alpha != 1.0:
        y = alpha * y
    if len(ins) > 2 and ins[2] is not None:
        c = ctx.tensor(ins[2])
        y = y + (beta * c if beta != 1.0 else c)
    return [y]


@handles("Einsum")
def _h_einsum(ctx, node, attrs, ins):
    return [torch.einsum(attrs["equation"], *[ctx.tensor(v) for v in ins])]


# -- shape lane --------------------------------------------------------------

@handles("Shape")
def _h_shape(ctx, node, attrs, ins):
    shape = np.asarray(_shape_of(ins[0]), np.int64)
    start = attrs.get("start", 0)
    end = attrs.get("end")
    return [shape[start:end]]


def _shape_of(v):
    return tuple(_host(v).shape) if _is_host(v) else tuple(v.shape)


@handles("Size")
def _h_size(ctx, node, attrs, ins):
    return [np.asarray(int(np.prod(_shape_of(ins[0]))), np.int64)]


@handles("Constant")
def _h_constant(ctx, node, attrs, ins):
    if "value" in attrs:
        return [attrs["value"]]
    for k in ("value_float", "value_int"):
        if k in attrs:
            return [np.asarray(attrs[k])]
    for k in ("value_floats", "value_ints"):
        if k in attrs:
            return [np.asarray(attrs[k])]
    raise ValueError("Constant node without a value attribute")


@handles("ConstantOfShape")
def _h_constant_of_shape(ctx, node, attrs, ins):
    shape = tuple(int(d) for d in _require_host(ins[0], node, "shape").reshape(-1))
    val = attrs.get("value")
    if val is None:
        val = np.zeros((1,), np.float32)
    return [np.full(shape, np.asarray(val).reshape(-1)[0])]


def _host_cast(x: np.ndarray, to: int) -> np.ndarray:
    if to == TensorProto.BFLOAT16:
        return torch.from_numpy(np.asarray(x, np.float32)).bfloat16() \
            .float().numpy()
    return x.astype(proto.tensor_dtype_to_np_dtype(to))


def _device_cast(ctx, x: torch.Tensor, to: int) -> torch.Tensor:
    if to in _FLOAT_TYPES:
        return x.to(ctx.dtype)
    return x.to(proto.tensor_dtype_to_torch_dtype(to))


@handles("Cast")
def _h_cast(ctx, node, attrs, ins):
    to = int(attrs["to"])
    (x,) = ins
    if _is_host(x):
        return [_host_cast(_host(x), to)]
    return [_device_cast(ctx, ctx.tensor(x), to)]


@handles("CastLike")
def _h_castlike(ctx, node, attrs, ins):
    x, like = ins
    if _is_host(like):
        to = proto.np_dtype_to_tensor_dtype(_host(like).dtype)
    else:
        to = proto.torch_dtype_to_tensor_dtype(like.dtype)
    if _is_host(x):
        return [_host_cast(_host(x), to)]
    return [_device_cast(ctx, ctx.tensor(x), to)]


@handles("Reshape")
def _h_reshape(ctx, node, attrs, ins):
    x = ins[0]
    target = [int(d) for d in _require_host(ins[1], node, "shape").reshape(-1)]
    allowzero = attrs.get("allowzero", 0)
    cur = _shape_of(x)
    shape = []
    for i, d in enumerate(target):
        if d == 0 and not allowzero:
            shape.append(cur[i])
        else:
            shape.append(d)
    if _is_host(x):
        return [_host(x).reshape(shape)]
    return [ctx.tensor(x).reshape(shape)]


@handles("Transpose")
def _h_transpose(ctx, node, attrs, ins):
    perm = attrs.get("perm")
    (x,) = ins
    if _is_host(x):
        return [np.transpose(_host(x), perm)]
    t = ctx.tensor(x)
    if perm is None:
        perm = list(reversed(range(t.dim())))
    return [t.permute(*perm)]


@handles("Flatten")
def _h_flatten(ctx, node, attrs, ins):
    axis = attrs.get("axis", 1)
    shape = _shape_of(ins[0])
    if axis < 0:
        axis += len(shape)
    lead = int(np.prod(shape[:axis])) if axis > 0 else 1
    return [ctx.tensor(ins[0]).reshape(lead, -1)]


def _axes_arg(node, attrs, ins, idx) -> Optional[List[int]]:
    """axes moved from attribute to input at opset 13 — accept both."""
    if len(ins) > idx and ins[idx] is not None:
        return [int(a) for a in _require_host(ins[idx], node, "axes").reshape(-1)]
    if "axes" in attrs:
        return [int(a) for a in attrs["axes"]]
    return None


@handles("Squeeze")
def _h_squeeze(ctx, node, attrs, ins):
    axes = _axes_arg(node, attrs, ins, 1)
    x = ins[0]
    if _is_host(x):
        return [np.squeeze(_host(x), tuple(axes) if axes else None)]
    t = ctx.tensor(x)
    if not axes:
        return [t.squeeze()]
    return [t.squeeze(tuple(a % t.dim() for a in axes))]


@handles("Unsqueeze")
def _h_unsqueeze(ctx, node, attrs, ins):
    axes = _axes_arg(node, attrs, ins, 1)
    x = ins[0]
    out = _host(x) if _is_host(x) else ctx.tensor(x)
    ndim_out = out.ndim + len(axes)
    for a in sorted(a % ndim_out for a in axes):
        out = np.expand_dims(out, a) if _is_host(x) else out.unsqueeze(a)
    return [out]


@handles("Concat")
def _h_concat(ctx, node, attrs, ins):
    axis = attrs["axis"]
    if all(_is_host(v) for v in ins):
        return [np.concatenate([_host(v) for v in ins], axis=axis)]
    return [torch.cat([ctx.tensor(v) for v in ins], axis)]


@handles("Split")
def _h_split(ctx, node, attrs, ins):
    axis = attrs.get("axis", 0)
    parts = None
    if len(ins) > 1 and ins[1] is not None:
        parts = [int(v) for v in _require_host(ins[1], node, "split").reshape(-1)]
    elif "split" in attrs:
        parts = [int(v) for v in attrs["split"]]
    n_out = len(node.output)
    t = ctx.tensor(ins[0])
    if parts is None:
        size = t.shape[axis]
        num = attrs.get("num_outputs", n_out)
        base = -(-size // num)  # ceil-div; last chunk smaller (maybe 0)
        parts = [base] * (num - 1) + [size - base * (num - 1)]
        if parts[-1] < 0:
            raise ValueError(
                f"Split: axis size {size} cannot fill {num} outputs of "
                f"chunk {base}")
    return list(torch.split(t, parts, axis))


def _slice_axis(ctx, t: torch.Tensor, axis: int, s: slice) -> torch.Tensor:
    """t[..., s, ...] along `axis`; a negative step (which torch's
    slicing refuses) picks its indices on the host."""
    if s.step is None or s.step > 0:
        return t[(slice(None),) * axis + (s,)]
    idx = np.arange(t.shape[axis], dtype=np.int64)[s]
    return t.index_select(axis, ctx.rep._upload(idx, None))


@handles("Slice")
def _h_slice(ctx, node, attrs, ins):
    x = ins[0]
    nd = len(_shape_of(x))
    if ctx.opset >= 10 or len(ins) > 1:
        starts = _require_host(ins[1], node, "starts").reshape(-1)
        ends = _require_host(ins[2], node, "ends").reshape(-1)
        axes = (_require_host(ins[3], node, "axes").reshape(-1)
                if len(ins) > 3 and ins[3] is not None
                else np.arange(len(starts)))
        steps = (_require_host(ins[4], node, "steps").reshape(-1)
                 if len(ins) > 4 and ins[4] is not None
                 else np.ones(len(starts), np.int64))
    else:
        starts = np.asarray(attrs["starts"])
        ends = np.asarray(attrs["ends"])
        axes = np.asarray(attrs.get("axes", list(range(len(starts)))))
        steps = np.ones(len(starts), np.int64)
    slices = [slice(None)] * nd
    int_max = np.iinfo(np.int64).max
    for s, e, a, st in zip(starts, ends, axes, steps):
        s, e, st = int(s), int(e), int(st)
        a = int(a) % nd
        # INT64_MAX / INT64_MIN are ONNX's "to the end" sentinels
        s_ = None if s in (int_max, -int_max - 1) else s
        e_ = None if e in (int_max, -int_max - 1) else e
        slices[a] = slice(s_, e_, st)
    if _is_host(x):
        return [_host(x)[tuple(slices)]]
    t = ctx.tensor(x)
    for a, s in enumerate(slices):
        if s != slice(None):
            t = _slice_axis(ctx, t, a, s)
    return [t]


def _wrap_indices(ctx, idx, n: int):
    """ONNX indices may be negative (counted from the end)."""
    if _is_host(idx):
        i = _host(idx).astype(np.int64)
        return ctx.rep._upload(np.where(i < 0, i + n, i), None)
    i = idx.long()
    return torch.where(i < 0, i + n, i)


@handles("Gather")
def _h_gather(ctx, node, attrs, ins):
    axis = attrs.get("axis", 0)
    data, idx = ins
    if _is_host(data) and _is_host(idx):
        return [np.take(_host(data), _host(idx).astype(np.int64), axis=axis)]
    # a float table is read as it is (an f32 master's rows are gathered
    # before the cast, as layer.Embedding does); its gradient is summed
    # in a fixed order by autograd.embedding
    t = data if isinstance(data, torch.Tensor) else ctx.tensor(data)
    axis = axis % t.dim()
    ishape = _shape_of(idx)
    i = _wrap_indices(ctx, idx, t.shape[axis])
    if axis == 0 and t.dim() == 2 and t.is_floating_point():
        out = autograd.embedding(t, i)
    else:
        out = t.index_select(axis, i.reshape(-1)).reshape(
            t.shape[:axis] + ishape + t.shape[axis + 1:])
    return [ctx.tensor(out)]


@handles("GatherElements")
def _h_gather_elements(ctx, node, attrs, ins):
    t = ctx.tensor(ins[0])
    axis = attrs.get("axis", 0) % t.dim()
    return [torch.gather(t, axis, _wrap_indices(ctx, ins[1], t.shape[axis]))]


@handles("Expand")
def _h_expand(ctx, node, attrs, ins):
    target = tuple(int(d) for d in _require_host(ins[1], node, "shape").reshape(-1))
    cur = _shape_of(ins[0])
    out_shape = np.broadcast_shapes(cur, target)
    if _is_host(ins[0]):
        return [np.broadcast_to(_host(ins[0]), out_shape)]
    return [ctx.tensor(ins[0]).expand(out_shape)]


@handles("Tile")
def _h_tile(ctx, node, attrs, ins):
    reps = tuple(int(d) for d in _require_host(ins[1], node, "repeats").reshape(-1))
    if _is_host(ins[0]):
        return [np.tile(_host(ins[0]), reps)]
    return [torch.tile(ctx.tensor(ins[0]), reps)]


@handles("Range")
def _h_range(ctx, node, attrs, ins):
    s, l, d = (_require_host(v, node, "range arg") for v in ins)
    return [np.arange(s.item(), l.item(), d.item())]


@handles("Where")
def _h_where(ctx, node, attrs, ins):
    cond, a, b = ins
    if all(_is_host(v) for v in ins):
        return [np.where(_host(cond), _host(a), _host(b))]
    c = ctx.tensor(cond)
    if c.dtype != torch.bool:
        c = c != 0
    return [torch.where(c, ctx.tensor(a), ctx.tensor(b))]


@handles("Trilu")
def _h_trilu(ctx, node, attrs, ins):
    upper = attrs.get("upper", 1)
    k = int(_require_host(ins[1], node, "k")) if len(ins) > 1 and ins[1] is not None else 0
    if _is_host(ins[0]):
        return [np.triu(_host(ins[0]), k) if upper else np.tril(_host(ins[0]), k)]
    t = ctx.tensor(ins[0])
    return [torch.triu(t, k) if upper else torch.tril(t, k)]


# -- recurrent ops (LSTM/GRU/RNN) -------------------------------------------
# ONNX layout=0 tensors: X (T, B, I); W (D, G*H, I); R (D, G*H, H);
# B (D, 2*G*H) = W-bias ++ R-bias; initial_h/c (D, B, H); outputs
# Y (T, D, B, H), Y_h/Y_c (D, B, H).  The time loop is a Python loop
# over T (a capture unrolls it) with the input projection hoisted out:
# one (T*B, I)x(I, G*H) matmul, then only the (B, H)x(H, G*H)
# recurrence runs step by step; torch autograd keeps it trainable.  The
# LSTM and RNN loops are ops.rnn's, which layer.LSTM and layer.RNN run.

_RNN_ACT = {"Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
            "Relu": torch.relu, "Affine": None}


def _rnn_common(node, attrs, ins, default_acts):
    """Shared decode/validation; returns (H, D, direction, acts, clip)."""
    H = int(attrs["hidden_size"])
    direction = attrs.get("direction", b"forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    if direction not in ("forward", "reverse", "bidirectional"):
        raise ValueError(f"{node.op_type}: bad direction {direction!r}")
    D = 2 if direction == "bidirectional" else 1
    if int(attrs.get("layout", 0)) != 0:
        raise ValueError(f"{node.op_type}: layout=1 is not supported")
    acts = attrs.get("activations")
    if acts:
        acts = [a.decode() if isinstance(a, bytes) else a for a in acts]
        for a in acts:
            if a not in _RNN_ACT or _RNN_ACT[a] is None:
                raise ValueError(f"{node.op_type}: activation {a!r} "
                                 "unsupported")
        want = len(default_acts) * D
        if len(acts) != want:
            raise ValueError(
                f"{node.op_type}: activations lists {len(acts)} names, "
                f"expected {want} ({len(default_acts)} per direction)")
    else:
        acts = default_acts * D
    clip = float(attrs["clip"]) if "clip" in attrs else None
    seq_lens = ins[4] if len(ins) > 4 else None
    if seq_lens is not None:
        sl = _require_host(seq_lens, node, "sequence_lens").reshape(-1)
        T = ins[0].shape[0] if hasattr(ins[0], "shape") else None
        if not np.all(sl == sl[0]) or (T is not None and sl[0] != T):
            raise ValueError(
                f"{node.op_type}: sequence_lens {sl.tolist()} != full "
                f"length {T} are not supported (ONNX requires zero "
                "padding + per-row final states, which need dynamic "
                "shapes)")
    if node.op_type == "LSTM" and len(ins) > 7 and ins[7] is not None:
        raise ValueError("LSTM: peephole weights (P) are not supported")
    return H, D, direction, acts, clip


def _rnn_scan(op_type, x, w, r, b, h0, c0, H, D, direction, acts, clip,
              linear_before_reset=0):
    """Run the recurrence; returns (Y, Y_h[, Y_c])."""
    T, Bs, _ = x.shape
    n_g = {"LSTM": 4, "GRU": 3, "RNN": 1}[op_type]
    acts_per_dir = {"LSTM": 3, "GRU": 2, "RNN": 1}[op_type]
    outs, hs, cs = [], [], []
    for d in range(D):
        rev = (direction == "reverse") or (d == 1)
        xd = x.flip(0) if rev else x
        wd, rd = w[d], r[d]                       # (G*H, I), (G*H, H)
        bd = b[d] if b is not None else x.new_zeros(2 * n_g * H)
        wb, rb = bd[:n_g * H], bd[n_g * H:]
        da = acts[d * acts_per_dir:(d + 1) * acts_per_dir]
        f_act = _RNN_ACT[da[0]]
        g_act = _RNN_ACT[da[1]] if len(da) > 1 else None
        h_act = _RNN_ACT[da[2]] if len(da) > 2 else None
        h = h0[d]
        c = c0[d] if c0 is not None else None

        def cl(v):
            return torch.clamp(v, -clip, clip) if clip is not None else v

        if op_type == "LSTM":
            pre = xd @ wd.t() + wb + rb           # (T, Bs, 4H)
            ys, h, c = rnn_ops.lstm_steps(pre, h, c, rd.t(),
                                          rnn_ops.ONNX_GATES, f_act, g_act,
                                          h_act, clip)
            cs.append(c)
        elif op_type == "GRU":
            ys = []
            pre = xd @ wd.t() + wb                # (T, Bs, 3H)
            rb_h, rd_h = rb[2 * H:3 * H], rd[2 * H:3 * H]
            rd_zr, rb_zr = rd[0:2 * H], rb[0:2 * H]
            for t in range(T):
                px = pre[t]
                if linear_before_reset:
                    # all three recurrent projections use un-gated h
                    hr = h @ rd.t() + rb          # (Bs, 3H)
                    z = f_act(cl(px[..., 0:H] + hr[..., 0:H]))
                    rr = f_act(cl(px[..., H:2 * H] + hr[..., H:2 * H]))
                    hh = g_act(cl(px[..., 2 * H:] + rr * hr[..., 2 * H:]))
                else:
                    # z/r fuse on un-gated h; the candidate needs (r*h)
                    hzr = h @ rd_zr.t() + rb_zr   # (Bs, 2H)
                    z = f_act(cl(px[..., 0:H] + hzr[..., 0:H]))
                    rr = f_act(cl(px[..., H:2 * H] + hzr[..., H:]))
                    hh = g_act(cl(px[..., 2 * H:] + (rr * h) @ rd_h.t()
                                  + rb_h))
                h = (1 - z) * hh + z * h
                ys.append(h)
            ys = torch.stack(ys)
        else:  # RNN
            pre = xd @ wd.t() + wb + rb           # (T, Bs, H)
            ys, h = rnn_ops.rnn_steps(pre, h, rd.t(), f_act, clip)
        outs.append(ys.flip(0) if rev else ys)
        hs.append(h)
    Y = torch.stack(outs, dim=1)                  # (T, D, Bs, H)
    Yh = torch.stack(hs, dim=0)                   # (D, Bs, H)
    if op_type == "LSTM":
        return Y, Yh, torch.stack(cs, dim=0)
    return Y, Yh


def _h_recurrent(ctx, node, attrs, ins, default_acts):
    H, D, direction, acts, clip = _rnn_common(node, attrs, ins,
                                              default_acts)
    lbr = int(attrs.get("linear_before_reset", 0))
    x, w, r = (ctx.tensor(v) for v in ins[:3])
    b = ctx.tensor(ins[3]) if len(ins) > 3 and ins[3] is not None else None
    zeros = x.new_zeros((D, x.shape[1], H))
    h0 = ctx.tensor(ins[5]) if len(ins) > 5 and ins[5] is not None else zeros
    c0 = None
    if node.op_type == "LSTM":
        c0 = ctx.tensor(ins[6]) if len(ins) > 6 and ins[6] is not None \
            else zeros
    outs = _rnn_scan(node.op_type, x, w, r, b, h0, c0, H, D, direction,
                     acts, clip, lbr)
    return list(outs)[:max(1, len(node.output))]


@handles("LSTM")
def _h_lstm(ctx, node, attrs, ins):
    return _h_recurrent(ctx, node, attrs, ins,
                        ["Sigmoid", "Tanh", "Tanh"])


@handles("GRU")
def _h_gru(ctx, node, attrs, ins):
    return _h_recurrent(ctx, node, attrs, ins, ["Sigmoid", "Tanh"])


@handles("RNN")
def _h_rnn(ctx, node, attrs, ins):
    return _h_recurrent(ctx, node, attrs, ins, ["Tanh"])


@handles("OneHot")
def _h_onehot(ctx, node, attrs, ins):
    axis = attrs.get("axis", -1)
    depth = int(_require_host(ins[1], node, "depth"))
    values = _require_host(ins[2], node, "values").reshape(-1)
    off, on = float(values[0]), float(values[1])
    idx = ctx.tensor(ins[0]).long()
    # ONNX: an index in [-depth, 0) counts from the end; one outside
    # [-depth, depth) matches no class, a row of `off`
    idx = torch.where(idx < 0, idx + depth, idx)
    oh = (idx.unsqueeze(-1) == torch.arange(depth, device=idx.device))
    oh = oh.to(ctx.dtype)
    if axis != -1:
        oh = oh.movedim(-1, axis % oh.dim())
    return [oh * (on - off) + off]


@handles("CumSum")
def _h_cumsum(ctx, node, attrs, ins):
    axis = int(_require_host(ins[1], node, "axis"))
    x = ctx.tensor(ins[0])
    if attrs.get("reverse", 0):
        x = x.flip(axis)
    y = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", 0):
        y = y - x
    return [y.flip(axis) if attrs.get("reverse", 0) else y]


@handles("Pad")
def _h_pad(ctx, node, attrs, ins):
    mode = attrs.get("mode", "constant")
    if len(ins) > 1 and ins[1] is not None:
        pads = [int(v) for v in _require_host(ins[1], node, "pads").reshape(-1)]
        cval = float(_require_host(ins[2], node, "value")) if len(ins) > 2 and ins[2] is not None else 0.0
    else:
        pads = [int(v) for v in attrs["pads"]]
        cval = float(attrs.get("value", 0.0))
    nd = len(pads) // 2
    x = ctx.tensor(ins[0])
    if mode == "constant":
        flat = []
        for i in reversed(range(nd)):
            flat += [pads[i], pads[i + nd]]
        return [F.pad(x, flat, value=cval)]
    # edge / reflect / wrap: numpy's np.pad of each axis's positions
    # gives the source index of every padded position
    for i in range(nd):
        if pads[i] or pads[i + nd]:
            src = np.pad(np.arange(x.shape[i]), (pads[i], pads[i + nd]),
                         mode=mode)
            x = x.index_select(i, ctx.rep._upload(src.astype(np.int64),
                                                  None))
    return [x]


# -- reductions --------------------------------------------------------------

def _reduce_all(fn):
    def run(x, axes, keepdims):
        return fn(x, dim=axes, keepdim=keepdims)
    return run


def _reduce_prod(x, axes, keepdims):
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _reduce_l2(x, axes, keepdims):
    return torch.sqrt(torch.sum(x * x, dim=axes, keepdim=keepdims))


_REDUCE = {
    "ReduceSum": _reduce_all(torch.sum),
    "ReduceMean": _reduce_all(torch.mean),
    "ReduceMax": _reduce_all(torch.amax),
    "ReduceMin": _reduce_all(torch.amin),
    "ReduceProd": _reduce_prod,
    "ReduceL2": _reduce_l2,
}


@handles(*_REDUCE)
def _h_reduce(ctx, node, attrs, ins):
    keepdims = bool(attrs.get("keepdims", 1))
    axes = _axes_arg(node, attrs, ins, 1)
    if axes is None and attrs.get("noop_with_empty_axes", 0):
        return [ctx.tensor(ins[0])]
    x = ctx.tensor(ins[0])
    ax = tuple(axes) if axes is not None else tuple(range(x.dim()))
    return [_REDUCE[node.op_type](x, ax, keepdims)]


@handles("ArgMax", "ArgMin")
def _h_argmax(ctx, node, attrs, ins):
    axis = attrs.get("axis", 0)
    keepdims = bool(attrs.get("keepdims", 1))
    fn = torch.argmax if node.op_type == "ArgMax" else torch.argmin
    return [fn(ctx.tensor(ins[0]), dim=axis, keepdim=keepdims)]


# -- NN ops ------------------------------------------------------------------

def _auto_pads(attrs, in_sp, k_sp, strides, dil, spatial, one_d):
    eff_k = [(k - 1) * d + 1 for k, d in zip(k_sp, dil)]
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads_attr = list(attrs.get("pads", [0] * (2 * spatial)))
        if one_d and len(pads_attr) == 2:
            pads_attr = [0, pads_attr[0], 0, pads_attr[1]]
        return [(pads_attr[i], pads_attr[i + spatial]) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    pads = []
    for i in range(spatial):
        rem = in_sp[i] % strides[i]
        total = max(0, eff_k[i] - (rem if rem else strides[i]))
        lo, hi = total // 2, total - total // 2
        pads.append((lo, hi) if auto == "SAME_UPPER" else (hi, lo))
    return pads


@handles("Conv")
def _h_conv(ctx, node, attrs, ins):
    """ONNX Conv is NCHW/OIHW, which torch's conv2d takes as it is; a
    1-D conv lifts to H = 1."""
    x = ctx.tensor(ins[0])
    w = ctx.tensor(ins[1])
    b = ctx.tensor(ins[2]) if len(ins) > 2 and ins[2] is not None else None
    spatial = x.dim() - 2
    one_d = spatial == 1
    if one_d:  # lift 1-D conv to H=1 2-D
        x = x.unsqueeze(2)   # N C 1 W
        w = w.unsqueeze(2)   # O I 1 K
        spatial = 2
    if spatial != 2:
        raise ValueError(f"Conv: only 1-D/2-D supported, got {spatial}-D")
    strides = list(attrs.get("strides", [1] * spatial))
    dil = list(attrs.get("dilations", [1] * spatial))
    groups = int(attrs.get("group", 1))
    if one_d:
        strides = [1] + strides if len(strides) == 1 else strides
        dil = [1] + dil if len(dil) == 1 else dil
    (pt, pb), (pl, pr) = _auto_pads(attrs, x.shape[2:], w.shape[2:],
                                    strides, dil, spatial, one_d)
    if pt != pb or pl != pr:
        x = F.pad(x, (pl, pr, pt, pb))
        pt = pl = 0
    y = F.conv2d(x, w, b, tuple(strides), (pt, pl), tuple(dil), groups)
    return [y.squeeze(2) if one_d else y]


@handles("MaxPool", "AveragePool")
def _h_pool(ctx, node, attrs, ins):
    x = ctx.tensor(ins[0])
    if x.dim() != 4:
        raise ValueError("MaxPool/AveragePool: 2-D only")
    kernel = tuple(attrs["kernel_shape"])
    strides = tuple(attrs.get("strides", kernel))
    pads = list(attrs.get("pads", [0, 0, 0, 0]))
    if attrs.get("ceil_mode", 0):
        raise ValueError("pool ceil_mode=1 not supported (static shapes)")
    if pads[0] != pads[2] or pads[1] != pads[3]:
        raise ValueError("asymmetric pool padding not supported")
    if pads[0] != pads[1]:
        raise ValueError("non-square pool padding not supported")
    p = pads[0]
    if node.op_type == "MaxPool":
        if p > min(kernel) // 2:     # wider than torch's pools take
            return [F.max_pool2d(F.pad(x, (p,) * 4, value=float("-inf")),
                                 kernel, strides)]
        return [F.max_pool2d(x, kernel, strides, p)]
    include = bool(attrs.get("count_include_pad", 0)) or p == 0
    if p <= min(kernel) // 2:
        return [F.avg_pool2d(x, kernel, strides, p, count_include_pad=include)]
    xp = F.pad(x, (p,) * 4)
    s = F.avg_pool2d(xp, kernel, strides)
    if include:
        return [s]
    # ONNX default count_include_pad=0: denominator excludes padding
    cnt = F.avg_pool2d(F.pad(torch.ones_like(x), (p,) * 4), kernel, strides)
    return [s / cnt]


@handles("GlobalAveragePool")
def _h_gap(ctx, node, attrs, ins):
    x = ctx.tensor(ins[0])
    return [x.mean(dim=tuple(range(2, x.dim())), keepdim=True)]


@handles("GlobalMaxPool")
def _h_gmp(ctx, node, attrs, ins):
    x = ctx.tensor(ins[0])
    return [x.amax(dim=tuple(range(2, x.dim())), keepdim=True)]


def _reject_consumed_aux(ctx, node):
    used = [n for n in node.output[1:] if n and n in ctx.consumed]
    if used:
        raise NotImplementedError(
            f"{node.op_type}: auxiliary outputs {used} are consumed by the "
            f"graph but this importer only computes the primary output "
            f"(training-graph stats are not supported)")


def _channel(v: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over NC... axis 1."""
    return v.reshape((1, -1) + (1,) * (nd - 2))


@handles("BatchNormalization")
def _h_batchnorm(ctx, node, attrs, ins):
    eps = float(attrs.get("epsilon", 1e-5))
    x = ctx.tensor(ins[0])
    s, b, m, v = (_channel(ctx.tensor(t, torch.float32), x.dim())
                  for t in ins[1:5])
    y = ((x.float() - m) * torch.rsqrt(v + eps) * s + b).to(x.dtype)
    # training-mode extra outputs (running stats) are not produced; the
    # importer targets inference graphs (training uses layer.BatchNorm2d)
    _reject_consumed_aux(ctx, node)
    return [y] + [None] * (len(node.output) - 1)


@handles("LayerNormalization")
def _h_layernorm(ctx, node, attrs, ins):
    eps = float(attrs.get("epsilon", 1e-5))
    axis = attrs.get("axis", -1)
    x = ctx.tensor(ins[0])
    scale = ctx.tensor(ins[1])
    bias = ctx.tensor(ins[2]) if len(ins) > 2 and ins[2] is not None else None
    axes = tuple(range(axis % x.dim(), x.dim()))
    # autograd.layernorm's arithmetic, over `axes`: f32 statistics,
    # gamma and beta in the compute dtype
    xf = x.float()
    mu = xf.mean(dim=axes, keepdim=True)
    var = (xf - mu).square().mean(dim=axes, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale
    if bias is not None:
        y = y + bias
    _reject_consumed_aux(ctx, node)  # Mean/InvStdDev outputs not computed
    return [y.to(x.dtype)] + [None] * (len(node.output) - 1)


@handles("InstanceNormalization")
def _h_instancenorm(ctx, node, attrs, ins):
    eps = float(attrs.get("epsilon", 1e-5))
    x = ctx.tensor(ins[0])
    s, b = (_channel(ctx.tensor(t, torch.float32), x.dim()) for t in ins[1:3])
    axes = tuple(range(2, x.dim()))
    xf = x.float()
    mu = xf.mean(dim=axes, keepdim=True)
    var = (xf - mu).square().mean(dim=axes, keepdim=True)
    return [((xf - mu) * torch.rsqrt(var + eps) * s + b).to(x.dtype)]


@handles("Dropout")
def _h_dropout(ctx, node, attrs, ins):
    x = ctx.tensor(ins[0])
    ratio = float(attrs.get("ratio", 0.5))
    if len(ins) > 1 and ins[1] is not None:
        ratio = float(_require_host(ins[1], node, "ratio"))
    train = False
    if len(ins) > 2 and ins[2] is not None:
        train = bool(_require_host(ins[2], node, "training_mode"))
    y = x
    if train and ctx.training:
        y = autograd.dropout(x, ratio, ctx.rep.dropout.generator)
    outs = [y]
    if len(node.output) > 1:
        outs.append(np.ones(x.shape, np.bool_))
    return outs


# ---------------------------------------------------------------------------
# the backend rep
# ---------------------------------------------------------------------------

class SingaRep(model_mod.Model):
    """An imported ONNX graph as a port model.

    `run(inputs)` mirrors the reference backend-rep surface; because this
    is a ``model.Model``, ``compile()`` + graph mode captures the whole
    imported network as one CUDA graph on the card, and float
    initializers are trainable parameters (training-capable import)."""

    def __init__(self, model_proto: ModelProto, device=None,
                 init_inputs: Optional[Sequence] = None, name: str = "onnx"):
        if isinstance(device, str):
            device = create_device(device)
        super().__init__(name, device=device)
        self.proto_model = model_proto
        g = model_proto.graph
        if g is None:
            raise ValueError("ModelProto has no graph")
        self.onnx_graph = g
        self.opset = 18
        for op in model_proto.opset_import:
            if (op.domain or "") == "":
                self.opset = int(op.version or 18)
        unsupported = sorted({n.op_type for n in g.node if n.op_type not in _HANDLERS})
        if unsupported:
            raise NotImplementedError(
                f"unsupported ONNX ops: {unsupported}; supported: "
                f"{supported_ops()}")
        # initializers → params (float ⇒ trainable f32 masters) / constants
        self._consts: Dict[str, Any] = {}
        self._param_alias: Dict[str, str] = {}
        dev = self.device.torch_device
        for init in g.initializer:
            arr = _numpy(to_array(init))
            # 0-d float initializers are scale/eps constants, not weights
            if np.issubdtype(arr.dtype, np.floating) and arr.ndim > 0:
                pname = _sanitize(init.name)
                if pname in self._param_alias.values():
                    raise ValueError(f"initializer {init.name!r} sanitizes "
                                     f"to the taken name {pname!r}")
                self.register_parameter(pname, nn.Parameter(
                    torch.from_numpy(arr.astype(np.float32)).to(dev)))
                self._param_alias[init.name] = pname
            else:
                self._consts[init.name] = arr
        init_names = ({i.name for i in g.initializer})
        self.input_names = [vi.name for vi in g.input if vi.name not in init_names]
        self.output_names = [vi.name for vi in g.output]
        self._consumed = set(self.output_names)
        for n in g.node:
            self._consumed.update(i for i in n.input if i)
        self._node_attrs = [_attrs(n) for n in g.node]
        # the generator training-mode Dropout nodes draw from (p only
        # marks that the graph draws; each node passes its own ratio)
        if any(n.op_type == "Dropout" for n in g.node):
            self.dropout = layer.Dropout(1.0, device=self.device)
        self._uploads: Dict[Any, torch.Tensor] = {}

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype float values compute in: the device's default."""
        return self.device.default_dtype

    def _upload(self, arr: np.ndarray,
                float_dtype: Optional[torch.dtype]) -> torch.Tensor:
        """A host constant on the device, made once: floats in
        `float_dtype` (default: the compute dtype)."""
        arr = np.asarray(arr)
        dtype = None
        if np.issubdtype(arr.dtype, np.floating):
            dtype = float_dtype or self.compute_dtype
        key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype)
        t = self._uploads.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device.torch_device)
            if dtype is not None:
                t = t.to(dtype)
            self._uploads[key] = t
        return t

    def _input(self, v) -> torch.Tensor:
        t = torch.as_tensor(v if isinstance(v, torch.Tensor)
                            else np.asarray(v),
                            device=self.device.torch_device)
        return t.to(self.compute_dtype) if t.is_floating_point() else t

    # -- execution ------------------------------------------------------------
    def forward(self, *inputs):
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"{self.input_names}, got {len(inputs)}")
        ctx = _Ctx(self, autograd.is_training())
        env: Dict[str, Any] = dict(self._consts)
        for onnx_name, pname in self._param_alias.items():
            env[onnx_name] = getattr(self, pname)
        for name, v in zip(self.input_names, inputs):
            env[name] = self._input(v)
        for node, attrs in zip(self.onnx_graph.node, self._node_attrs):
            ins = [env[i] if i else None for i in node.input]
            outs = _HANDLERS[node.op_type](ctx, node, attrs, ins)
            for name, v in zip(node.output, outs):
                if name and v is not None:
                    env[name] = v
        outs = [ctx.tensor(env[name]) for name in self.output_names]
        return outs[0] if len(outs) == 1 else tuple(outs)

    def run(self, inputs: Sequence) -> List[torch.Tensor]:
        """Reference backend-rep surface: list in, list of tensors out."""
        out = self(*inputs)
        return list(out) if isinstance(out, tuple) else [out]


def _sanitize(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out or "param"


class SingaBackend:
    """onnx-backend-style entry (reference `sonnx.SingaBackend`)."""

    @staticmethod
    def supports_device(device: str) -> bool:
        return True

    @staticmethod
    def prepare(model_proto: ModelProto, device=None, **kwargs) -> SingaRep:
        return SingaRep(model_proto, device=device, **kwargs)


def prepare(model_proto: Union[ModelProto, bytes, str], device=None,
            **kwargs) -> SingaRep:
    """Import an ONNX model (path / bytes / ModelProto) for execution and
    training on the port.  `device`: a port ``Device`` or a kind for
    ``device.create_device`` ('cpu', 'cuda'); None is the default
    device, the card (which raises without one)."""
    if isinstance(model_proto, (bytes, bytearray)):
        model_proto = ModelProto.FromString(bytes(model_proto))
    elif isinstance(model_proto, str):
        model_proto = proto.load(model_proto)
    return SingaBackend.prepare(model_proto, device=device, **kwargs)
