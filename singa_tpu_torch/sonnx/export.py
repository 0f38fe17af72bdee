"""sonnx export — port model → ONNX ModelProto, ported from
``singa_tpu/sonnx/export.py``.

Mechanism: run one forward pass (eval mode, no gradients) under a
recorder, a ``torch.overrides.TorchFunctionMode`` that logs each torch
call with the identity of its input and output tensors, as the
reference's tape of ``Operator`` calls does; then map each recorded call
to ONNX node(s).  Functions marked ``@unit`` (``singa_tpu_torch._unit``:
``autograd.linear``, ``embedding``, ``cast``, ``layernorm``,
``rmsnorm``, ``gelu``, ``softmax``, ``log_softmax``, ``conv2d``, the
pools, ``batchnorm``, ``ops.attention.attention``, ``ops.rnn.scan`` and
the ``autograd.<name>`` functions) are recorded as one call each, and
the torch calls inside them are not.  Raw torch calls have rules for
what the port's models call (arithmetic, comparisons, ``matmul``,
reshapes, transposes, basic indexing, ``cat``, ``chunk``,
``sum``/``mean``, ``relu``/``tanh``/``sigmoid``/``silu``, casts); any
other traced call raises.  Dropout exports as nothing: the
trace runs in eval, where it returns its input.

Only calls that read a tracked tensor are recorded: the graph inputs,
the parameters and buffers (bound by their ``get_params()`` /
``_get_buffers()`` names) and every recorded call's outputs.  Anything
else — ``torch.arange`` positions, ``zeros_like`` token types, a mask
built from constants — is a trace-time constant and becomes an
initializer where a recorded call reads it, as the reference's leaves
never seen do.  Calls that only read shapes (``zeros_like``,
``new_zeros``, ...) and calls that return their input (``as_tensor`` on
the right device, ``to`` the same dtype, dropout in eval) record
nothing.

Layout: the port's conv/pool/batchnorm compute in NHWC with HWIO
kernels, as the reference's; ONNX's are NCHW, so they export wrapped in
Transpose pairs, with the kernel transposed HWIO→OIHW in the graph.
Attention exports as the reference's decomposition (MatMul / Mul(scale)
/ Where(mask) / Softmax / MatMul, GQA by tiling kv heads), its scale
and masking constants in the traced activation dtype.  ``layer.LSTM``
and ``layer.RNN`` (``ops.rnn.scan``, one unit) export as real ONNX
``LSTM`` / ``RNN`` nodes, their weights converted to ONNX's layout and
gate order in the graph.  The rest of ``autograd``'s functions are
units ``autograd.<name>`` with the reference's ONNX forms (one node, or
a fixed decomposition such as float ``mod``'s); those the reference
cannot export (``repeat``, ``tensordot``, ``onehot``, ``reduce_prod``,
``shape_of``, the losses) raise here too.
"""

from __future__ import annotations

import inspect
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from .. import _unit, autograd
from . import proto
from .proto import TensorProto, make_model, make_node, make_tensor_value_info

__all__ = ["to_onnx", "export", "save"]


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _tensors(obj) -> List[torch.Tensor]:
    """Tensors in (nested lists/tuples/dicts of) call arguments."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _func_name(func) -> str:
    name = getattr(func, "__name__", "")
    if name == "__get__":                 # a property: Tensor.T, .data
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    if name.startswith("__") and name.endswith("__"):
        name = name[2:-2]
    return name


#: calls whose outputs depend on their inputs' shapes only
_SHAPE_ONLY = {"zeros_like", "ones_like", "empty_like", "full_like",
               "new_zeros", "new_ones", "new_empty", "new_full"}


#: the augmented assignments (x += y, ...) of Tensor
_INPLACE = {"iadd", "isub", "imul", "itruediv", "ifloordiv", "ipow",
            "imatmul", "iand", "ior", "ixor"}


class _Op:
    """One recorded call: `kind`, its arguments (positional `args` and
    `kwargs` for a raw torch call; `bound`, the named arguments, for a
    unit), the tensors it read and those it returned."""

    def __init__(self, kind, args, kwargs, bound, ins, outs):
        self.kind, self.args, self.kwargs, self.bound = \
            kind, args, kwargs, bound
        self.ins, self.outs = ins, outs


class _Recorder(TorchFunctionMode):
    def __init__(self, tracked: Sequence[torch.Tensor]):
        super().__init__()
        self.tape: List[_Op] = []
        self.tracked = {id(t) for t in tracked}
        self.keep = list(tracked)
        self.inside = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.inside:
            self._note(_func_name(func), args, kwargs, None,
                       _tensors((args, kwargs)), out)
        return out

    def unit(self, kind: str, fn: Callable, args, kwargs):
        if self.inside:
            return fn(*args, **kwargs)
        self.inside += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self.inside -= 1
        bound = inspect.signature(fn).bind(*args, **kwargs)
        bound.apply_defaults()
        self._note(kind, args, kwargs, dict(bound.arguments),
                   _tensors((args, kwargs)), out)
        return out

    def _note(self, kind, args, kwargs, bound, ins, out):
        if not any(id(t) in self.tracked for t in ins):
            return                      # a trace-time constant
        outs = _tensors(out)
        if not outs or kind in _SHAPE_ONLY:
            return
        if all(any(o is i for i in ins) for o in outs):
            return                      # the call returned its input
        if kind.endswith("_") or kind in _INPLACE:
            raise NotImplementedError(
                f"sonnx export: in-place torch call {kind!r} on a traced "
                f"tensor has no ONNX form")
        self.tape.append(_Op(kind, args, kwargs, bound, ins, tuple(outs)))
        self.keep.append((args, kwargs, out))
        self.tracked.update(id(o) for o in outs)


# ---------------------------------------------------------------------------
# the exporter: names, initializers, nodes
# ---------------------------------------------------------------------------

class _Exporter:
    def __init__(self):
        self.nodes: List[proto.NodeProto] = []
        self.initializers: List[TensorProto] = []
        self.names: Dict[int, str] = {}      # id(tensor) -> graph name
        self._counter = 0
        self._used: set = set()

    # -- naming ---------------------------------------------------------------
    def fresh(self, hint: str = "t") -> str:
        self._counter += 1
        name = f"{hint}_{self._counter}"
        while name in self._used:
            self._counter += 1
            name = f"{hint}_{self._counter}"
        self._used.add(name)
        return name

    def name_of(self, t: torch.Tensor) -> str:
        n = self.names.get(id(t))
        if n is None:
            # never traced: a trace-time constant — emit as initializer
            n = self.fresh("const")
            self.names[id(t)] = n
            self.initializers.append(proto.from_array(t.detach().cpu(), n))
        return n

    def bind(self, t: torch.Tensor, name: str) -> None:
        self.names[id(t)] = name
        self._used.add(name)

    def add_init(self, arr, hint: str) -> str:
        n = self.fresh(hint)
        self.initializers.append(proto.from_array(arr, n))
        return n

    def ints(self, vals, hint: str) -> str:
        return self.add_init(np.asarray(vals, np.int64), hint)

    def emit(self, op_type: str, ins: Sequence[str], outs: Sequence[str],
             **attrs) -> None:
        self.nodes.append(make_node(op_type, ins, outs,
                                    name=self.fresh(op_type.lower()), **attrs))

    def operand(self, v, dtype: torch.dtype) -> str:
        """The name of `v` in `dtype`: a tensor (Cast when its dtype
        differs) or a Python scalar (an initializer)."""
        if isinstance(v, torch.Tensor):
            n = self.name_of(v)
            if v.dtype != dtype:
                c = self.fresh("cast")
                self.emit("Cast", [n], [c],
                          to=proto.torch_dtype_to_tensor_dtype(dtype))
                return c
            return n
        return self.add_init(torch.tensor(v, dtype=dtype), "scalar")

    def outn(self, op: _Op) -> List[str]:
        return [self.names[id(o)] for o in op.outs]


# ---------------------------------------------------------------------------
# export rules: fn(ex, op) -> None (op.outs already have names)
# ---------------------------------------------------------------------------

_EXPORT: Dict[str, Callable] = {}


def _exports(*kinds):
    def deco(fn):
        for k in kinds:
            _EXPORT[k] = fn
        return fn
    return deco


def _x(op: _Op) -> torch.Tensor:
    """The first argument (the tensor a method was called on)."""
    return op.args[0]


_UNARY = {"relu": "Relu", "tanh": "Tanh", "sigmoid": "Sigmoid"}


@_exports(*_UNARY)
def _e_unary(ex, op):
    ex.emit(_UNARY[op.kind], [ex.name_of(_x(op))], ex.outn(op))


@_exports("silu")
def _e_silu(ex, op):
    x = ex.name_of(_x(op))
    mid = ex.fresh("sig")
    ex.emit("Sigmoid", [x], [mid])
    ex.emit("Mul", [x, mid], ex.outn(op))


# name -> (ONNX op, operands swapped)
_BINARY = {
    "add": ("Add", False), "radd": ("Add", True),
    "sub": ("Sub", False), "rsub": ("Sub", True),
    "mul": ("Mul", False), "rmul": ("Mul", True),
    "div": ("Div", False), "truediv": ("Div", False),
    "rtruediv": ("Div", True),
    "eq": ("Equal", False), "gt": ("Greater", False),
    "ge": ("GreaterOrEqual", False), "lt": ("Less", False),
    "le": ("LessOrEqual", False),
}


@_exports(*_BINARY)
def _e_binary(ex, op):
    onnx_op, swap = _BINARY[op.kind]
    a, b = op.args[0], op.args[1] if len(op.args) > 1 else op.kwargs["other"]
    if op.kwargs.get("alpha", 1) != 1 or op.kwargs.get("rounding_mode"):
        raise NotImplementedError(
            f"sonnx export: {op.kind} with alpha / rounding_mode")
    if swap:
        a, b = b, a
    # operands in the dtype torch computed in (a Cast where one differs)
    dt = torch.result_type(a, b)
    if onnx_op == "Div" and not dt.is_floating_point:
        dt = op.outs[0].dtype        # true division of integers
    ex.emit(onnx_op, [ex.operand(a, dt), ex.operand(b, dt)], ex.outn(op))


@_exports("matmul")
def _e_matmul(ex, op):
    dt = op.outs[0].dtype
    ex.emit("MatMul", [ex.operand(op.args[0], dt), ex.operand(op.args[1], dt)],
            ex.outn(op))


@_exports("reshape", "view", "flatten", "squeeze", "unsqueeze")
def _e_reshape(ex, op):
    # a bijective reshape whose output shape is static at export
    sh = ex.ints(list(op.outs[0].shape), "shape")
    ex.emit("Reshape", [ex.name_of(_x(op)), sh], ex.outn(op))


def _perm(op: _Op) -> List[int]:
    nd = _x(op).dim()
    if op.kind == "t":
        return list(reversed(range(nd)))
    if op.kind == "permute":
        dims = op.args[1:] if len(op.args) > 1 else op.kwargs["dims"]
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = dims[0]
        return [d % nd for d in dims]
    d0, d1 = op.args[1:3] if len(op.args) == 3 else \
        (op.kwargs["dim0"], op.kwargs["dim1"])         # transpose
    perm = list(range(nd))
    perm[d0 % nd], perm[d1 % nd] = perm[d1 % nd], perm[d0 % nd]
    return perm


@_exports("t", "permute", "transpose")
def _e_transpose(ex, op):
    ex.emit("Transpose", [ex.name_of(_x(op))], ex.outn(op), perm=_perm(op))


@_exports("contiguous", "clone", "to", "float", "half", "bfloat16")
def _e_identity_or_cast(ex, op):
    x, out = _x(op), op.outs[0]
    if out.dtype != x.dtype:
        ex.emit("Cast", [ex.name_of(x)], ex.outn(op),
                to=proto.torch_dtype_to_tensor_dtype(out.dtype))
    else:
        ex.emit("Identity", [ex.name_of(x)], ex.outn(op))


@_exports("cast")
def _e_cast(ex, op):
    ex.emit("Cast", [ex.name_of(op.bound["x"])], ex.outn(op),
            to=proto.torch_dtype_to_tensor_dtype(op.bound["dtype"]))


@_exports("getitem")
def _e_getitem(ex, op):
    x, idx = op.args[0], op.args[1]
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not all(s is None or s is Ellipsis or isinstance(s, (slice, int))
               for s in idx):
        raise NotImplementedError(
            "ONNX export of advanced (tensor) indexing is unsupported")
    if Ellipsis in idx:
        i = idx.index(Ellipsis)
        used = sum(s is not None for s in idx) - 1
        idx = idx[:i] + (slice(None),) * (x.dim() - used) + idx[i + 1:]
    i64 = np.iinfo(np.int64)
    starts, ends, axes, steps, squeeze = [], [], [], [], []
    a = 0
    for s in idx:
        if s is None:
            continue
        if isinstance(s, int):
            starts.append(s)
            ends.append(s + 1 if s != -1 else i64.max)
            axes.append(a)
            steps.append(1)
            squeeze.append(a)
        elif s != slice(None):
            step = 1 if s.step is None else s.step
            starts.append(0 if s.start is None else s.start)
            ends.append(i64.max if s.stop is None else s.stop)
            axes.append(a)
            steps.append(step)
        a += 1
    # ints drop their axes and None adds one: a Reshape to the output's
    # static shape after the Slice
    reshape = bool(squeeze) or None in idx or not starts
    outn = ex.outn(op)
    cur = ex.name_of(x)
    if starts:
        sliced = ex.fresh("sliced") if reshape else outn[0]
        ex.emit("Slice", [cur, ex.ints(starts, "starts"),
                          ex.ints(ends, "ends"), ex.ints(axes, "axes"),
                          ex.ints(steps, "steps")], [sliced])
        cur = sliced
    if reshape:
        ex.emit("Reshape", [cur, ex.ints(list(op.outs[0].shape), "shape")],
                outn)


@_exports("cat")
def _e_cat(ex, op):
    ts = op.args[0]
    dim = op.args[1] if len(op.args) > 1 else op.kwargs.get("dim", 0)
    dt = op.outs[0].dtype
    ex.emit("Concat", [ex.operand(t, dt) for t in ts], ex.outn(op),
            axis=int(dim))


@_exports("split", "chunk")
def _e_split(ex, op):
    x = _x(op)
    dim = op.args[2] if len(op.args) > 2 else op.kwargs.get("dim", 0)
    dim = dim % x.dim()
    parts = [o.shape[dim] for o in op.outs]
    ex.emit("Split", [ex.name_of(x), ex.ints(parts, "split")], ex.outn(op),
            axis=dim)


def _reduce_axes(op: _Op, x: torch.Tensor):
    dim = op.args[1] if len(op.args) > 1 else op.kwargs.get("dim")
    keep = op.args[2] if len(op.args) > 2 else op.kwargs.get("keepdim", False)
    if dim is None:
        return None, bool(keep)
    dims = [dim] if isinstance(dim, int) else list(dim)
    return [d % x.dim() for d in dims], bool(keep)


_REDUCE = {"sum": "ReduceSum", "mean": "ReduceMean"}


@_exports(*_REDUCE)
def _e_reduce(ex, op):
    x = _x(op)
    axes, keep = _reduce_axes(op, x)
    ins = [ex.name_of(x)]
    if axes is not None:
        ins.append(ex.ints(axes, "axes"))
    ex.emit(_REDUCE[op.kind], ins, ex.outn(op), keepdims=int(keep))


# -- units -------------------------------------------------------------------

@_exports("softmax", "log_softmax")
def _e_softmax(ex, op):
    ex.emit("Softmax" if op.kind == "softmax" else "LogSoftmax",
            [ex.name_of(op.bound["x"])], ex.outn(op),
            axis=int(op.bound["axis"]))

@_exports("linear")
def _e_linear(ex, op):
    a = op.bound
    x, w, b = a["x"], a["w"], a["b"]
    ins = [ex.name_of(x), ex.name_of(w)]
    if x.dim() == 2:
        if b is not None:
            ex.emit("Gemm", ins + [ex.name_of(b)], ex.outn(op))
        else:
            ex.emit("MatMul", ins, ex.outn(op))
        return
    mm = ex.fresh("mm") if b is not None else ex.outn(op)[0]
    ex.emit("MatMul", ins, [mm])
    if b is not None:
        ex.emit("Add", [mm, ex.name_of(b)], ex.outn(op))


@_exports("embedding")
def _e_embedding(ex, op):
    ex.emit("Gather", [ex.name_of(op.bound["table"]),
                       ex.name_of(op.bound["ids"])], ex.outn(op), axis=0)


@_exports("layernorm")
def _e_layernorm(ex, op):
    a = op.bound
    ex.emit("LayerNormalization",
            [ex.name_of(a["x"]), ex.name_of(a["gamma"]),
             ex.name_of(a["beta"])], ex.outn(op),
            axis=-1, epsilon=float(a["eps"]))


@_exports("rmsnorm")
def _e_rmsnorm(ex, op):
    # decompose: y = x / sqrt(mean(x^2) + eps) * gamma  (portable ONNX)
    a = op.bound
    x, gamma = ex.name_of(a["x"]), ex.name_of(a["gamma"])
    sq = ex.fresh("sq")
    ex.emit("Mul", [x, x], [sq])
    mean = ex.fresh("ms")
    ex.emit("ReduceMean", [sq, ex.ints([-1], "axes")], [mean], keepdims=1)
    epsn = ex.add_init(torch.tensor(a["eps"], dtype=a["x"].dtype), "eps")
    shifted = ex.fresh("ms_eps")
    ex.emit("Add", [mean, epsn], [shifted])
    rt = ex.fresh("sqrt")
    ex.emit("Sqrt", [shifted], [rt])
    normed = ex.fresh("normed")
    ex.emit("Div", [x, rt], [normed])
    ex.emit("Mul", [normed, gamma], ex.outn(op))


@_exports("gelu")
def _e_gelu(ex, op):
    ex.emit("Gelu", [ex.name_of(op.bound["x"])], ex.outn(op),
            approximate="tanh" if op.bound["approximate"] else "none")


def _nhwc_in(ex, name):
    out = ex.fresh("nchw")
    ex.emit("Transpose", [name], [out], perm=[0, 3, 1, 2])
    return out


def _nhwc_out(ex, nchw_name, final_name):
    ex.emit("Transpose", [nchw_name], [final_name], perm=[0, 2, 3, 1])


@_exports("conv2d")
def _e_conv(ex, op):
    a = op.bound
    x, w, b = a["x"], a["w"], a["b"]
    stride, dilation = autograd._pair(a["stride"]), autograd._pair(a["dilation"])
    (pt, pb), (pl, pr) = autograd._conv_pads(a["padding"], x.shape[1:3],
                                             w.shape[:2], stride, dilation)
    x_nchw = _nhwc_in(ex, ex.name_of(x))
    # the kernel is stored HWIO (the port's layout) — re-emit as OIHW
    w_t = ex.fresh("w_oihw")
    ex.emit("Transpose", [ex.name_of(w)], [w_t], perm=[3, 2, 0, 1])
    ins = [x_nchw, w_t] + ([ex.name_of(b)] if b is not None else [])
    y = ex.fresh("conv_out")
    ex.emit("Conv", ins, [y], strides=list(stride),
            dilations=list(dilation), group=int(a["groups"]),
            pads=[pt, pl, pb, pr])
    _nhwc_out(ex, y, ex.outn(op)[0])


@_exports("max_pool2d", "avg_pool2d")
def _e_pool(ex, op):
    a = op.bound
    kernel = autograd._pair(a["kernel"])
    stride = autograd._pair(a["stride"] or kernel)
    p = int(a["padding"])
    x_nchw = _nhwc_in(ex, ex.name_of(a["x"]))
    y = ex.fresh("pool_out")
    attrs = dict(kernel_shape=list(kernel), strides=list(stride),
                 pads=[p, p, p, p])
    is_max = op.kind == "max_pool2d"
    if not is_max:
        # the port's avg_pool2d divides by the full window
        attrs["count_include_pad"] = 1
    ex.emit("MaxPool" if is_max else "AveragePool", [x_nchw], [y], **attrs)
    _nhwc_out(ex, y, ex.outn(op)[0])


@_exports("batchnorm")
def _e_batchnorm(ex, op):
    a = op.bound
    x = a["x"]
    stats = [ex.name_of(a[k]) for k in ("gamma", "beta", "mean", "var")]
    # channels are x's last axis; ONNX's are axis 1
    perm = None if x.dim() == 2 else [0, x.dim() - 1] + list(range(1, x.dim() - 1))
    xin = ex.name_of(x)
    if perm is not None:
        xin = ex.fresh("nchw")
        ex.emit("Transpose", [ex.name_of(x)], [xin], perm=perm)
    y = ex.outn(op)[0] if perm is None else ex.fresh("bn_out")
    ex.emit("BatchNormalization", [xin] + stats, [y],
            epsilon=float(a["eps"]))
    if perm is not None:
        ex.emit("Transpose", [y], ex.outn(op),
                perm=[int(i) for i in np.argsort(perm)])


@_exports("attention")
def _e_attention(ex, op):
    """Attention → portable ONNX: head-transposed MatMul / Mul(scale) /
    Where(mask) / Softmax / MatMul.  GQA (kv heads K < H) tiles the kv
    heads to H via Unsqueeze+Expand+Reshape, which ONNX runtimes fold."""
    a = op.bound
    q_t, k_t, v_t = a["q"], a["k"], a["v"]
    B, Tq, H, D = q_t.shape
    Tk, K = k_t.shape[1], k_t.shape[2]
    scale = a["scale"] or (1.0 / math.sqrt(D))
    qn, kn, vn = (ex.name_of(t) for t in (q_t, k_t, v_t))
    if K != H:  # tile kv heads up to H
        for tag in ("k", "v"):
            src = kn if tag == "k" else vn
            u = ex.fresh(f"{tag}_unsq")
            ex.emit("Unsqueeze", [src, ex.ints([3], "axes")], [u])
            e = ex.fresh(f"{tag}_exp")
            ex.emit("Expand", [u, ex.ints([B, Tk, K, H // K, D], "shape")],
                    [e])
            r = ex.fresh(f"{tag}_rep")
            ex.emit("Reshape", [e, ex.ints([B, Tk, H, D], "shape")], [r])
            if tag == "k":
                kn = r
            else:
                vn = r
    qh = ex.fresh("qh")
    ex.emit("Transpose", [qn], [qh], perm=[0, 2, 1, 3])      # B,H,Tq,D
    kT = ex.fresh("kT")
    ex.emit("Transpose", [kn], [kT], perm=[0, 2, 3, 1])      # B,H,D,Tk
    raw = ex.fresh("scores_raw")
    ex.emit("MatMul", [qh, kT], [raw])
    # constants in the traced activation dtype, so bf16 exports emit no
    # type-mismatched nodes
    act = op.outs[0].dtype
    scores = ex.fresh("scores")
    ex.emit("Mul", [raw, ex.add_init(torch.tensor(scale, dtype=act),
                                     "scale")], [scores])
    neg = ex.add_init(torch.tensor(torch.finfo(act).min, dtype=act),
                      "neg_inf")
    if a["causal"]:
        cm = np.tril(np.ones((Tq, Tk), np.bool_), k=Tk - Tq)
        masked = ex.fresh("masked")
        ex.emit("Where", [ex.add_init(cm, "causal_mask"), scores, neg],
                [masked])
        scores = masked
    mask = a["mask"]
    if mask is not None:
        if isinstance(mask, torch.Tensor) and id(mask) in ex.names:
            mn = ex.names[id(mask)]              # traced: a graph value
        else:
            warnings.warn(
                "sonnx export: the attention mask passed at trace time is "
                "frozen into the exported graph as a constant (trace-time "
                "constant folding). Export without attention_mask if the "
                "mask varies per batch.", stacklevel=2)
            mn = ex.add_init(np.asarray(torch.as_tensor(mask).cpu(),
                                        np.bool_), "attn_mask")
        masked = ex.fresh("masked")
        ex.emit("Where", [mn, scores, neg], [masked])
        scores = masked
    probs = ex.fresh("probs")
    ex.emit("Softmax", [scores], [probs], axis=-1)
    vh = ex.fresh("vh")
    ex.emit("Transpose", [vn], [vh], perm=[0, 2, 1, 3])      # B,H,Tk,D
    ctx = ex.fresh("ctx")
    ex.emit("MatMul", [probs, vh], [ctx])                    # B,H,Tq,D
    ex.emit("Transpose", [ctx], ex.outn(op), perm=[0, 2, 1, 3])


@_exports("rnn_scan")
def _e_rnn_scan(ex, op):
    """layer.RNN / layer.LSTM (``ops.rnn.scan``) → a real ONNX RNN or
    LSTM node, the layout converted in the graph (Transpose / Split /
    Concat of the weight initializers, which runtimes fold).  Ours: x
    (B, T, D), Wx (D, G·H), Wh (H, G·H), b (G·H,), LSTM gates i, f, g,
    o.  ONNX: X (T, B, D), W (1, G·H, D), R (1, G·H, H), B (1, 2·G·H)
    with a zero recurrence bias, LSTM gates i, o, f, c."""
    a = op.bound
    kind, H = a["kind"], a["wh"].shape[0]
    G = 4 if kind == "LSTM" else 1
    ax0 = ex.ints([0], "ax0")
    # explicit split sizes: valid in opset 13 through 18+
    gate_splits = ex.ints([H] * 4, "gsplit") if kind == "LSTM" else None

    def iofc(name, hint):
        if kind != "LSTM":
            return name
        parts = [ex.fresh(f"{hint}_g{i}") for i in range(4)]
        ex.emit("Split", [name, gate_splits], parts, axis=0)
        out = ex.fresh(f"{hint}_iofc")
        ex.emit("Concat", [parts[0], parts[3], parts[1], parts[2]], [out],
                axis=0)
        return out

    def weight(t, hint):
        tr = ex.fresh(hint)
        ex.emit("Transpose", [ex.name_of(t)], [tr], perm=[1, 0])
        u = ex.fresh(f"{hint}_d")
        ex.emit("Unsqueeze", [iofc(tr, hint), ax0], [u])   # (1, G·H, in)
        return u

    w, r = weight(a["wx"], "rnn_w"), weight(a["wh"], "rnn_r")
    # the recurrence bias: zeros in the traced dtype
    zeros = ex.add_init(torch.zeros(G * H, dtype=op.outs[0].dtype), "rb0")
    bias = ex.fresh("rnn_b")
    ex.emit("Concat", [iofc(ex.name_of(a["b"]), "rnn_b"), zeros], [bias],
            axis=0)
    bu = ex.fresh("rnn_b_d")
    ex.emit("Unsqueeze", [bias, ax0], [bu])                 # (1, 2·G·H)
    xt = ex.fresh("x_tbd")
    ex.emit("Transpose", [ex.name_of(a["x"])], [xt], perm=[1, 0, 2])
    y = ex.fresh("rnn_y")                                   # (T, 1, B, H)
    ex.emit(kind, [xt, w, r, bu], [y], hidden_size=int(H))
    sq = ex.fresh("rnn_y_sq")
    ex.emit("Squeeze", [y, ex.ints([1], "ax1")], [sq])      # (T, B, H)
    ex.emit("Transpose", [sq], ex.outn(op), perm=[1, 0, 2])


# -- the rest of autograd's surface: units "autograd.<name>", in the
# reference's ONNX forms ------------------------------------------------------

def _ag(*names):
    return _exports(*(f"autograd.{n}" for n in names))


def _name(op: _Op) -> str:
    return op.kind.split(".", 1)[1]


def _a(op: _Op) -> torch.Tensor:
    """The first tensor operand of an autograd unit."""
    return next(iter(op.bound.values()))


# one node over the operands in order; a scalar operand becomes an
# initializer in the first operand's dtype
_AG_SIMPLE = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div", "neg": "Neg",
    "abs": "Abs", "exp": "Exp", "log": "Log", "sqrt": "Sqrt", "erf": "Erf",
    "matmul": "MatMul", "softplus": "Softplus", "sin": "Sin", "cos": "Cos",
    "tan": "Tan", "asin": "Asin", "acos": "Acos", "atan": "Atan",
    "sinh": "Sinh", "cosh": "Cosh", "asinh": "Asinh", "acosh": "Acosh",
    "atanh": "Atanh", "ceil": "Ceil", "floor": "Floor", "round": "Round",
    "sign": "Sign", "reciprocal": "Reciprocal", "minimum": "Min",
    "maximum": "Max", "equal": "Equal", "greater": "Greater",
    "greater_equal": "GreaterOrEqual", "less": "Less",
    "less_equal": "LessOrEqual", "selu": "Selu", "prelu": "PRelu",
    "mish": "Mish", "hardswish": "HardSwish",
}
# ONNX's logic ops take booleans: other operands are cast first
_AG_LOGIC = {"logical_and": "And", "logical_or": "Or",
             "logical_xor": "Xor", "logical_not": "Not"}


@_ag(*_AG_SIMPLE)
def _e_ag_simple(ex, op):
    vals = list(op.bound.values())
    dt = vals[0].dtype
    ex.emit(_AG_SIMPLE[_name(op)], [ex.operand(v, dt) for v in vals],
            ex.outn(op))


@_ag(*_AG_LOGIC)
def _e_ag_logic(ex, op):
    ex.emit(_AG_LOGIC[_name(op)],
            [ex.operand(v, torch.bool) for v in op.bound.values()],
            ex.outn(op))


@_ag("pow")
def _e_ag_pow(ex, op):
    a = op.bound["a"]
    ex.emit("Pow", [ex.name_of(a), ex.operand(float(op.bound["p"]), a.dtype)],
            ex.outn(op))


@_ag("rsqrt")
def _e_ag_rsqrt(ex, op):
    mid = ex.fresh("sqrt")
    ex.emit("Sqrt", [ex.name_of(_a(op))], [mid])
    ex.emit("Reciprocal", [mid], ex.outn(op))


@_ag("clip")
def _e_ag_clip(ex, op):
    a = op.bound["a"]
    ex.emit("Clip", [ex.name_of(a), ex.operand(op.bound["lo"], a.dtype),
                     ex.operand(op.bound["hi"], a.dtype)], ex.outn(op))


@_ag("mod")
def _e_ag_mod(ex, op):
    a, b = op.bound["a"], op.bound["b"]
    an, bn = ex.name_of(a), ex.operand(b, a.dtype)
    if not a.dtype.is_floating_point:
        # ONNX integer Mod with fmod=0 is floor-mod, as jnp.mod
        ex.emit("Mod", [an, bn], ex.outn(op), fmod=0)
        return
    # float Mod is C's fmod only: a - floor(a / b)·b keeps the floor
    q, fl, prod = ex.fresh("mod_div"), ex.fresh("mod_floor"), \
        ex.fresh("mod_prod")
    ex.emit("Div", [an, bn], [q])
    ex.emit("Floor", [q], [fl])
    ex.emit("Mul", [fl, bn], [prod])
    ex.emit("Sub", [an, prod], ex.outn(op))


@_ag("hardsigmoid")
def _e_ag_hardsigmoid(ex, op):
    ex.emit("HardSigmoid", [ex.name_of(_a(op))], ex.outn(op),
            alpha=float(op.bound["alpha"]), beta=float(op.bound["beta"]))


@_ag("leakyrelu")
def _e_ag_leaky(ex, op):
    ex.emit("LeakyRelu", [ex.name_of(_a(op))], ex.outn(op),
            alpha=float(op.bound["slope"]))


@_ag("elu")
def _e_ag_elu(ex, op):
    ex.emit("Elu", [ex.name_of(_a(op))], ex.outn(op),
            alpha=float(op.bound["alpha"]))


@_ag("tile")
def _e_ag_tile(ex, op):
    # ONNX Tile takes one repeat a dimension: short reps are padded with
    # ones in front, as jnp.tile does; longer reps raise
    a, reps = op.bound["a"], op.bound["reps"]
    reps = list(reps) if hasattr(reps, "__len__") else [reps]
    if len(reps) > a.dim():
        raise ValueError("sonnx export: Tile with more reps than input "
                         "rank has no ONNX equivalent; reshape the input "
                         "first")
    reps = [1] * (a.dim() - len(reps)) + reps
    ex.emit("Tile", [ex.name_of(a), ex.ints(reps, "repeats")], ex.outn(op))


@_ag("expand")
def _e_ag_expand(ex, op):
    ex.emit("Expand", [ex.name_of(_a(op)),
                       ex.ints(list(op.bound["shape"]), "shape")],
            ex.outn(op))


@_ag("cumsum")
def _e_ag_cumsum(ex, op):
    ax = ex.add_init(np.asarray(op.bound["axis"], np.int64), "axis")
    ex.emit("CumSum", [ex.name_of(_a(op)), ax], ex.outn(op))


@_ag("einsum")
def _e_ag_einsum(ex, op):
    ts = op.bound["ts"]
    dt = op.outs[0].dtype
    ex.emit("Einsum", [ex.operand(t, dt) for t in ts], ex.outn(op),
            equation=op.bound["subscripts"])


@_ag("add_bias")
def _e_ag_add_bias(ex, op):
    x, b = op.bound["x"], op.bound["b"]
    shape = [1] * x.dim()
    shape[op.bound["axis"]] = -1
    mid = ex.fresh("b_rs")
    ex.emit("Reshape", [ex.name_of(b), ex.ints(shape, "shape")], [mid])
    ex.emit("Add", [ex.name_of(x), mid], ex.outn(op))


@_ag("reshape", "squeeze", "unsqueeze")
def _e_ag_reshape(ex, op):
    ex.emit("Reshape", [ex.name_of(_a(op)),
                        ex.ints(list(op.outs[0].shape), "shape")],
            ex.outn(op))


@_ag("transpose")
def _e_ag_transpose(ex, op):
    a, axes = op.bound["a"], op.bound["axes"]
    perm = list(reversed(range(a.dim()))) if axes is None else \
        [int(x) % a.dim() for x in axes]
    ex.emit("Transpose", [ex.name_of(a)], ex.outn(op), perm=perm)


@_ag("cat")
def _e_ag_cat(ex, op):
    dt = op.outs[0].dtype
    ex.emit("Concat", [ex.operand(t, dt) for t in op.bound["ts"]],
            ex.outn(op), axis=int(op.bound["axis"]))


@_ag("stack")
def _e_ag_stack(ex, op):
    axis = int(op.bound["axis"])
    ax = ex.ints([axis], "axes")
    mids = []
    for t in op.bound["ts"]:
        m = ex.fresh("unsq")
        ex.emit("Unsqueeze", [ex.name_of(t), ax], [m])
        mids.append(m)
    ex.emit("Concat", mids, ex.outn(op), axis=axis)


@_ag("split")
def _e_ag_split(ex, op):
    a = op.bound["a"]
    axis = int(op.bound["axis"]) % a.dim()
    parts = [o.shape[axis] for o in op.outs]
    ex.emit("Split", [ex.name_of(a), ex.ints(parts, "split")], ex.outn(op),
            axis=axis)


@_ag("gather")
def _e_ag_gather(ex, op):
    a = op.bound["a"]
    idx = np.asarray(torch.as_tensor(op.bound["indices"]).cpu(), np.int64)
    ex.emit("Gather", [ex.name_of(a), ex.add_init(idx, "indices")],
            ex.outn(op), axis=int(op.bound["axis"]) % a.dim())


@_ag("index")
def _e_ag_index(ex, op):
    """Basic indexing (ints and slices) as Slice, then Squeeze of the
    int axes."""
    a, idx = op.bound["a"], op.bound["idx"]
    idx = idx if isinstance(idx, tuple) else (idx,)
    if not all(isinstance(s, (slice, int)) for s in idx):
        raise NotImplementedError(
            "ONNX export of advanced (array) indexing is unsupported")
    i64 = np.iinfo(np.int64)
    starts, ends, axes, steps, squeeze = [], [], [], [], []
    for ax, s in enumerate(idx):
        if isinstance(s, int):
            starts.append(s)
            ends.append(s + 1 if s != -1 else i64.max)
            axes.append(ax)
            steps.append(1)
            squeeze.append(ax)
        elif s != slice(None):
            step = 1 if s.step is None else s.step
            # open bounds flip sentinels under a negative step
            starts.append((i64.max if step < 0 else 0)
                          if s.start is None else s.start)
            ends.append((i64.min if step < 0 else i64.max)
                        if s.stop is None else s.stop)
            axes.append(ax)
            steps.append(step)
    outn = ex.outn(op)
    target = outn[0] if not squeeze else ex.fresh("sliced")
    if starts:
        ex.emit("Slice", [ex.name_of(a), ex.ints(starts, "starts"),
                          ex.ints(ends, "ends"), ex.ints(axes, "axes"),
                          ex.ints(steps, "steps")], [target])
    else:
        ex.emit("Identity", [ex.name_of(a)], [target])
    if squeeze:
        ex.emit("Squeeze", [target, ex.ints(squeeze, "axes")], outn)


@_ag("pad")
def _e_ag_pad(ex, op):
    a = op.bound["a"]
    pw = np.broadcast_to(np.asarray(op.bound["pad_width"], np.int64),
                         (a.dim(), 2))
    pads = [int(p) for p in pw[:, 0]] + [int(p) for p in pw[:, 1]]
    ex.emit("Pad", [ex.name_of(a), ex.ints(pads, "pads"),
                    ex.operand(op.bound["value"], a.dtype)], ex.outn(op))


@_ag("where")
def _e_ag_where(ex, op):
    cond, a, b = op.bound["cond"], op.bound["a"], op.bound["b"]
    if isinstance(cond, torch.Tensor) and id(cond) in ex.names:
        cn = ex.operand(cond, torch.bool)      # traced: a graph value
    else:
        warnings.warn(
            "sonnx export: the Where condition evaluated at trace time is "
            "frozen into the graph as a constant; input-dependent masks "
            "will not vary in the exported model.", stacklevel=2)
        cn = ex.add_init(np.asarray(torch.as_tensor(cond).cpu(), np.bool_),
                         "cond")
    ex.emit("Where", [cn, ex.name_of(a), ex.operand(b, a.dtype)],
            ex.outn(op))


_AG_REDUCE = {"reduce_sum": "ReduceSum", "reduce_max": "ReduceMax",
              "reduce_min": "ReduceMin"}


@_ag(*_AG_REDUCE)
def _e_ag_reduce(ex, op):
    a, axis = op.bound["a"], op.bound["axis"]
    ins = [ex.name_of(a)]
    if axis is not None:
        ins.append(ex.ints([axis] if isinstance(axis, int) else list(axis),
                           "axes"))
    ex.emit(_AG_REDUCE[_name(op)], ins, ex.outn(op),
            keepdims=int(bool(op.bound["keepdims"])))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def to_onnx(model, inputs: Sequence, name: Optional[str] = None,
            opset_version: int = 18) -> proto.ModelProto:
    """Trace `model.forward(*inputs)` and build an ONNX ModelProto.

    `inputs` — example tensors (or arrays, moved to the model's device);
    their shapes become the graph signature.  The model runs in eval
    mode without gradients; parameters and buffers become initializers
    under their ``get_params()`` / ``_get_buffers()`` names."""
    dev = getattr(getattr(model, "device", None), "torch_device", None)
    ts = [x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
          for x in inputs]
    if dev is not None:
        ts = [t.to(dev) for t in ts]
    params = dict(model.get_params()) if hasattr(model, "get_params") else {}
    buffers = dict(model._get_buffers()) if hasattr(model, "_get_buffers") \
        else {}

    modes = {m: m.training for m in model.modules()}
    was_training = autograd.is_training()
    rec = _Recorder(ts + list(params.values()) + list(buffers.values()))
    model.eval()
    prev = _unit.set_recorder(rec)
    try:
        with torch.no_grad(), rec:
            out = model.forward(*ts)
    finally:
        _unit.set_recorder(prev)
        for m, flag in modes.items():
            m.training = flag
        autograd.set_training(was_training)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]

    ex = _Exporter()
    graph_inputs = []
    for i, t in enumerate(ts):
        in_name = f"input_{i}"
        ex.bind(t, in_name)
        graph_inputs.append(make_tensor_value_info(
            in_name, proto.torch_dtype_to_tensor_dtype(t.dtype),
            list(t.shape)))
    for pname, p in list(params.items()) + list(buffers.items()):
        if id(p) not in ex.names:
            ex.bind(p, pname)
            ex.initializers.append(proto.from_array(p.detach().cpu(), pname))

    # name every live output, then emit in recorded (topological) order
    needed = _live_ops(rec.tape, outs)
    for op in needed:
        for o in op.outs:
            if id(o) not in ex.names:
                ex.bind(o, ex.fresh("t"))
    for op in needed:
        rule = _EXPORT.get(op.kind)
        if rule is None:
            raise NotImplementedError(
                f"sonnx export: no ONNX export rule for torch call "
                f"{op.kind!r}")
        rule(ex, op)

    graph_outputs = []
    for o in outs:
        oname = ex.name_of(o)   # an input or parameter passed through
        graph_outputs.append(make_tensor_value_info(
            oname, proto.torch_dtype_to_tensor_dtype(o.dtype),
            list(o.shape)))
    g = proto.make_graph(ex.nodes, name or getattr(model, "name", None)
                         or type(model).__name__, graph_inputs,
                         graph_outputs, ex.initializers)
    return make_model(g, opset_version=opset_version)


def _live_ops(tape: List[_Op], outs) -> List[_Op]:
    """Keep only calls on a path to the requested outputs (dead-code
    prune: e.g. metric branches recorded during the trace)."""
    live = {id(o) for o in outs}
    keep = []
    for op in reversed(tape):
        if any(id(o) in live for o in op.outs):
            keep.append(op)
            live.update(id(t) for t in op.ins)
    return list(reversed(keep))


def export(model, inputs: Sequence, path: str, **kw) -> proto.ModelProto:
    m = to_onnx(model, inputs, **kw)
    proto.save(m, path)
    return m


save = proto.save
