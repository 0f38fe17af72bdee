"""Self-contained ONNX protobuf support (no `onnx` pip dependency),
ported from ``singa_tpu/sonnx/proto.py``.

The subset of the ONNX protobuf schema that ``sonnx`` needs, written
directly against the protobuf *wire format* (varint / 64-bit /
length-delimited / 32-bit records).  Field numbers below are those of
onnx/onnx.proto, so files written here open in netron/onnxruntime and
exported .onnx files load here; for a model built through the helpers
the bytes are those the JAX package's codec writes.

Public surface mirrors `onnx` + `onnx.helper` + `onnx.numpy_helper`:
    ModelProto, GraphProto, NodeProto, TensorProto, AttributeProto, ...
    make_node, make_graph, make_model, make_tensor, make_tensor_value_info
    to_array, from_array, load, save, load_model_from_string

bfloat16 without ``ml_dtypes``: numpy has no bf16 dtype, so a
``BFLOAT16`` tensor's numpy lane is its raw ``uint16`` bit pattern
(``tensor_dtype_to_np_dtype(BFLOAT16)`` is uint16, for sizes only).
``to_array`` of a ``BFLOAT16`` tensor returns a ``torch.bfloat16`` CPU
tensor holding those bits (``to_torch`` returns any tensor as torch);
``from_array`` takes a torch tensor, a bf16 one included, and writes
its bits.  A numpy uint16 array is always ``UINT16``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "TensorProto", "AttributeProto", "ValueInfoProto", "NodeProto",
    "ModelProto", "GraphProto", "TypeProto", "TensorShapeProto",
    "OperatorSetIdProto",
    "make_node", "make_graph", "make_model", "make_tensor",
    "make_tensor_value_info", "make_attribute",
    "to_array", "to_torch", "from_array", "load", "save",
    "load_model_from_string", "tensor_dtype_to_np_dtype",
    "np_dtype_to_tensor_dtype", "torch_dtype_to_tensor_dtype",
    "tensor_dtype_to_torch_dtype",
]


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------

_WT_VARINT, _WT_I64, _WT_LEN, _WT_I32 = 0, 1, 2, 5

_VARINT_KINDS = ("int64", "int32", "uint64", "enum")


def _enc_varint(buf: bytearray, n: int) -> None:
    if n < 0:
        n += 1 << 64  # two's-complement int64 on the wire
    while True:
        b = n & 0x7F
        n >>= 7
        buf.append(b | (0x80 if n else 0))
        if not n:
            break


def _dec_varint(data: bytes, pos: int) -> Tuple[int, int]:
    res = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        res |= (b & 0x7F) << shift
        if not (b & 0x80):
            return res, pos
        shift += 7


def _signed(v: int, kind: str) -> int:
    if kind in ("int64", "int32", "enum") and v >= 1 << 63:
        v -= 1 << 64
    return v


def _enc_tag(buf: bytearray, num: int, wt: int) -> None:
    _enc_varint(buf, (num << 3) | wt)


def _enc_len_delim(buf: bytearray, num: int, payload: bytes) -> None:
    _enc_tag(buf, num, _WT_LEN)
    _enc_varint(buf, len(payload))
    buf += payload


# ---------------------------------------------------------------------------
# generic message base
# ---------------------------------------------------------------------------

class Message:
    """Tiny protobuf message: subclasses declare FIELDS =
    {field_number: (attr_name, kind, repeated)} where kind is a scalar
    kind string or a Message subclass."""

    FIELDS: Dict[int, Tuple[str, Any, bool]] = {}

    def __init__(self, **kw):
        for _num, (name, _kind, rep) in self.FIELDS.items():
            setattr(self, name, [] if rep else None)
        for k, v in kw.items():
            if k not in {n for (n, _k, _r) in self.FIELDS.values()}:
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    # -- encode ---------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        buf = bytearray()
        for num in sorted(self.FIELDS):
            name, kind, rep = self.FIELDS[num]
            val = getattr(self, name)
            if val is None or (rep and len(val) == 0):
                continue
            vals = val if rep else [val]
            if isinstance(kind, type) and issubclass(kind, Message):
                for v in vals:
                    _enc_len_delim(buf, num, v.SerializeToString())
            elif kind in _VARINT_KINDS:
                if rep:  # packed
                    inner = bytearray()
                    for v in vals:
                        _enc_varint(inner, int(v))
                    _enc_len_delim(buf, num, bytes(inner))
                else:
                    _enc_tag(buf, num, _WT_VARINT)
                    _enc_varint(buf, int(vals[0]))
            elif kind == "float":
                if rep:
                    _enc_len_delim(buf, num, struct.pack(f"<{len(vals)}f", *vals))
                else:
                    _enc_tag(buf, num, _WT_I32)
                    buf += struct.pack("<f", vals[0])
            elif kind == "double":
                if rep:
                    _enc_len_delim(buf, num, struct.pack(f"<{len(vals)}d", *vals))
                else:
                    _enc_tag(buf, num, _WT_I64)
                    buf += struct.pack("<d", vals[0])
            elif kind == "string":
                for v in vals:
                    _enc_len_delim(buf, num, v.encode("utf-8") if isinstance(v, str) else bytes(v))
            elif kind == "bytes":
                for v in vals:
                    _enc_len_delim(buf, num, bytes(v))
            else:  # pragma: no cover
                raise TypeError(f"unknown field kind {kind}")
        return bytes(buf)

    # -- decode ---------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        pos, end = 0, len(data)
        while pos < end:
            tag, pos = _dec_varint(data, pos)
            num, wt = tag >> 3, tag & 0x7
            spec = cls.FIELDS.get(num)
            if spec is None:
                pos = _skip(data, pos, wt)
                continue
            name, kind, rep = spec
            if isinstance(kind, type) and issubclass(kind, Message):
                ln, pos = _dec_varint(data, pos)
                sub = kind.FromString(data[pos:pos + ln])
                pos += ln
                if rep:
                    getattr(msg, name).append(sub)
                else:
                    setattr(msg, name, sub)
            elif kind in _VARINT_KINDS:
                if wt == _WT_LEN:  # packed
                    ln, pos = _dec_varint(data, pos)
                    stop = pos + ln
                    lst = getattr(msg, name) if rep else None
                    while pos < stop:
                        v, pos = _dec_varint(data, pos)
                        v = _signed(v, kind)
                        if rep:
                            lst.append(v)
                        else:
                            setattr(msg, name, v)
                else:
                    v, pos = _dec_varint(data, pos)
                    v = _signed(v, kind)
                    if rep:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
            elif kind in ("float", "double"):
                fmt, size, wtyp = (("<f", 4, _WT_I32) if kind == "float"
                                   else ("<d", 8, _WT_I64))
                if wt == _WT_LEN:  # packed
                    ln, pos = _dec_varint(data, pos)
                    n = ln // size
                    vals = struct.unpack(f"<{n}{fmt[-1]}", data[pos:pos + ln])
                    pos += ln
                    if rep:
                        getattr(msg, name).extend(vals)
                    elif vals:
                        setattr(msg, name, vals[-1])
                else:
                    (v,) = struct.unpack(fmt, data[pos:pos + size])
                    pos += size
                    if rep:
                        getattr(msg, name).append(v)
                    else:
                        setattr(msg, name, v)
            elif kind in ("string", "bytes"):
                ln, pos = _dec_varint(data, pos)
                raw = data[pos:pos + ln]
                pos += ln
                v = raw.decode("utf-8") if kind == "string" else raw
                if rep:
                    getattr(msg, name).append(v)
                else:
                    setattr(msg, name, v)
            else:  # pragma: no cover
                raise TypeError(f"unknown field kind {kind}")
        return msg

    def ParseFromString(self, data: bytes) -> None:
        """Protobuf in-place parse idiom: mutates self (unlike the
        classmethod FromString, which returns a new message)."""
        parsed = type(self).FromString(data)
        for _num, (name, _kind, _rep) in self.FIELDS.items():
            setattr(self, name, getattr(parsed, name))

    def __repr__(self):
        parts = []
        for _num, (name, _kind, rep) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if v is None or (rep and not v):
                continue
            s = f"[{len(v)} items]" if rep and len(v) > 3 else repr(v)
            parts.append(f"{name}={s}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _skip(data: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = _dec_varint(data, pos)
    elif wt == _WT_I64:
        pos += 8
    elif wt == _WT_LEN:
        ln, pos = _dec_varint(data, pos)
        pos += ln
    elif wt == _WT_I32:
        pos += 4
    else:
        raise ValueError(f"cannot skip wire type {wt}")
    return pos


# ---------------------------------------------------------------------------
# ONNX messages — field numbers match onnx/onnx.proto
# ---------------------------------------------------------------------------

class TensorProto(Message):
    # DataType enum values (onnx.proto TensorProto.DataType)
    UNDEFINED, FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = range(8)
    STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
    COMPLEX64, COMPLEX128, BFLOAT16 = 14, 15, 16

    FIELDS = {
        1: ("dims", "int64", True),
        2: ("data_type", "int32", False),
        4: ("float_data", "float", True),
        5: ("int32_data", "int32", True),
        6: ("string_data", "bytes", True),
        7: ("int64_data", "int64", True),
        8: ("name", "string", False),
        9: ("raw_data", "bytes", False),
        10: ("double_data", "double", True),
        11: ("uint64_data", "uint64", True),
        12: ("doc_string", "string", False),
    }


class TensorShapeProto(Message):
    class Dimension(Message):
        FIELDS = {
            1: ("dim_value", "int64", False),
            2: ("dim_param", "string", False),
            3: ("denotation", "string", False),
        }

    FIELDS = {1: ("dim", Dimension, True)}


class TypeProto(Message):
    class Tensor(Message):
        FIELDS = {
            1: ("elem_type", "int32", False),
            2: ("shape", TensorShapeProto, False),
        }

    FIELDS = {1: ("tensor_type", Tensor, False), 6: ("denotation", "string", False)}


class ValueInfoProto(Message):
    FIELDS = {
        1: ("name", "string", False),
        2: ("type", TypeProto, False),
        3: ("doc_string", "string", False),
    }


class AttributeProto(Message):
    # AttributeType enum
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = range(6)
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = 6, 7, 8, 9, 10

    FIELDS = {
        1: ("name", "string", False),
        2: ("f", "float", False),
        3: ("i", "int64", False),
        4: ("s", "bytes", False),
        5: ("t", TensorProto, False),
        7: ("floats", "float", True),
        8: ("ints", "int64", True),
        9: ("strings", "bytes", True),
        10: ("tensors", TensorProto, True),
        13: ("doc_string", "string", False),
        20: ("type", "enum", False),
        21: ("ref_attr_name", "string", False),
    }
    # field 6/11 (g/graphs: GraphProto) registered after GraphProto exists


class NodeProto(Message):
    FIELDS = {
        1: ("input", "string", True),
        2: ("output", "string", True),
        3: ("name", "string", False),
        4: ("op_type", "string", False),
        5: ("attribute", AttributeProto, True),
        6: ("doc_string", "string", False),
        7: ("domain", "string", False),
    }


class GraphProto(Message):
    FIELDS = {
        1: ("node", NodeProto, True),
        2: ("name", "string", False),
        5: ("initializer", TensorProto, True),
        10: ("doc_string", "string", False),
        11: ("input", ValueInfoProto, True),
        12: ("output", ValueInfoProto, True),
        13: ("value_info", ValueInfoProto, True),
    }


# close the recursion: AttributeProto.g / .graphs
AttributeProto.FIELDS[6] = ("g", GraphProto, False)
AttributeProto.FIELDS[11] = ("graphs", GraphProto, True)


class OperatorSetIdProto(Message):
    FIELDS = {
        1: ("domain", "string", False),
        2: ("version", "int64", False),
    }


class StringStringEntryProto(Message):
    FIELDS = {
        1: ("key", "string", False),
        2: ("value", "string", False),
    }


class ModelProto(Message):
    FIELDS = {
        1: ("ir_version", "int64", False),
        2: ("producer_name", "string", False),
        3: ("producer_version", "string", False),
        4: ("domain", "string", False),
        5: ("model_version", "int64", False),
        6: ("doc_string", "string", False),
        7: ("graph", GraphProto, False),
        8: ("opset_import", OperatorSetIdProto, True),
        14: ("metadata_props", StringStringEntryProto, True),
    }


# ---------------------------------------------------------------------------
# dtype mapping + numpy_helper
# ---------------------------------------------------------------------------

_TP2NP = {
    TensorProto.FLOAT: np.dtype(np.float32),
    TensorProto.UINT8: np.dtype(np.uint8),
    TensorProto.INT8: np.dtype(np.int8),
    TensorProto.UINT16: np.dtype(np.uint16),
    TensorProto.INT16: np.dtype(np.int16),
    TensorProto.INT32: np.dtype(np.int32),
    TensorProto.INT64: np.dtype(np.int64),
    TensorProto.BOOL: np.dtype(np.bool_),
    TensorProto.FLOAT16: np.dtype(np.float16),
    TensorProto.DOUBLE: np.dtype(np.float64),
    TensorProto.UINT32: np.dtype(np.uint32),
    TensorProto.UINT64: np.dtype(np.uint64),
    # the bit pattern: sizes and raw bytes, never values
    TensorProto.BFLOAT16: np.dtype(np.uint16),
}
_NP2TP = {v: k for k, v in _TP2NP.items() if k != TensorProto.BFLOAT16}

_TORCH2TP = {
    torch.float32: TensorProto.FLOAT, torch.uint8: TensorProto.UINT8,
    torch.int8: TensorProto.INT8, torch.int16: TensorProto.INT16,
    torch.int32: TensorProto.INT32, torch.int64: TensorProto.INT64,
    torch.bool: TensorProto.BOOL, torch.float16: TensorProto.FLOAT16,
    torch.float64: TensorProto.DOUBLE, torch.bfloat16: TensorProto.BFLOAT16,
}
_TP2TORCH = {v: k for k, v in _TORCH2TP.items()}


def tensor_dtype_to_np_dtype(tp: int) -> np.dtype:
    return _TP2NP[tp]


def np_dtype_to_tensor_dtype(dt) -> int:
    if isinstance(dt, torch.dtype):
        return torch_dtype_to_tensor_dtype(dt)
    dt = np.dtype(dt)
    if dt not in _NP2TP:
        raise TypeError(f"no ONNX dtype for numpy {dt}")
    return _NP2TP[dt]


def torch_dtype_to_tensor_dtype(dt: torch.dtype) -> int:
    if dt not in _TORCH2TP:
        raise TypeError(f"no ONNX dtype for torch {dt}")
    return _TORCH2TP[dt]


def tensor_dtype_to_torch_dtype(tp: int) -> torch.dtype:
    if tp not in _TP2TORCH:
        raise TypeError(f"no torch dtype for ONNX data_type {tp}")
    return _TP2TORCH[tp]


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    # np.array copies (and keeps a 0-d array 0-d, which
    # np.ascontiguousarray would make 1-d)
    return torch.from_numpy(np.array(bits, np.uint16).view(np.int16)) \
        .view(torch.bfloat16)


def to_array(t: TensorProto) -> Union[np.ndarray, torch.Tensor]:
    """TensorProto → numpy (onnx.numpy_helper.to_array parity); a
    BFLOAT16 tensor → torch.bfloat16 CPU tensor (numpy has no bf16)."""
    dt = _TP2NP[t.data_type or TensorProto.FLOAT]
    dims = tuple(t.dims)
    bf16 = t.data_type == TensorProto.BFLOAT16
    if t.raw_data:
        a = np.frombuffer(t.raw_data, dtype=dt.newbyteorder("<")).astype(dt)
        return _bf16_from_bits(a.reshape(dims)) if bf16 else a.reshape(dims)
    if t.data_type == TensorProto.FLOAT and t.float_data:
        return np.asarray(t.float_data, np.float32).reshape(dims)
    if t.data_type == TensorProto.DOUBLE and t.double_data:
        return np.asarray(t.double_data, np.float64).reshape(dims)
    if t.data_type in (TensorProto.INT64,) and t.int64_data:
        return np.asarray(t.int64_data, np.int64).reshape(dims)
    if t.data_type in (TensorProto.UINT64,) and t.uint64_data:
        return np.asarray(t.uint64_data, np.uint64).reshape(dims)
    if t.data_type in (TensorProto.FLOAT16, TensorProto.BFLOAT16) and t.int32_data:
        raw = np.asarray(t.int32_data, np.int32).astype(np.uint16)
        if bf16:
            return _bf16_from_bits(raw.reshape(dims))
        return raw.view(dt).reshape(dims)
    if t.int32_data:  # int32 and narrower ints ride int32_data
        return np.asarray(t.int32_data, np.int32).astype(dt).reshape(dims)
    if bf16:
        return torch.zeros(dims, dtype=torch.bfloat16)
    return np.zeros(dims, dt)


def to_torch(t: TensorProto) -> torch.Tensor:
    """TensorProto → torch CPU tensor of its own dtype."""
    a = to_array(t)
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def from_array(a, name: str = "") -> TensorProto:
    """numpy array or torch tensor → TensorProto via raw_data
    (onnx.numpy_helper.from_array); a torch.bfloat16 tensor writes its
    bits as BFLOAT16.
    (np.asarray, not ascontiguousarray: the latter promotes 0-d to 1-d,
    and .tobytes() below already copies non-contiguous input.)"""
    t = TensorProto()
    t.name = name
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        t.dims = list(a.shape)
        t.data_type = torch_dtype_to_tensor_dtype(a.dtype)
        if a.dtype == torch.bfloat16:
            a = a.contiguous().view(torch.int16)
        a = a.numpy()
    else:
        a = np.asarray(a)
        t.dims = list(a.shape)
        t.data_type = np_dtype_to_tensor_dtype(a.dtype)
    t.raw_data = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
    return t


# ---------------------------------------------------------------------------
# helper builders (onnx.helper parity)
# ---------------------------------------------------------------------------

def make_attribute(name: str, value: Any) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(value, (np.ndarray, torch.Tensor)):
        value = from_array(value)
    if isinstance(value, bool):
        a.type, a.i = AttributeProto.INT, int(value)
    elif isinstance(value, (int, np.integer)):
        a.type, a.i = AttributeProto.INT, int(value)
    elif isinstance(value, (float, np.floating)):
        a.type, a.f = AttributeProto.FLOAT, float(value)
    elif isinstance(value, str):
        a.type, a.s = AttributeProto.STRING, value.encode("utf-8")
    elif isinstance(value, bytes):
        a.type, a.s = AttributeProto.STRING, value
    elif isinstance(value, TensorProto):
        a.type, a.t = AttributeProto.TENSOR, value
    elif isinstance(value, GraphProto):
        a.type, a.g = AttributeProto.GRAPH, value
    elif isinstance(value, (list, tuple)):
        if len(value) == 0 or isinstance(value[0], (int, np.integer)):
            a.type = AttributeProto.INTS
            a.ints = [int(v) for v in value]
        elif isinstance(value[0], (float, np.floating)):
            a.type = AttributeProto.FLOATS
            a.floats = [float(v) for v in value]
        elif isinstance(value[0], str):
            a.type = AttributeProto.STRINGS
            a.strings = [v.encode("utf-8") for v in value]
        elif isinstance(value[0], TensorProto):
            a.type = AttributeProto.TENSORS
            a.tensors = list(value)
        else:
            raise TypeError(f"bad attribute list element {type(value[0])}")
    else:
        raise TypeError(f"bad attribute value {type(value)}")
    return a


def attribute_value(a: AttributeProto) -> Any:
    t = a.type or 0
    if t == AttributeProto.FLOAT:
        return float(a.f if a.f is not None else 0.0)
    if t == AttributeProto.INT:
        return int(a.i if a.i is not None else 0)
    if t == AttributeProto.STRING:
        return (a.s or b"").decode("utf-8", "replace")
    if t == AttributeProto.TENSOR:
        return to_array(a.t)
    if t == AttributeProto.GRAPH:
        return a.g
    if t == AttributeProto.FLOATS:
        return [float(v) for v in a.floats]
    if t == AttributeProto.INTS:
        return [int(v) for v in a.ints]
    if t == AttributeProto.STRINGS:
        return [v.decode("utf-8", "replace") for v in a.strings]
    if t == AttributeProto.TENSORS:
        return [to_array(v) for v in a.tensors]
    raise ValueError(f"unsupported attribute type {t}")


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: Optional[str] = None, domain: str = "",
              **attrs) -> NodeProto:
    n = NodeProto(op_type=op_type)
    n.input = list(inputs)
    n.output = list(outputs)
    if name:
        n.name = name
    if domain:
        n.domain = domain
    n.attribute = [make_attribute(k, v) for k, v in sorted(attrs.items())
                   if v is not None]
    return n


def make_tensor_value_info(name: str, elem_type: int,
                           shape: Optional[Sequence] = None) -> ValueInfoProto:
    vi = ValueInfoProto(name=name)
    tt = TypeProto.Tensor(elem_type=elem_type)
    if shape is not None:
        sp = TensorShapeProto()
        for d in shape:
            dim = TensorShapeProto.Dimension()
            if isinstance(d, str):
                dim.dim_param = d
            elif d is not None:
                dim.dim_value = int(d)
            sp.dim.append(dim)
        tt.shape = sp
    vi.type = TypeProto(tensor_type=tt)
    return vi


def make_tensor(name: str, data_type: int, dims: Sequence[int],
                vals) -> TensorProto:
    if data_type == TensorProto.BFLOAT16:
        vals = torch.as_tensor(np.asarray(vals, np.float32),
                               dtype=torch.bfloat16)
        return from_array(vals.reshape(tuple(dims)), name)
    np_dt = _TP2NP[data_type]
    return from_array(np.asarray(vals, dtype=np_dt).reshape(tuple(dims)), name)


def make_graph(nodes: Sequence[NodeProto], name: str,
               inputs: Sequence[ValueInfoProto],
               outputs: Sequence[ValueInfoProto],
               initializer: Optional[Sequence[TensorProto]] = None,
               value_info: Optional[Sequence[ValueInfoProto]] = None) -> GraphProto:
    g = GraphProto(name=name)
    g.node = list(nodes)
    g.input = list(inputs)
    g.output = list(outputs)
    g.initializer = list(initializer or [])
    g.value_info = list(value_info or [])
    return g


def make_model(graph: GraphProto, opset_version: int = 18,
               producer_name: str = "singa_tpu",
               ir_version: int = 8) -> ModelProto:
    m = ModelProto(ir_version=ir_version, producer_name=producer_name)
    m.graph = graph
    m.opset_import = [OperatorSetIdProto(domain="", version=opset_version)]
    return m


def load_model_from_string(data: bytes) -> ModelProto:
    return ModelProto.FromString(data)


def load(path: str) -> ModelProto:
    with open(path, "rb") as f:
        return ModelProto.FromString(f.read())


def save(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(model.SerializeToString())
