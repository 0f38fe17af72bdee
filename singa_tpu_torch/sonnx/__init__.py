"""singa_tpu_torch.sonnx — ONNX interchange, ported from ``singa_tpu/sonnx``.

API surface (the reference's):
    sonnx.prepare(onnx_model, device)  -> backend rep; rep.run(inputs)
    sonnx.to_onnx(model, inputs)       -> ModelProto export
    sonnx.load / sonnx.save            -> file IO
plus the `onnx`-compatible proto/helper layer in `sonnx.proto` (no onnx
wheel: the codec is self-contained, see proto.py).

An imported graph is a port ``model.Model``: ``compile()`` captures its
step as one CUDA graph on the card, and float initializers are
trainable f32 masters, so an import trains (BERT-base / GPT-2
fine-tuning).  Imports torch and numpy only.
"""

from . import proto
from .checker import CheckError, check_graph, check_model
from .backend import SingaBackend, SingaRep, prepare, supported_ops
from .export import export, to_onnx
from .proto import (AttributeProto, GraphProto, ModelProto, NodeProto,
                    TensorProto, from_array, load, load_model_from_string,
                    make_graph, make_model, make_node, make_tensor,
                    make_tensor_value_info, save, to_array)

__all__ = [
    "prepare", "SingaBackend", "SingaRep", "supported_ops",
    "check_model", "check_graph", "CheckError",
    "to_onnx", "export", "load", "save", "load_model_from_string",
    "proto", "ModelProto", "GraphProto", "NodeProto", "TensorProto",
    "AttributeProto", "make_node", "make_graph", "make_model",
    "make_tensor", "make_tensor_value_info", "to_array", "from_array",
]
