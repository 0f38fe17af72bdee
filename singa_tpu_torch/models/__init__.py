"""singa_tpu_torch.models — the model families ported so far (Llama)."""

from . import convert, llama
from .convert import load_reference_params
from .llama import Llama, LlamaConfig

__all__ = ["convert", "llama", "Llama", "LlamaConfig",
           "load_reference_params"]
