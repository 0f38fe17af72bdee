"""singa_tpu_torch.models — the model families ported so far (Llama)
and the causal-LM losses."""

from . import convert, llama, transformer
from .convert import load_reference_params
from .llama import Llama, LlamaConfig

__all__ = ["convert", "llama", "transformer", "Llama", "LlamaConfig",
           "load_reference_params"]
