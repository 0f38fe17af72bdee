"""singa_tpu_torch.ops — attention, RoPE and the KV cache for the serving
path.  Plain torch where the JAX package left fusion to XLA; the Hopper
flash kernel where it wrote a Pallas kernel."""

from . import attention, flash_attention, kv_cache, rope
from .attention import attention as fused_attention
from .rope import apply_rope, llama31_rope_scaling, rope_frequencies

__all__ = ["attention", "flash_attention", "kv_cache", "rope",
           "fused_attention", "apply_rope", "rope_frequencies",
           "llama31_rope_scaling"]
