"""singa_tpu_torch.ops — attention (full and banded), ring attention
(sequence parallelism over the ``seq`` mesh axis), RoPE, the KV cache,
the mixture-of-experts FFN and the recurrences of the RNN layers.  Plain torch where the JAX package left fusion to XLA; the Hopper
flash kernel where it wrote a Pallas kernel."""

from . import attention, flash_attention, kv_cache, moe, rnn, rope
from .attention import attention as fused_attention
# the function shadows its module here, as in the JAX package; the
# module stays importable as singa_tpu_torch.ops.ring_attention
from .ring_attention import ring_attention, ring_attention_local
from .rope import apply_rope, llama31_rope_scaling, rope_frequencies

__all__ = ["attention", "flash_attention", "kv_cache", "moe", "rnn", "rope",
           "ring_attention", "ring_attention_local",
           "fused_attention", "apply_rope", "rope_frequencies",
           "llama31_rope_scaling"]
