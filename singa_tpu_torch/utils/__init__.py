"""singa_tpu_torch.utils — checkpoints (``utils.checkpoint``), ported
from ``singa_tpu/utils``."""

from . import checkpoint

__all__ = ["checkpoint"]
