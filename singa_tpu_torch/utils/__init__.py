"""singa_tpu_torch.utils — checkpoints (``utils.checkpoint``) and
failure detection (``utils.failure``), ported from ``singa_tpu/utils``."""

from . import checkpoint, failure

__all__ = ["checkpoint", "failure"]
