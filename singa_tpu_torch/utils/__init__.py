"""singa_tpu_torch.utils — checkpoints (``utils.checkpoint``), failure
detection (``utils.failure``), data loading (``utils.data``), metrics
(``utils.metrics``) and forward FLOPs (``utils.flops``), ported from
``singa_tpu/utils``."""

from . import checkpoint, data, failure, flops, metrics

__all__ = ["checkpoint", "data", "failure", "flops", "metrics"]
