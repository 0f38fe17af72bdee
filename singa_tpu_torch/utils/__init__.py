"""singa_tpu_torch.utils — checkpoints (``utils.checkpoint``), failure
detection (``utils.failure``), data loading (``utils.data``), metrics
(``utils.metrics``), step timing (``utils.timing``), profiling
(``utils.profiler``) and forward FLOPs (``utils.flops``), ported from
``singa_tpu/utils``."""

from . import checkpoint, data, failure, flops, metrics, profiler, timing

__all__ = ["checkpoint", "data", "failure", "flops", "metrics", "profiler",
           "timing"]
