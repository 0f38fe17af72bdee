"""Forward FLOPs counted from a model's own operations, the counterpart
of ``singa_tpu/utils/flops.py``.

The reference walks the jaxpr of one forward; here one forward of a
single example runs eagerly under ``graph.record``, which sums the
formulas of ``torch.utils.flop_counter`` (2 FLOPs a multiply-add) over
the convolutions and matrix products that ran.  Counting what ran ties
the numerator of an MFU to the executed architecture.
"""

from __future__ import annotations

import torch

from .. import autograd
from ..graph import record

__all__ = ["model_forward_flops"]


def model_forward_flops(model, x) -> float:
    """Forward conv and matmul FLOPs of ONE example of `model` on an
    input shaped like `x` (only ``x[:1]`` runs), in eval mode, so no
    running statistic moves."""
    x = torch.as_tensor(x, device=model.device.torch_device)[:1]
    with torch.no_grad(), autograd.eval_mode():
        _, graph = record("flops", lambda: model.forward(x))
    return graph.flops()
