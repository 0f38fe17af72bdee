"""Weight carry-over into the port from the JAX package's parameters.

The reference model's ``{name: np.asarray(t.data) for name, t in
m.get_params().items()}`` names every parameter by its attribute path,
and the port keeps those paths, so a model moves across by name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["load_reference_params"]


def load_reference_params(model, arrays: Dict[str, np.ndarray]) -> None:
    """Copy each array into the port's parameter of the same name.
    Raises on a missing name, an extra name or a shape mismatch."""
    params = model.get_params()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"extra {extra}")
    for name, p in params.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)} does not "
                             f"match the port's {tuple(p.shape)}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.tensor(np.asarray(arrays[name], np.float32)))
