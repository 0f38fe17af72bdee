"""Weight carry-over into the port from the JAX package's parameters
and states.

The reference model's ``{name: np.asarray(t.data) for name, t in
m.get_params().items()}`` names every parameter by its attribute path
(``get_states()`` adds the buffers, such as BatchNorm's running
statistics), and the port keeps those paths, so a model moves across by
name.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["load_reference_params", "load_reference_states"]


def _check_names(what: str, have, arrays) -> None:
    missing = sorted(set(have) - set(arrays))
    extra = sorted(set(arrays) - set(have))
    if missing or extra:
        raise KeyError(f"{what} names differ: missing {missing}, "
                       f"extra {extra}")


def load_reference_params(model, arrays: Dict[str, np.ndarray]) -> None:
    """Copy each array into the port's parameter of the same name.
    Raises on a missing name, an extra name or a shape mismatch."""
    _check_names("parameter", model.get_params(), arrays)
    model.set_params(arrays)


def load_reference_states(model, arrays: Dict[str, np.ndarray]) -> None:
    """`load_reference_params` over parameters and buffers (the names of
    the reference's ``get_states()``)."""
    _check_names("state", model.get_states(), arrays)
    model.set_states(arrays)
