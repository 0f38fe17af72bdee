"""The unit marker of the ONNX exporter (``sonnx.export``).

The exporter records a forward pass through a ``TorchFunctionMode``,
which sees every torch call.  A function marked ``@unit(kind)`` has a
one-node (or fixed-decomposition) ONNX form: while a recorder is
active, the call is recorded once, as `kind` with its bound arguments,
and the torch calls inside it are not recorded.  With no recorder
active the marker only reads one module global, so it changes nothing
that a step launches or captures.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

__all__ = ["unit", "set_recorder"]

#: the active recorder (sonnx.export._Recorder), or None
_recorder: Optional[Any] = None


def set_recorder(rec) -> Optional[Any]:
    """Make `rec` the active recorder; returns the one it replaces."""
    global _recorder
    prev, _recorder = _recorder, rec
    return prev


def unit(kind: str) -> Callable:
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            rec = _recorder
            if rec is None:
                return fn(*args, **kwargs)
            return rec.unit(kind, fn, args, kwargs)
        return wrapped
    return deco
