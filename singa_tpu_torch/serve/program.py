"""One program of the serving engine: a body over static device tensors,
captured as a CUDA graph on a card.

The engine's prefill, decode and verify programs and the spill tier's
restore program are each a :class:`Program`.  Its first dispatch runs
the body eagerly (on a card, on a side stream, as a capture's warm-up
needs) and records it (``graph.record``); on a card the second dispatch
captures it as a CUDA graph and replays it, and every later one
replays.  On the CPU every dispatch runs the body.  What a body reads
and writes must stay at fixed addresses: host-side updates write into
those tensors in place, never rebind them.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional

import torch

from ..graph import CapturedGraph, record
from ..obs import events

__all__ = ["Program"]


class Program:
    """A body that reads and writes only static device tensors,
    dispatched eagerly once, then captured and replayed on a card."""

    def __init__(self, name: str, body: Callable[[], None],
                 device: torch.device):
        self.name, self.body, self.device = name, body, device
        self.calls = 0
        self.graph: Optional[CapturedGraph] = None
        self._stream = None

    @property
    def count(self) -> int:
        """Programs made: 0 until the first dispatch, which runs the body
        eagerly and records it, then 1 — as the reference's jit cache
        holds one entry from the first call on.  Whether a card has
        captured it yet (at the second dispatch) is
        ``graph.graph is not None``."""
        return int(self.graph is not None)

    def __call__(self) -> None:
        if self.calls == 0:
            self._first()
        elif self.device.type != "cuda":
            self.body()
        else:
            if self.graph.graph is None:
                with events.span("graph.compile", graph=self.name):
                    self.graph.capture(self.body, self._stream)
            self.graph.replay()
        self.calls += 1

    def _first(self) -> None:
        ctx = nullcontext()
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            _, self.graph = record(self.name, self.body)
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
