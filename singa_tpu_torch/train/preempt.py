"""Preemption handling — SIGTERM/SIGINT become a checkpoint request,
ported from ``singa_tpu/train/preempt.py``.

Cluster schedulers preempt with SIGTERM and a grace window; a human
preempts with Ctrl-C.  Either way the right response is the same:
finish the step in flight, write a final checkpoint, exit cleanly so
the next incarnation resumes the trajectory.  :class:`PreemptionHandler`
turns the signal into a flag the :class:`~singa_tpu_torch.train.
loop.TrainRunner` polls at each step boundary — signal-handler context does
no work itself (handlers run between bytecodes on the main thread; a
checkpoint write there could interleave with anything).

A second Ctrl-C (SIGINT) while the request is pending raises
KeyboardInterrupt — the operator asking twice means *now*, and losing
progress since the last periodic checkpoint is their call.
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Optional, Tuple

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Installable SIGTERM/SIGINT → checkpoint-and-exit request flag.

        with PreemptionHandler() as p:
            for step in ...:
                train_step(...)
                if p.requested:
                    save_checkpoint(); break
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._prev: dict = {}
        self._installed = False
        self._signum: Optional[int] = None

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    @property
    def signum(self) -> Optional[int]:
        """The signal that made the request (None until one arrives)."""
        return self._signum

    def _handle(self, signum, frame) -> None:
        if self._requested.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt   # second Ctrl-C: exit NOW
        # no lock: a handler runs between bytecodes ON the main thread
        # (no parallel writer), and a lock could deadlock against the
        # interrupted holder
        self._signum = signum
        self._requested.set()

    def install(self) -> "PreemptionHandler":
        """Idempotent; degrades to a no-op (with a warning) off the main
        thread, where CPython forbids installing handlers."""
        if self._installed:
            return self
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handle)
            self._installed = True
        except ValueError:   # not the main thread
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            warnings.warn(
                "PreemptionHandler: not on the main thread; signals will "
                "not request checkpoints", stacklevel=2)
        return self

    def uninstall(self) -> None:
        """Restore the handlers that were installed before us."""
        if not self._installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:   # pragma: no cover - teardown off-main
                pass
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False
