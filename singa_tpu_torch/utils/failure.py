"""Failure detection / clean abort, ported from
``singa_tpu/utils/failure.py``.

Heartbeat + clean abort, so a failure surfaces as an error instead of
an indefinite hang.  Two mechanisms:

* `Heartbeat` — liveness watchdog for a step loop.  The loop calls
  `beat()` every step; a monitor thread raises the alarm when no beat
  arrives within `timeout` (a hung collective, a wedged card, a
  stalled input pipeline all look the same from here — which is the
  point).  The serve engine's `recover_on_hang` path rides it.
* `device_liveness_check` — active probe: submit a trivial op to the
  device and require it to complete within a deadline.  Catches a dead
  CUDA context without waiting for the next step.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

__all__ = ["Heartbeat", "device_liveness_check", "clean_abort",
           "FailureDetected"]


class FailureDetected(RuntimeError):
    pass


def clean_abort(msg: str, exit_code: int = 42) -> None:
    """Default failure action: loud message, immediate hard exit with a
    recognizable code so the launcher can restart-from-checkpoint.
    os._exit (not sys.exit) because the hung thread we're aborting over
    would block normal interpreter shutdown."""
    print(f"[singa_tpu_torch.failure] FATAL: {msg}", file=sys.stderr, flush=True)
    os._exit(exit_code)


class Heartbeat:
    """Step-liveness watchdog.

        hb = Heartbeat(timeout=300)        # 5 min per step budget
        hb.start()
        for step in ...:
            train_step(...)
            hb.beat(step)
        hb.stop()

    `on_failure(age_s, last_step)` defaults to `clean_abort`; tests pass
    a callback instead.

    Trace contexts: the monitor thread deliberately DROPS
    the spawner's ``obs.trace`` context — ``threading.Thread`` never
    inherits contextvars, and this is the designed behavior here, not
    an accident: hang detection observes the whole loop, so attributing
    its events to whichever request/step happened to be active when
    ``start()`` ran would fabricate a causal link the watchdog does not
    have.  ``on_failure`` therefore fires trace-less; a worker that
    SHOULD carry a trace uses ``obs.trace.capture()``/``attach()``."""

    def __init__(self, timeout: float = 300.0, check_every: float = 1.0,
                 on_failure: Optional[Callable[[float, int], None]] = None):
        self.timeout = float(timeout)
        self.check_every = float(check_every)
        self.on_failure = on_failure or (
            lambda age, step: clean_abort(
                f"no heartbeat for {age:.1f}s (last step {step}); "
                f"assuming hung collective or dead device"))
        self._last = time.monotonic()
        self._last_step = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._fired = False

    def start(self) -> "Heartbeat":
        # each start gets a FRESH stop event, passed to its own monitor
        # thread.  The old restartable-after-stop() design CLEARED the
        # shared event instead, and a stop()+start() re-arm (the serve
        # engine's recover_on_hang path does exactly this after every
        # hang) could clear it inside the old monitor's wait() window —
        # the old thread missed the brief set, saw a cleared event, and
        # kept running alongside the new monitor: two watchdogs, double
        # on_failure fires.  With a per-generation event, the old
        # thread's event stays set forever once stopped.  Setting the
        # outgoing event first keeps start() safe WITHOUT an
        # intervening stop(): a previous generation must never be
        # orphaned holding an event nothing can set anymore.
        self._stop.set()
        self._stop = threading.Event()
        self._fired = False
        self._last = time.monotonic()
        # ALWAYS a daemon: the monitor exists to watch for wedged
        # threads, so it must never itself keep a dying interpreter
        # alive waiting on a join
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="singa-heartbeat",
                                        args=(self._stop,))
        self._thread.start()
        return self

    def beat(self, step: int = -1) -> None:
        self._last = time.monotonic()
        self._last_step = step

    def stop(self) -> None:
        """Idempotent shutdown: safe before start(), safe to call
        repeatedly, and safe from the monitor thread itself (an
        on_failure callback tearing the watchdog down must not
        self-join) — so an owner's __exit__ can always call it without
        hanging interpreter shutdown."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2 * self.check_every)

    @property
    def fired(self) -> bool:
        return self._fired

    def _run(self, stop: threading.Event) -> None:
        # ``stop`` is THIS generation's event (never self._stop, which
        # a re-arm may already have replaced with the next monitor's)
        while not stop.wait(self.check_every):
            age = time.monotonic() - self._last
            if age > self.timeout:
                # the monitor thread is the only writer; start() resets
                # it before the thread exists; readers poll a latch
                self._fired = True
                try:
                    self.on_failure(age, self._last_step)
                finally:
                    return

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def device_liveness_check(device=None, timeout: float = 30.0) -> bool:
    """Submit a trivial computation and require completion within
    `timeout` seconds.  `device` is a port ``Device``, a
    ``torch.device`` or None (the default device).  The probe runs in a
    *daemon* thread (not a ThreadPoolExecutor: its atexit hook joins
    workers, so a wedged CUDA context would hang interpreter shutdown —
    the exact dead-device case this probe exists to detect)."""
    import queue

    import torch

    q: "queue.Queue" = queue.Queue()

    def probe():
        try:
            if device is None:
                from ..device import get_default_device
                d = get_default_device().torch_device
            else:
                d = getattr(device, "torch_device", device)
            # .item() reads the result back: the probe completes only
            # once the device has run it
            q.put(float((torch.ones((), device=d) + 1).item()))
        except Exception:
            q.put(None)

    threading.Thread(target=probe, daemon=True,
                     name="singa-liveness-probe").start()
    try:
        return q.get(timeout=timeout) == 2.0
    except queue.Empty:
        return False
