"""The in-process heartbeat deadline of a run (a copy of
``HeartbeatMonitor`` from ``consul_tpu/runtime/watchdog.py``).

The run loop beats at every chunk boundary; a missed deadline classifies
the hang (``mid-run-hang`` after a completed chunk, ``backend-init-hang``
before the first) and hands the last completed state to an ``on_hang``
callback, which the resilient harness uses to write a diagnostic
checkpoint while the main thread is still blocked on the card. Each beat
takes the chunk's finished state mirrored to the host
(``checkpoint.to_host``), since a wedged card cannot serve a copy after
the fact.

The reference's ``InitWatchdog`` and ``with_failover`` (a supervisor of
child processes with a failover to the CPU) are not here: the port never
falls back to the CPU.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger(__name__)

# Status strings (stable: report consumers key on them).
OK = "ok"
INIT_HANG = "backend-init-hang"
MID_RUN_HANG = "mid-run-hang"


class HeartbeatMonitor:
    """In-process per-chunk heartbeat deadline: the run loop calls
    :meth:`beat` at every chunk boundary; if no beat lands within
    ``heartbeat_s`` the monitor thread classifies the hang —
    MID_RUN_HANG when at least one chunk completed, INIT_HANG when the
    very first chunk (compile + first execution) never finished — and
    fires ``on_hang(status, ticks_done, last_state)`` exactly once.

    The main thread is blocked inside the wedged device computation
    when this fires, so ``on_hang`` runs on the monitor thread and
    must only touch already-completed buffers: :meth:`beat` stashes a
    reference to the last chunk's finished state for exactly that
    purpose (the resilient harness checkpoints it as the diagnostic
    state). ``sink`` counts the classification
    (``sim.runtime.mid_run_hangs`` / ``sim.runtime.backend_hangs``)
    so the hang is visible in metrics even when the process never
    returns."""

    def __init__(self, heartbeat_s: float, *,
                 on_hang: Optional[Callable[[str, int, Any], None]] = None,
                 sink=None, poll_s: Optional[float] = None):
        self.heartbeat_s = float(heartbeat_s)
        self.on_hang = on_hang
        self.sink = sink
        self.poll_s = poll_s if poll_s is not None \
            else max(0.05, self.heartbeat_s / 4.0)
        self.status: Optional[str] = None  # None until a hang fires
        self.beats = 0
        self.ticks_done = 0
        self._last_state: Any = None
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatMonitor":
        self._last_beat = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, name="heartbeat-monitor", daemon=True)
        self._thread.start()
        return self

    def beat(self, ticks_done: int, state: Any = None):
        """Mark liveness at a chunk boundary; ``state`` (optional) is
        the chunk's completed state pytree — the newest buffers that
        are guaranteed ready if a later computation wedges."""
        self.beats += 1
        self.ticks_done = int(ticks_done)
        if state is not None:
            self._last_state = state
        self._last_beat = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.poll_s))

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _watch(self):
        while not self._stop.wait(self.poll_s):
            if time.monotonic() - self._last_beat <= self.heartbeat_s:
                continue
            self.status = MID_RUN_HANG if self.beats else INIT_HANG
            if self.sink is not None:
                self.sink.incr_counter(
                    "sim.runtime.mid_run_hangs" if self.beats
                    else "sim.runtime.backend_hangs", 1)
            if self.on_hang is not None:
                try:
                    self.on_hang(self.status, self.ticks_done,
                                 self._last_state)
                except Exception:
                    # Diagnosis must not kill the monitor — the
                    # classification already landed in .status and
                    # the sink; the failed dump is worth a traceback.
                    log.warning("heartbeat on_hang callback failed",
                                exc_info=True)
            return  # one-shot: a hang is terminal for this run
