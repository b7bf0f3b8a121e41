"""Hang watchdogs of a run (PyTorch port of
``consul_tpu/runtime/watchdog.py``): :class:`InitWatchdog` and
:class:`HeartbeatMonitor`, copies of the reference's.

- :class:`InitWatchdog` supervises a child process that owns the card:
  it kills the child early when the init window expires before the child
  proves readiness (``backend-init-hang``), or, with ``heartbeat_s``,
  when a ready child stops making observable progress
  (``mid-run-hang``), or at the hard deadline (``timeout``). After an
  init-hang kill it writes the CUDA-init black box
  (``obs/blackbox.py``) into ``blackbox_dir``.
- :class:`HeartbeatMonitor` is the in-process tier: the run loop beats at
  every chunk boundary; a missed deadline classifies the hang
  (``mid-run-hang`` after a completed chunk, ``backend-init-hang`` before
  the first) and hands the last completed state to an ``on_hang``
  callback, which the resilient harness uses to write a diagnostic
  checkpoint while the main thread is still blocked on the card. Each
  beat takes the chunk's finished state mirrored to the host
  (``checkpoint.to_host``), since a wedged card cannot serve a copy after
  the fact.

- :func:`with_failover` retries an attempt on init-hang and fails over
  to the next platform, as the reference's does, except that a failover
  to the CPU raises :class:`FailoverRefused`: the port never falls back
  to the CPU (ROADMAP A20).
"""

from __future__ import annotations

import dataclasses
import logging
import subprocess
import threading
import time
from typing import Any, Callable, Optional, Sequence

log = logging.getLogger(__name__)

# Status strings (stable: report consumers key on them).
OK = "ok"
INIT_HANG = "backend-init-hang"
MID_RUN_HANG = "mid-run-hang"
TIMEOUT = "timeout"


@dataclasses.dataclass
class InitWatchdog:
    """Supervise one child process: kill it early if it has not proven
    liveness (``ready()`` true) within ``init_window_s``, or at the hard
    ``deadline`` either way. ``ready`` is polled between waits: any cheap
    host-side probe (a phase line in the child's output file)."""

    init_window_s: float = 300.0
    poll_s: float = 10.0
    heartbeat_s: float = 0.0  # 0 disables mid-run stall detection
    # Where the CUDA-init black box lands (obs/blackbox.py): when set, an
    # INIT_HANG kill is followed by a best-effort capture of the
    # environment, CUDA versions, bring-up progress, the child's tail and
    # the host spans into ``<blackbox_dir>/blackbox.json``; the path is
    # published on ``self.blackbox_path`` for the caller to link.
    blackbox_dir: Optional[str] = None

    def watch(self, proc: subprocess.Popen, ready: Callable[[], bool],
              deadline: float,
              progress: Optional[Callable[[], Any]] = None,
              child_tail: Optional[Callable[[], Optional[str]]] = None
              ) -> str:
        """Block until the child exits or is killed; returns OK /
        INIT_HANG / MID_RUN_HANG / TIMEOUT (the exit code is the caller's
        business). ``deadline`` is an absolute ``time.monotonic()`` stamp.

        ``progress`` (optional, with ``heartbeat_s > 0``) is a cheap probe
        of the child's forward motion (any value that changes while the
        child works: its output file's size). Once the child has proven
        readiness, a progress value frozen for longer than
        ``heartbeat_s`` classifies it as a MID_RUN_HANG: the card came up
        and then wedged, a different diagnosis than never coming up.

        ``child_tail`` (optional) returns the tail of the child's output
        for the black box, consulted only after an INIT_HANG kill."""
        self.blackbox_path: Optional[str] = None
        t0 = time.monotonic()
        seen_ready = False
        last_progress = progress() if progress is not None else None
        last_beat = t0
        try:
            while True:
                step = min(self.poll_s, max(0.1, deadline - time.monotonic()))
                try:
                    proc.wait(timeout=step)
                    return OK
                except subprocess.TimeoutExpired:
                    pass
                now = time.monotonic()
                if now >= deadline:
                    raise subprocess.TimeoutExpired(
                        proc.args, deadline - t0)
                if not seen_ready and ready():
                    seen_ready = True
                    last_beat = now  # the stall clock starts at readiness
                if now - t0 > self.init_window_s and not seen_ready:
                    self._kill(proc)
                    self._capture_blackbox(child_tail)
                    return INIT_HANG
                if progress is not None and self.heartbeat_s > 0 \
                        and seen_ready:
                    cur = progress()
                    if cur != last_progress:
                        last_progress, last_beat = cur, now
                    elif now - last_beat > self.heartbeat_s:
                        self._kill(proc)
                        return MID_RUN_HANG
        except subprocess.TimeoutExpired:
            self._kill(proc)
            return TIMEOUT

    def _capture_blackbox(self, child_tail):
        """Best-effort postmortem (obs/blackbox.py) after an init-hang
        kill. A failed capture must not mask the INIT_HANG diagnosis."""
        if not self.blackbox_dir:
            return
        import os

        from consul_tpu_torch.obs import blackbox
        try:
            tail = child_tail() if child_tail is not None else None
            self.blackbox_path = os.path.join(
                self.blackbox_dir, "blackbox.json")
            blackbox.capture(self.blackbox_path, status=INIT_HANG,
                             child_tail=tail)
        except Exception:  # noqa: BLE001
            log.warning("blackbox capture failed", exc_info=True)
            self.blackbox_path = None

    @staticmethod
    def _kill(proc: subprocess.Popen):
        proc.kill()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            pass  # keep the original diagnosis; the child is a zombie


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


class FailoverRefused(RuntimeError):
    """``with_failover`` would have degraded to the CPU."""


def with_failover(attempt: Callable[[str], dict],
                  platforms: Sequence[str], *,
                  max_retries: int = 1,
                  sink=None):
    """Run ``attempt(platform)`` (returning a dict with a ``status`` key)
    with bounded retries on init-hang, failing over to the next platform
    when a platform's retries are exhausted (reference
    ``runtime/watchdog.with_failover``). Returns ``(result,
    provenance)``::

        {"platform":      the platform that produced the result,
         "degraded_from": first platform given up on (None if primary),
         "retries":       hang-triggered re-attempts,
         "hang_wall_s":   wall seconds burned inside hangs,
         "attempts":      [{"platform", "status", "wall_s",
                            "blackbox"}, ...]}

    Only INIT_HANG retries or fails over; a child that ran and crashed or
    timed out while working is an answer and is returned as is. A
    failover onto a ``"cpu"`` platform raises :class:`FailoverRefused`
    (after counting the hang), where the reference degrades: the port
    does not answer a card's question on the CPU. A run asked of the CPU
    from the start (``platforms[0] == "cpu"``) is not a failover. ``sink``
    (telemetry.Sink) counts hangs and failovers."""
    prov = {"platform": None, "degraded_from": None, "retries": 0,
            "hang_wall_s": 0.0, "attempts": []}
    result = None
    for i, plat in enumerate(platforms):
        if i > 0 and str(plat).split(":")[0] == "cpu":
            raise FailoverRefused(
                f"{platforms[i - 1]!r} hung at init {prov['retries']} "
                f"time(s); failing over to {plat!r} is refused: the port "
                "never falls back to the CPU")
        for _ in range(max_retries + 1):
            result = attempt(plat)
            prov["attempts"].append({
                "platform": plat,
                "status": result.get("status"),
                "wall_s": result.get("wall_s"),
                "blackbox": result.get("blackbox"),
            })
            if result.get("status") != INIT_HANG:
                prov["platform"] = plat
                return result, prov
            prov["hang_wall_s"] += float(result.get("wall_s") or 0.0)
            if sink is not None:
                sink.incr_counter("sim.runtime.backend_hangs", 1)
            prov["retries"] += 1
        # Retries exhausted on this platform: degrade to the next.
        if i + 1 < len(platforms):
            if prov["degraded_from"] is None:
                prov["degraded_from"] = plat
            if sink is not None:
                sink.incr_counter("sim.runtime.degraded_failovers", 1)
    prov["platform"] = platforms[-1] if platforms else None
    return result, prov
