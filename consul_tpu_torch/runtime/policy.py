"""Checkpoint policy: when to save, where, and what provenance rides
along (a copy of ``consul_tpu/runtime/policy.py``, over the port's
``utils/checkpoint``).

Triggers, composable per save decision (:meth:`CheckpointPolicy.due`):

- **interval**: at most once per ``min_interval_s`` of wall time;
  ``every_ticks`` only bounds the slice between trigger checks.
- **on-signal**: a :class:`SignalTrap` records SIGTERM (the preemption
  notice every scheduler sends before SIGKILL); the next chunk boundary
  saves immediately and the harness exits cleanly.
- **on-hang**: anything that owns a liveness view (a watchdog thread, an
  external monitor) calls :meth:`CheckpointPolicy.request`; the next
  boundary saves regardless of pacing.

The save is utils/checkpoint's digest-verified atomic-rename write. Run
provenance (ticks done, the chaos schedule's tick offset and digest, the
draw generator's state) rides in the checkpoint manifest, replaced in
the same rename as the leaves, and is what a resume reads. The
``.meta.json`` sidecar mirrors it for tools that do not parse the
checkpoint; it is written after the rename, so a kill between the two
can leave it one save behind, and nothing here reads it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Optional

from consul_tpu_torch.utils import checkpoint as ckpt_mod

log = logging.getLogger(__name__)


class SignalTrap:
    """Record (rather than act on) termination signals so the run loop
    can checkpoint at the next chunk boundary — the preemption grace
    window turned into at-most-one-chunk of lost work. Restores the
    previous handlers on exit; outside the main thread (where Python
    forbids signal handlers) it degrades to an inert trap."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.fired: Optional[int] = None
        self._prev: dict = {}

    def _handle(self, signum, frame):
        self.fired = signum

    def __enter__(self) -> "SignalTrap":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        return False


@dataclasses.dataclass
class CheckpointPolicy:
    """One run's checkpoint cadence + provenance. ``tag`` names the
    checkpoint file (``{directory}/{tag}.ckpt``) — one trajectory, one
    file, atomically replaced on every save (a torn write can never
    replace a good checkpoint, utils/checkpoint.save)."""

    directory: str
    tag: str
    every_ticks: int = 0
    min_interval_s: float = 120.0
    sink: Optional[Any] = None  # telemetry.Sink for failure counters
    trap: Optional[SignalTrap] = None

    def __post_init__(self):
        self._last_save = time.monotonic()
        self._requested = False
        self.failures = 0
        self.first_error: Optional[BaseException] = None

    # -- paths ----------------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.directory, f"{self.tag}.ckpt")

    @property
    def meta_path(self) -> str:
        return self.path + ".meta.json"

    # -- triggers -------------------------------------------------------
    def request(self):
        """The on-hang trigger: force a save at the next boundary.
        Thread-safe (a bool store) — watchdog threads call this while
        the main thread is blocked inside a device computation."""
        self._requested = True

    @property
    def signal_pending(self) -> bool:
        return self.trap is not None and self.trap.fired is not None

    def wall_due(self) -> bool:
        return time.monotonic() - self._last_save >= self.min_interval_s

    def due(self, ticks_since_save: int = 0) -> bool:
        """Should the caller save at this chunk boundary?"""
        if self._requested or self.signal_pending:
            return True
        if self.every_ticks and ticks_since_save >= self.every_ticks:
            return self.wall_due()
        return self.wall_due() if self.every_ticks == 0 else False

    def mark_run_start(self):
        """Reset the wall pacing clock (call when the timed region
        starts, so compile/warmup time is not charged to the
        interval)."""
        self._last_save = time.monotonic()

    # -- save / load ----------------------------------------------------
    def save(self, state: Any, meta: dict) -> str:
        """Checkpoint ``state`` with ``meta`` provenance. Raises on
        failure (callers that must survive checkpoint trouble use
        :meth:`try_save`)."""
        os.makedirs(self.directory, exist_ok=True)
        digest = ckpt_mod.save(self.path, state, meta=meta)
        with open(self.meta_path, "w") as f:
            json.dump(dict(meta, saved_at=time.time()), f)
        self._last_save = time.monotonic()
        self._requested = False
        return digest

    def try_save(self, state: Any, meta: dict) -> bool:
        """Best-effort save: a checkpoint failure must never fail the
        run it exists to protect — but it must not vanish either.
        Failures are narrowed to the I/O-and-serialization classes
        (anything else is a real bug and propagates), counted into the
        telemetry sink, and the first one is logged with its traceback."""
        try:
            self.save(state, meta)
            return True
        except (OSError, ValueError) as e:
            self.failures += 1
            if self.sink is not None:
                self.sink.incr_counter("sim.runtime.ckpt_failures", 1)
            if self.first_error is None:
                self.first_error = e
                log.warning("checkpoint save failed (first of possibly "
                            "many; further failures counted silently): %r",
                            e, exc_info=True)
            return False

    def read_meta(self) -> Optional[dict]:
        """The provenance in the checkpoint's manifest (atomic with its
        leaves), or None when the checkpoint is absent or unreadable."""
        try:
            return ckpt_mod.read_meta(self.path)
        except (OSError, ValueError):
            return None

    def load(self, template: Any, match: Optional[dict] = None):
        """Restore the checkpoint into ``template``'s structure if one
        exists and its provenance agrees with ``match`` (every key in
        ``match`` must equal the stored meta's value — the trajectory's
        identity: shape, phase, injected-failure parameters, chaos
        schedule digest). Returns ``(state, meta)`` or ``(None, None)``
        when there is nothing (or nothing compatible) to resume.
        Corruption raises (utils/checkpoint's digest verification) so
        the caller decides between restart-clean and fail."""
        if not os.path.exists(self.path):
            return None, None
        meta = ckpt_mod.read_meta(self.path)
        if meta is None:
            return None, None
        for k, v in (match or {}).items():
            if meta.get(k) != v:
                return None, None
        state = ckpt_mod.restore(self.path, template)
        return state, meta

    def retire(self):
        """Remove the checkpoint pair — only a COMPLETED run retires
        its checkpoint; an interrupted one keeps it for the next run."""
        for p in (self.path, self.meta_path):
            try:
                os.unlink(p)
            except OSError:
                pass
