"""Event coalescing: collapse bursts before the application sees them
(the port's own copy of ``consul_tpu/models/coalesce.py``, which imports
nothing of JAX).

Mirrors the reference coalescer pipeline (serf/coalesce.go:
``coalesceLoop``, a quantum timer of ``coalesce_period`` capped by a
``quiescent_period`` idle timer; serf/coalesce_member.go, only the latest
event per member, repeats of the same type suppressed;
serf/coalesce_user.go, only the highest-Lamport-time version of each named
event, all same-ltime duplicates flushed together).

Timers are simulation ticks, not wall clocks, and the loop is an explicit
:meth:`tick` the host driver calls once per simulated tick, as every other
reference timer is a deadline here. Consumers (any host-side observer of
the simulated event plane) push raw events with :meth:`ingest`; flushed,
coalesced events come back from :meth:`tick`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Member event types (reference serf/event.go EventType).
MEMBER_JOIN = "member-join"
MEMBER_LEAVE = "member-leave"
MEMBER_FAILED = "member-failed"
MEMBER_UPDATE = "member-update"
MEMBER_REAP = "member-reap"
USER = "user"

_MEMBER_TYPES = {MEMBER_JOIN, MEMBER_LEAVE, MEMBER_FAILED, MEMBER_UPDATE,
                 MEMBER_REAP}


@dataclasses.dataclass
class Event:
    type: str
    name: str = ""            # member name, or user-event name
    ltime: int = 0            # user events only
    payload: bytes = b""
    coalesce: bool = True     # user events may opt out (UserEvent.Coalesce)


class _Loop:
    """The coalesceLoop state machine (coalesce.go:30-79), tick-driven."""

    def __init__(self, coalesce_period: int, quiescent_period: int):
        self.cp = coalesce_period
        self.qp = quiescent_period
        self.quantum_at: Optional[int] = None
        self.quiescent_at: Optional[int] = None

    def arm(self, now: int):
        if self.quantum_at is None:
            self.quantum_at = now + self.cp
        self.quiescent_at = now + self.qp

    def due(self, now: int) -> bool:
        return (self.quantum_at is not None and now >= self.quantum_at) or \
            (self.quiescent_at is not None and now >= self.quiescent_at)

    def reset(self):
        self.quantum_at = None
        self.quiescent_at = None


class MemberEventCoalescer:
    """coalesce_member.go: latest event per member wins; a flush skips
    members whose last *flushed* type is unchanged (unless update)."""

    def __init__(self, coalesce_period: int, quiescent_period: int):
        self._loop = _Loop(coalesce_period, quiescent_period)
        self._last: dict[str, str] = {}     # lastEvents
        self._latest: dict[str, Event] = {}  # latestEvents

    def handles(self, e: Event) -> bool:
        return e.type in _MEMBER_TYPES

    def ingest(self, e: Event, now: int) -> Optional[Event]:
        """Returns the event immediately when not coalescible
        (pass-through, coalesce.go:46-49), else buffers it."""
        if not self.handles(e):
            return e
        self._loop.arm(now)
        self._latest[e.name] = e
        return None

    def tick(self, now: int) -> list[Event]:
        if not self._loop.due(now):
            return []
        self._loop.reset()
        out = []
        for name, ev in sorted(self._latest.items()):
            prev = self._last.get(name)
            # Same event re-flushed is suppressed, except updates
            # (coalesce_member.go:44-49).
            if prev == ev.type and ev.type != MEMBER_UPDATE:
                continue
            self._last[name] = ev.type
            out.append(ev)
        self._latest.clear()
        return out


class UserEventCoalescer:
    """coalesce_user.go: per event name keep only the latest Lamport
    time; all same-ltime versions flush together."""

    def __init__(self, coalesce_period: int, quiescent_period: int):
        self._loop = _Loop(coalesce_period, quiescent_period)
        self._events: dict[str, tuple[int, list[Event]]] = {}

    def handles(self, e: Event) -> bool:
        return e.type == USER and e.coalesce

    def ingest(self, e: Event, now: int) -> Optional[Event]:
        if not self.handles(e):
            return e
        self._loop.arm(now)
        cur = self._events.get(e.name)
        if cur is None or cur[0] < e.ltime:
            self._events[e.name] = (e.ltime, [e])
        elif cur[0] == e.ltime:
            cur[1].append(e)
        return None

    def tick(self, now: int) -> list[Event]:
        if not self._loop.due(now):
            return []
        self._loop.reset()
        out = []
        for _, (_, evs) in sorted(self._events.items()):
            out.extend(evs)
        self._events.clear()
        return out


class CoalescePipeline:
    """Both coalescers chained, the way serf wires them when
    CoalescePeriod/UserCoalescePeriod are set (serf.go Create)."""

    def __init__(self, coalesce_period: int = 5, quiescent_period: int = 1,
                 user_coalesce_period: int = 5,
                 user_quiescent_period: int = 1):
        self.member = MemberEventCoalescer(coalesce_period, quiescent_period)
        self.user = UserEventCoalescer(user_coalesce_period,
                                       user_quiescent_period)

    def ingest(self, e: Event, now: int) -> list[Event]:
        out = self.member.ingest(e, now)
        if out is None:
            return []
        out = self.user.ingest(out, now)
        return [] if out is None else [out]

    def tick(self, now: int) -> list[Event]:
        return self.member.tick(now) + self.user.tick(now)
