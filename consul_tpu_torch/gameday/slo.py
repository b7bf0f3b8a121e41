"""Game-day SLO contract: thresholds as data, the verdict as one dict
(the port's copy of ``consul_tpu/gameday/slo.py``; pure Python).

The soak harness (``gameday/harness.py``) measures; this module judges.
:class:`SloThresholds` is the pass/fail envelope: per-class p99 latency
ceilings, the zero-lost-writes invariant, the bounded time to heal, the
watch delivery-lag bound. :func:`evaluate` folds a measurement dict into
the one verdict shape:

``{"pass": bool, "violations": [...], "p99_read_ms", "p99_write_ms",
  "p99_watch_ms", "lost_writes", "max_time_to_heal_ticks",
  "watch_delivery_lag", "shed", "rejected", ...}``

The golden regression points live next door in ``slo_goldens.json``,
measured by the port's ``gameday/goldens.py`` on the CPU (values in
ticks), so a change that degrades worst-case heal time or raft commit
visibility fails a fast test.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

GOLDENS_PATH = os.path.join(os.path.dirname(__file__), "slo_goldens.json")


@dataclasses.dataclass(frozen=True)
class SloThresholds:
    """The game-day pass/fail envelope. Latency ceilings are generous
    by design (CPU CI boxes included); the hard invariants are the
    interesting gates: ``lost_writes`` MUST be 0 (X-Consul-Index
    continuity across leader kill), heal time MUST be bounded, and
    the watch plane MUST catch up by drain."""

    p99_read_ms: float = 2000.0
    p99_write_ms: float = 2000.0
    p99_watch_ms: float = 4000.0
    max_lost_writes: int = 0
    max_time_to_heal_ticks: int = 4096
    max_watch_delivery_lag: int = 0
    # Shed/reject ceilings: None = unbounded (reported, not gated).
    max_shed: Optional[int] = None
    max_rejected: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# The measurement keys evaluate() gates on, with the comparison each
# threshold applies (latencies and counts are ceilings).
_GATES = (
    ("p99_read_ms", "p99_read_ms"),
    ("p99_write_ms", "p99_write_ms"),
    ("p99_watch_ms", "p99_watch_ms"),
    ("lost_writes", "max_lost_writes"),
    ("max_time_to_heal_ticks", "max_time_to_heal_ticks"),
    ("watch_delivery_lag", "max_watch_delivery_lag"),
    ("shed", "max_shed"),
    ("rejected", "max_rejected"),
)


def evaluate(measured: dict,
             thresholds: Optional[SloThresholds] = None) -> dict:
    """Fold a harness measurement dict into the stable SLO verdict.

    ``measured`` must carry every gated key (missing keys are
    violations — a soak that could not measure a gate does not pass).
    The verdict is ``measured`` plus ``pass``/``violations``/
    ``thresholds``; the harness merges its own context (phases,
    counters, chaos deltas) around it."""
    th = thresholds if thresholds is not None else SloThresholds()
    violations = []
    for key, tkey in _GATES:
        limit = getattr(th, tkey)
        if limit is None:
            continue
        if key not in measured:
            violations.append(f"{key}: not measured (gate {tkey}<={limit})")
            continue
        val = measured[key]
        if val is None or val > limit:
            violations.append(f"{key}={val} exceeds {tkey}={limit}")
    out = dict(measured)
    out["pass"] = not violations
    out["violations"] = violations
    out["thresholds"] = th.to_dict()
    return out


def load_goldens(path: Optional[str] = None) -> dict:
    """The checked-in golden regression points (satellite alarm):
    worst-case topology heal time at a fixed (n, degree, scenarios)
    sweep point and the raft commit-visibility p99 from the bench
    ladder, each with the config that measured it and the tolerance a
    future PR must stay within."""
    with open(path or GOLDENS_PATH, encoding="utf-8") as f:
        return json.load(f)
