"""Telemetry: a go-metrics-style in-memory sink with the reference's
metric names (PyTorch port of ``consul_tpu/utils/telemetry.py``).

:class:`Sink`, :func:`to_prometheus` and :func:`emit_counter_deltas` are
copies of the reference's: gauges, counters and samples with the
go-metrics API shape (SetGauge/IncrCounter/AddSample/MeasureSince) and
the DisplayMetrics JSON schema on snapshot.

:func:`emit_sim_metrics` records one chunk boundary under the names the
reference's gossip stack emits (``memberlist.health.score``,
``memberlist.gossip``, ``serf.coordinate.adjustment-ms``,
``serf.coordinate.resets``, ``serf.queue.Event``, ``sim.*``). It reads
the packed leaves where the state is packed (awareness u8, the flag bits,
``viv.adjustment`` bf16, ``viv.resets`` u8, the serf ``ev_key``) and
makes one batched device -> host fetch for every scalar it records.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

import torch

from consul_tpu_torch.models.counters import METRIC_NAMES

LOGGER_NAME = "consul_tpu_torch"

# Bounded per-aggregate sample window for the percentile views.
_PCTL_WINDOW = 512


class _Aggregate:
    __slots__ = ("count", "total", "min", "max", "recent")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.recent = deque(maxlen=_PCTL_WINDOW)

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.recent.append(v)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the bounded recent window."""
        if not self.recent:
            return 0.0
        vals = sorted(self.recent)
        return vals[min(len(vals) - 1, int(len(vals) * q))]

    def view(self, name: str) -> dict:
        mean = self.total / self.count if self.count else 0.0
        return {"Name": name, "Count": self.count, "Sum": self.total,
                "Min": self.min if self.count else 0.0,
                "Max": self.max if self.count else 0.0, "Mean": mean,
                "P50": self.percentile(0.5), "P99": self.percentile(0.99)}


class Sink:
    """In-memory metrics sink (armon/go-metrics InmemSink contract)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gauges: dict[str, float] = {}
        self._counters: dict[str, _Aggregate] = {}
        self._samples: dict[str, _Aggregate] = {}

    def set_gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = float(value)

    def incr_counter(self, name: str, n: float = 1.0):
        with self._lock:
            self._counters.setdefault(name, _Aggregate()).add(float(n))

    def add_sample(self, name: str, value: float):
        with self._lock:
            self._samples.setdefault(name, _Aggregate()).add(float(value))

    def measure_since(self, name: str, t0: float):
        """MeasureSince: elapsed milliseconds sample (go-metrics)."""
        self.add_sample(name, (time.perf_counter() - t0) * 1000.0)

    def counter_sum(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            agg = self._counters.get(name)
            return agg.total if agg is not None else default

    def gauge_value(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> dict:
        """The /v1/agent/metrics JSON shape (go-metrics DisplayMetrics)."""
        with self._lock:
            return {
                "Timestamp": time.strftime("%Y-%m-%d %H:%M:%S +0000 UTC",
                                           time.gmtime()),
                "Gauges": [{"Name": k, "Value": v}
                           for k, v in sorted(self._gauges.items())],
                "Counters": [agg.view(k) for k, agg in
                             sorted(self._counters.items())],
                "Samples": [agg.view(k) for k, agg in
                            sorted(self._samples.items())],
            }


def to_prometheus(snapshot: dict) -> str:
    """Render a DisplayMetrics snapshot in the Prometheus text exposition
    format; dotted names sanitize to underscores, and a name that
    sanitizes to one already declared is skipped (keep first)."""
    def norm(name: str) -> str:
        return "".join(ch if ch.isalnum() or ch == "_" else "_"
                       for ch in name)

    seen: set[str] = set()
    lines: list[str] = []
    for g in snapshot.get("Gauges", []):
        n = norm(g["Name"])
        if n in seen:
            continue
        seen.add(n)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {float(g['Value'])}")
    for c in snapshot.get("Counters", []):
        n = norm(c["Name"])
        if n in seen:
            continue
        seen.add(n)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {float(c.get('Sum', c.get('Count', 0)))}")
    for s in snapshot.get("Samples", []):
        n = norm(s["Name"])
        if n in seen:
            continue
        seen.add(n)
        lines.append(f"# TYPE {n} summary")
        if "P50" in s:
            lines.append(f'{n}{{quantile="0.5"}} {float(s["P50"])}')
        if "P99" in s:
            lines.append(f'{n}{{quantile="0.99"}} {float(s["P99"])}')
        lines.append(f"{n}_count {float(s.get('Count', 0))}")
        lines.append(f"{n}_sum {float(s.get('Sum', 0.0))}")
    return "\n".join(lines) + "\n"


def emit_counter_deltas(sink: Sink, deltas: dict):
    """Fold one chunk's counter deltas (ints by field name) into the sink
    under counters.METRIC_NAMES; zero deltas leave no row behind."""
    for field, delta in deltas.items():
        if delta:
            sink.incr_counter(METRIC_NAMES[field], delta)


def _live_view(state):
    """(live mask, awareness, |adjustment| f32, resets) of a packed or a
    dense SWIM plane; live = alive and not left."""
    v = state.viv
    if hasattr(state, "flags"):
        flags = state.flags
        live = ((flags & 1) != 0) & ((flags & 2) == 0)
    else:
        live = state.alive_truth & ~state.left
    return (live, state.awareness.to(torch.int64),
            v.adjustment.to(torch.float32).abs(), v.resets.to(torch.int64))


def emit_sim_metrics(state, sink: Sink,
                     health=None, rmse_s=None,
                     rounds_per_sec: Optional[float] = None,
                     chunk_wall_s: Optional[float] = None,
                     chunk_ticks: Optional[int] = None,
                     serf_state=None,
                     queue_depth_warning: int = 0,
                     counters: Optional[dict] = None):
    """Record one chunk boundary's reference-named metrics from ``state``,
    the SWIM plane (packed or dense). ``health`` (a HealthMetrics or a
    TickTrace row) and ``rmse_s`` may be tensors on the device: they ride
    in the same batched fetch as the reductions. ``counters`` is the
    chunk's counter delta dict (host ints)."""
    live, aw, adj, resets = _live_view(state)
    live_f = live.to(torch.float32)
    zero = torch.zeros_like(aw)
    parts = [
        torch.sum(torch.where(live, aw, zero)).to(torch.float32),
        torch.max(torch.where(live, aw, zero)).to(torch.float32),
        torch.sum(live_f),
        torch.sum(adj * live_f) * 1000.0,
        torch.sum(resets).to(torch.float32),
    ]
    if serf_state is not None:
        # uint32 has no comparison on the card: test the bits as int32.
        held = serf_state.ev_key.view(torch.int32) != 0
        occ = torch.sum(held & live[:, None], dim=1)
        parts += [torch.sum(occ).to(torch.float32),
                  torch.max(occ).to(torch.float32)]
    extra = []
    if health is not None:
        extra += [health.agreement, health.false_positive, health.undetected]
    if rmse_s is not None:
        extra.append(rmse_s)
    dev = parts[0].device
    scalars = torch.stack(parts + [torch.as_tensor(x, dtype=torch.float32,
                                                   device=dev)
                                   for x in extra]).tolist()
    n_live = scalars[2]
    denom = max(n_live, 1.0)  # divide-by-zero clamp only
    sink.set_gauge("memberlist.health.score", scalars[0] / denom)
    sink.set_gauge("memberlist.health.score.max", scalars[1])
    sink.set_gauge("serf.members.alive", n_live)
    sink.add_sample("serf.coordinate.adjustment-ms", scalars[3] / denom)
    sink.set_gauge("serf.coordinate.resets", scalars[4])
    if chunk_wall_s is not None and chunk_ticks:
        sink.add_sample("memberlist.gossip",
                        chunk_wall_s * 1000.0 / chunk_ticks)
    if rounds_per_sec is not None:
        sink.set_gauge("sim.gossip_rounds_per_sec", rounds_per_sec)
    rest = scalars[len(parts):]
    if health is not None:
        sink.set_gauge("sim.agreement", rest[0])
        sink.set_gauge("sim.false_positive", rest[1])
        sink.set_gauge("sim.undetected", rest[2])
        rest = rest[3:]
    if rmse_s is not None:
        sink.set_gauge("sim.vivaldi_rmse_ms", rest[0] * 1000.0)
    if counters is not None:
        emit_counter_deltas(sink, counters)
    if serf_state is not None:
        q_sum, q_max = scalars[5], scalars[6]
        sink.add_sample("serf.queue.Event", q_sum / denom)
        sink.set_gauge("serf.queue.Event.max", q_max)
        warn_at = min(queue_depth_warning, serf_state.ev_key.shape[1]) \
            if queue_depth_warning else 0
        if warn_at and q_max >= warn_at:
            logging.getLogger(LOGGER_NAME + ".serf").warning(
                "serf: Event queue depth: %d", int(q_max))
